"""MMDiT training cells: `Trainer.fit()` of the program's SD3 model over
latents, text states and pooled text drawn from the seed, a closed loop of
steps, as `kinds/train.py` runs the UNet's (its window, check and
numbers, imported).

Beside that kind's window counts, the run records how far the program's
attention-path counters (`ops.attention.flash_calls`, `plain_calls`) grew
over the window, and the flash kernels' tail counters and launches over
the traced steps, where the program has them. The reference follows the
first `checked_steps` steps from the same weights, batches and draws after
the program's state is freed, `reference_rows` samples at a time, its
attention in blocks of `reference_attn_rows` queries and each block
recomputed in the backward.

    python3 portbench/kinds/train_mmdit.py --workload sd3-1024-train \\
        --seeds 1 2 3 [--fault fp8|half_batch]

runs the control (the reference in fp8, or the planted half-batch fault,
put in the program's place) on the card and prints the numbers the check
compares.
"""

from __future__ import annotations

import gc
import importlib
import json
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from portbench.common import Check, Run  # noqa: E402
from portbench.kinds.train import (_quarters, _recipe_trainer,  # noqa: E402
                                   _Window, compare, numbers)
from portbench.reference import mmdit as ref  # noqa: E402
from portbench.trace import read_trace  # noqa: E402
from portbench.weights import derive_seed, draw_like  # noqa: E402

__all__ = ["run", "Feed", "draws", "program_model", "reference"]

_LATENTS, _CAPTIONS = "image_latents", "caption_latents"
_POOLED = "pooled_caption_latents"
# the program's counters the run reads, by module and name; a program
# without one reads as without it
_COUNTERS = {"flash_calls": ("diffusion_torch.ops.attention", "flash_calls"),
             "plain_calls": ("diffusion_torch.ops.attention", "plain_calls"),
             "tail_fwd": ("diffusion_torch.ops.flash_attention",
                          "launches_tail"),
             "tail_dq": ("diffusion_torch.ops.flash_attention",
                         "launches_bwd_dq_tail"),
             "tail_dkv": ("diffusion_torch.ops.flash_attention",
                          "launches_bwd_dkv_tail")}


def _counters() -> Dict[str, Any]:
    out = {}
    for name, (module, attr) in _COUNTERS.items():
        counter = getattr(importlib.import_module(module), attr, None)
        if counter is not None:
            out[name] = counter
    return out


class Feed:
    """Batch k of the run: latents (B, side, side, C), text states
    (B, tokens, joint width) and pooled text (B, pooled width), N(0, 1),
    drawn on the device from (seed, k)."""

    def __init__(self, seed: int, traffic: dict, config: dict, device):
        self.seed, self.device, self.k = seed, device, 0
        t, b = config["transformer"], traffic["batch_size"]
        side = traffic["latent_side"]
        self.shapes = ((b, side, side, t["in_channels"]),
                       (b, traffic["caption_tokens"],
                        t["joint_attention_dim"]),
                       (b, t["pooled_projection_dim"]))

    def batch(self, k: int) -> Dict[str, torch.Tensor]:
        gen = torch.Generator(device=self.device).manual_seed(
            derive_seed(self.seed, "data", k))
        return {name: torch.randn(shape, generator=gen, device=self.device)
                for name, shape in zip((_LATENTS, _CAPTIONS, _POOLED),
                                       self.shapes)}

    def __iter__(self):
        while True:
            self.k += 1
            yield self.batch(self.k - 1)


def draws(seed: int, step: int, micro: int, latents: torch.Tensor,
          recipe: dict, scheduler: dict) -> tuple:
    """(noise, t) of microbatch `micro` of step `step`: t = sigmoid(u),
    u ~ N(logit_mean, logit_std^2), shifted by the scheduler's `shift`,
    then the noise."""
    gen = torch.Generator(device=latents.device).manual_seed(
        derive_seed(seed, "noise", step, micro))
    u = torch.randn((latents.shape[0],), generator=gen,
                    device=latents.device)
    s = torch.sigmoid(u * recipe["logit_std"] + recipe["logit_mean"])
    shift = scheduler["shift"]
    t = shift * s / (1.0 + (shift - 1.0) * s)
    return torch.randn(latents.shape, generator=gen,
                       device=latents.device), t


def program_model(config: dict, device):
    """The program's model from the configuration's model function, on
    `device`; it raises where the built transformer is not the file's."""
    module, fn = config["model"].rsplit(".", 1)
    make = getattr(importlib.import_module(module), fn)
    model = make(transformer=config["transformer"],
                 **config.get("model_kwargs", {}), device=device)
    built = {k: getattr(model.unet.config, k)
             for k in ref.mmdit_spec(config["transformer"])}
    want = ref.mmdit_spec(config["transformer"])
    if built != want:
        raise ValueError(f"the model's transformer is not the config's: "
                         f"{built} != {want}")
    return model


def _reference_model(config: dict, device, attn_rows=None,
                     checkpoint_blocks=False):
    with torch.device("meta"):
        model = ref.MMDiT(ref.mmdit_spec(config["transformer"]), attn_rows,
                          checkpoint_blocks)
    return model


def _weights(seed: int, config: dict, device):
    """(flat buffer, {name: view}) of the run's weights, by the
    reference's names."""
    return draw_like(_reference_model(config, device),
                     derive_seed(seed, "transformer"), device)


def _load(module, views: dict) -> None:
    """The run's weights into `module`, whose one other entry is the fixed
    position table (a buffer the weights do not hold)."""
    missing, unexpected = module.load_state_dict(views, strict=False)
    if unexpected or set(missing) != {"pos_embed.pos_embed"}:
        raise ValueError(f"the module's parameters are not the run's: "
                         f"missing {missing}, unexpected {unexpected}")


def reference(files: dict, seed: int, device, block_rows: int,
              control: bool = False, keep: float = 1.0) -> dict:
    """The reference over the checked steps, from the seed alone (in fp8
    with `control`; `keep` < 1 plants the half-batch fault)."""
    config, traffic = files["config"], files["traffic"]
    model = _reference_model(config, device, traffic["reference_attn_rows"],
                             checkpoint_blocks=True)
    model.to_empty(device=device)
    flat, views = _weights(seed, config, device)
    _load(model, views)
    with torch.no_grad():
        spec = model.spec
        model.pos_embed.pos_embed.copy_(ref.sincos_table(
            spec["num_attention_heads"] * spec["attention_head_dim"],
            spec["pos_embed_max_size"],
            spec["sample_size"] // spec["patch_size"])[None])
    del flat, views
    feed = Feed(seed, traffic, config, device)
    n = traffic["checked_steps"]
    batches = [feed.batch(k) for k in range(n)]
    n_micro = traffic["batch_size"] // traffic["microbatch"]
    m = traffic["microbatch"]
    all_draws = [[draws(seed, s, i, b[_LATENTS][i * m:(i + 1) * m],
                        config["train"], config["scheduler"])
                  for i in range(n_micro)] for s, b in enumerate(batches)]
    steps = config["scheduler"]["num_train_timesteps"]
    if control:
        from portbench.reference.lowp import Fp8Products
        with Fp8Products():
            return ref.train_steps(model, batches, all_draws,
                                   config["train"], block_rows, keep, steps)
    return ref.train_steps(model, batches, all_draws, config["train"],
                           block_rows, keep, steps)


class _CountedWindow(_Window):
    """`kinds/train.py`'s window, which also reads the program's counters
    as the window opens and closes and as the traced steps end."""

    def __init__(self, *args, counters: Dict[str, Any], **kwargs):
        super().__init__(*args, **kwargs)
        self.counters = counters
        self.marks: Dict[str, Dict[str, int]] = {}

    def _mark(self, key: str) -> None:
        self.marks[key] = {n: c.value for n, c in self.counters.items()}

    def batch_end(self, state, logger) -> None:
        opened, closed = self.t0 is not None, self.t_end is not None
        tracing = self.range is not None
        super().batch_end(state, logger)
        if not opened and self.t0 is not None:
            self._mark("open")
        if not closed and self.t_end is not None:
            self._mark("close")      # and the traced steps' start
        if tracing and state.timestamp.batch == self.ref[0].max_batches:
            self._mark("traced")

    def grown(self, start: str, end: str) -> Optional[Dict[str, int]]:
        if start not in self.marks or end not in self.marks:
            return None
        return {n: self.marks[end][n] - self.marks[start][n]
                for n in self.marks[end]}


def run(files: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, plant: Optional[Callable] = None) -> dict:
    """One run of an MMDiT training cell. `plant(model, trainer)` may break
    the program underneath (the tests' faults)."""
    config, traffic = files["config"], files["traffic"]
    checked = traffic["checked_steps"]
    model = program_model(config, device)
    flat, views = _weights(seed, config, device)
    _load(model.unet, views)
    feed = Feed(seed, traffic, config, device)

    def hook(step, micro, n_accum, mb):
        return draws(seed, step, micro, mb[_LATENTS], config["train"],
                     config["scheduler"])

    names = [n for n, p in model.unet.named_parameters() if p.requires_grad]
    holder: List[Any] = []
    window = _CountedWindow(holder, names, views, checked, seconds,
                            traffic["trace_steps"] if trace else 0, device,
                            counters=_counters())
    del flat, views
    trainer = _recipe_trainer(model, feed, config, traffic, hook, [window],
                              device)
    holder.append(trainer)
    if plant is not None:
        plant(model, trainer)
    trainer.max_batches = 1 << 40
    trainer.fit()
    if window.t_end is None:
        raise RuntimeError("the fit ended before the window closed")
    setup_s = window.t0 - t_start
    losses = torch.stack(window.losses).double().cpu().numpy()
    in_window = losses[checked:checked + window.window_steps]
    prog = {"names": names, "losses": losses[:checked].tolist(),
            "grad_norms": window.grad_norms,
            "change_norms": window.change_norms}
    samples = window.window_steps * traffic["batch_size"]
    win_s = window.t_end - window.t0
    tr = read_trace(window.prof) if window.prof is not None else None
    _quarters(window.ends, window.t0, traffic["batch_size"])
    counts = {"window": window.grown("open", "close"),
              "traced": window.grown("close", "traced") if tr else None}
    print(f"portbench: counters {json.dumps(counts)}", file=sys.stderr)
    trainer.close()
    del trainer, model, holder, window.ref, feed
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ref_out = reference(files, seed, device, traffic["reference_rows"])
    checks = compare(prog, ref_out, files["check"]["limits"])
    window_counts = {"steps": window.window_steps, "samples": samples,
                     "seconds": win_s, "peak_bytes": window.peak,
                     "traced_steps": traffic["trace_steps"] if tr else 0}
    if counts["window"] is not None:
        window_counts["attention_calls"] = {
            k: counts["window"][k] for k in ("flash_calls", "plain_calls")
            if k in counts["window"]}
    if counts["traced"] is not None:
        window_counts["tail_launches"] = {
            k: counts["traced"][k] for k in ("tail_fwd", "tail_dq",
                                             "tail_dkv")
            if k in counts["traced"]}
    return {
        "end_to_end": {"setup_s": setup_s,
                       "train_samples_per_s": samples / win_s},
        "attempted": int(window.window_steps),
        "failed": int(np.sum(~np.isfinite(in_window))),
        "checks": checks,
        "peak_bytes": window.peak,
        "trace": tr,
        "run": Run(cell=files["cell"], config=config, traffic=traffic,
                   window=window_counts, trace=tr),
    }


def control_numbers(files: dict, seed: int, device, fault: str) -> list:
    """The checks of the control (`fp8`) or of the planted fault
    (`half_batch`), put in the program's place, against the reference."""
    rows = files["traffic"]["reference_rows"]
    want = reference(files, seed, device, rows)
    gc.collect()
    torch.cuda.empty_cache()
    low = reference(files, seed, device, rows, control=fault == "fp8",
                    keep=0.5 if fault == "half_batch" else 1.0)
    limits = files["check"]["limits"]
    return [Check(n, v, limits.get(n, float("inf")))
            for n, v in numbers(low, want).items()]


def main(argv=None) -> int:
    import argparse
    from portbench import common
    ap = argparse.ArgumentParser(description="the control of an MMDiT "
                                 "training cell's check, on the card")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=("fp8", "half_batch"), default="fp8")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    files = common.cell_files(common.benchmark(), args.workload)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        checks = control_numbers(files, seed, device, args.fault)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          args.fault: {c.name: c.value for c in checks},
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
