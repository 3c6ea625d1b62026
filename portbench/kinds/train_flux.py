"""FLUX training cells: `Trainer.fit()` of the program's FLUX.1 transformer
over latents, T5 states and pooled text drawn from the seed, a closed loop
of steps, as `kinds/train_mmdit.py` runs the MMDiT's (its window, check and
numbers come from `kinds/train.py` and `kinds/train_mmdit.py`, imported).

A step is `batch_size` latents (16 x side x side, packed by the program
into side^2 / 4 tokens of 64), T5 states (`caption_tokens` x 4,096) and
pooled text (768), drawn on the card from (seed, step), in microbatches of
`microbatch`. (noise, t) come from (seed, step, microbatch) through the
`noise_hook`: t logit-normal, shifted by e^mu with mu from the
configuration's dynamic-shift line at the packed image length (1.15 at
4,096 tokens); the guidance is the recipe's for every sample. Beside the
window's counts, the run records how far the program's attention-path
counters and the flash kernels' head-dim-128 launch counters
(`launches_d128`, `launches_bwd_dq_d128`, `launches_bwd_dkv_d128`) grew
over the window and over the traced steps, where the program has them.
The reference (`reference/flux.py`) follows the first `checked_steps`
steps from the same weights, batches and draws after the program's state
is freed, `reference_rows` samples at a time, its attention in blocks of
`reference_attn_rows` queries and each block recomputed in the backward.

    python3 portbench/kinds/train_flux.py --workload flux-dev-1024-train \\
        --seeds 1 2 3 [--fault fp8|half_batch]

runs the control (the reference in fp8, or the planted half-batch fault,
put in the program's place) on the card and prints the numbers the check
compares.
"""

from __future__ import annotations

import gc
import importlib
import json
import math
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
from portbench.kinds import train_mmdit  # noqa: E402
from portbench.kinds.train import (_quarters, _recipe_trainer,  # noqa: E402
                                   compare, numbers)
from portbench.reference import flux as ref  # noqa: E402
from portbench.reference.mmdit import train_steps  # noqa: E402
from portbench.trace import read_trace  # noqa: E402
from portbench.weights import derive_seed, draw_like  # noqa: E402

__all__ = ["run", "Feed", "draws", "program_model", "reference",
           "shift", "D128"]

_LATENTS = "image_latents"
# the flash kernels' head-dim-128 launch counters, by the name the window
# records them under
D128 = {"fwd": "launches_d128", "dq": "launches_bwd_dq_d128",
        "dkv": "launches_bwd_dkv_d128"}
_COUNTERS = dict(
    {k: v for k, v in train_mmdit._COUNTERS.items()
     if k in ("flash_calls", "plain_calls")},
    **{k: ("diffusion_torch.ops.flash_attention", v)
       for k, v in D128.items()})


def _counters() -> Dict[str, Any]:
    out = {}
    for name, (module, attr) in _COUNTERS.items():
        counter = getattr(importlib.import_module(module), attr, None)
        if counter is not None:
            out[name] = counter
    return out


class Feed(train_mmdit.Feed):
    """Batch k of the run: latents (B, side, side, 16), T5 states
    (B, tokens, joint width) and pooled text (B, pooled width), N(0, 1),
    drawn on the device from (seed, k)."""

    def __init__(self, seed: int, traffic: dict, config: dict, device):
        super().__init__(seed, traffic, config, device)
        t, b = config["transformer"], traffic["batch_size"]
        side = traffic["latent_side"]
        self.shapes = ((b, side, side, t["in_channels"] // 4),
                       *self.shapes[1:])


def shift(scheduler: dict, side: int) -> float:
    """e^mu, mu on the scheduler's dynamic-shift line at the packed image
    length of side x side latents."""
    lo, hi = scheduler["base_image_seq_len"], scheduler["max_image_seq_len"]
    m = (scheduler["max_shift"] - scheduler["base_shift"]) / (hi - lo)
    return math.exp((side // 2) ** 2 * m + (scheduler["base_shift"] - m * lo))


def draws(seed: int, step: int, micro: int, latents: torch.Tensor,
          recipe: dict, scheduler: dict) -> tuple:
    """(noise, t) of microbatch `micro` of step `step`: the MMDiT cells'
    draws, shifted by the dynamic shift at the latents' packed length."""
    return train_mmdit.draws(seed, step, micro, latents, recipe,
                             {"shift": shift(scheduler, latents.shape[1])})


def program_model(config: dict, device):
    """The program's model from the configuration's model function, on
    `device`; it raises where the built transformer is not the file's."""
    module, fn = config["model"].rsplit(".", 1)
    make = getattr(importlib.import_module(module), fn)
    model = make(transformer=config["transformer"],
                 **config.get("model_kwargs", {}), device=device)
    want = ref.flux_spec(config["transformer"])
    built = ref.flux_spec(dict(model.unet.config.__dict__))
    if built != want:
        raise ValueError(f"the model's transformer is not the config's: "
                         f"{built} != {want}")
    return model


def _reference_model(config: dict, attn_rows=None, checkpoint_blocks=False):
    with torch.device("meta"):
        return ref.Flux(ref.flux_spec(config["transformer"]), attn_rows,
                        checkpoint_blocks, config["train"]["guidance"])


def _weights(seed: int, config: dict, device):
    """(flat buffer, {name: view}) of the run's weights, by the
    reference's names."""
    return draw_like(_reference_model(config),
                     derive_seed(seed, "transformer"), device)


def reference(files: dict, seed: int, device, block_rows: int,
              control: bool = False, keep: float = 1.0) -> dict:
    """The reference over the checked steps, from the seed alone (in fp8
    with `control`; `keep` < 1 plants the half-batch fault)."""
    config, traffic = files["config"], files["traffic"]
    model = _reference_model(config, traffic["reference_attn_rows"],
                             checkpoint_blocks=True)
    model.to_empty(device=device)
    flat, views = _weights(seed, config, device)
    model.load_state_dict(views)
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
            return train_steps(model, batches, all_draws, config["train"],
                               block_rows, keep, steps)
    return train_steps(model, batches, all_draws, config["train"],
                       block_rows, keep, steps)


def run(files: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, plant: Optional[Callable] = None) -> dict:
    """One run of a FLUX training cell. `plant(model, trainer)` may break
    the program underneath (the tests' faults)."""
    config, traffic = files["config"], files["traffic"]
    checked = traffic["checked_steps"]
    model = program_model(config, device)
    flat, views = _weights(seed, config, device)
    model.unet.load_state_dict(views)
    feed = Feed(seed, traffic, config, device)

    def hook(step, micro, n_accum, mb):
        return draws(seed, step, micro, mb[_LATENTS], config["train"],
                     config["scheduler"])

    names = [n for n, p in model.unet.named_parameters() if p.requires_grad]
    holder: List[Any] = []
    window = train_mmdit._CountedWindow(
        holder, names, views, checked, seconds,
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
    if device.type == "cuda":
        print(f"portbench: memory_reserved "
              f"{torch.cuda.memory_reserved(device)!r} bytes beside the "
              f"step graph's pool", file=sys.stderr)
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
        window_counts["d128_launches"] = {
            k: counts["traced"][k] for k in D128 if k in counts["traced"]}
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
    ap = argparse.ArgumentParser(description="the control of a FLUX "
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
