"""The composed recipe cells: the unedited yaml (`yamls/SD-2-base-256.yaml`)
composed by the port's loader (`config/loader.py`) and built by
`train/train.py::build_trainer`, the path `python -m diffusion_torch.run`
takes, then `Trainer.fit()` over MDS shards of precomputed LAION latents
read by the yaml's own reader (`data/laion.py`, its 8 loader workers and
prefetch factor 2), a closed loop of steps across epochs. Its window,
check and numbers are `kinds/train.py`'s, imported.

The shards hold `samples` seeded LAION-latent samples, the columns
`precompute_latents` writes (`jpg`, `caption`, `latents_256` 4 x 32 x 32
and `caption_latents` 77 x 1,024, both fp16), written once per checkout
under `build/portbench/` through the port's `MDSWriter` from the traffic
file's own `data_seed`. The overrides point the yaml at them and set what
a card's share needs: paths, the batch (32, in the yaml's microbatches of
16), the eval and the loggers off. The harness hands the Trainer its
window callback, the run's weights (drawn from `--seed`) and, through the
`noise_hook`, the noise and timesteps of (seed, step, microbatch).

The reference reads the shards itself (`reference/mds.py`), finds each
row of the program's checked batches by its latents' bytes (the reader's
order is its own) and follows those steps with `reference/train.py`.

    python3 portbench/kinds/train_mds.py --workload sd2-256-train-mds \\
        --seeds 1 2 3 [--fault fp8|half_batch]

runs the control on the card (from shards written by an earlier run of
the cell in this checkout) and prints the numbers the check compares.
"""

from __future__ import annotations

import gc
import hashlib
import io
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

from portbench.common import ROOT, Check, Run  # noqa: E402
from portbench.kinds.train import (_quarters, _Window, compare,  # noqa: E402
                                   draws, numbers)
from portbench.kinds.train_wds import _Recorded  # noqa: E402
from portbench.reference.mds import read_samples  # noqa: E402
from portbench.reference.train import alphas_cumprod, train_steps  # noqa
from portbench.reference.unet import UNet2DCondition, unet_spec  # noqa: E402
from portbench.trace import read_trace  # noqa: E402
from portbench.weights import derive_seed, draw_like  # noqa: E402

__all__ = ["run", "write_shards", "compose", "reference",
           "reference_batches"]

_LATENTS, _CAPTIONS = "image_latents", "caption_latents"


def _shard_dir(traffic: dict, config: dict) -> str:
    keys = ("data_seed", "samples", "latent_side", "caption_tokens")
    spec = dict({k: traffic[k] for k in keys},
                width=config["unet"]["cross_attention_dim"])
    tag = hashlib.sha256(json.dumps(spec, sort_keys=True).encode()
                         ).hexdigest()[:12]
    return os.path.join(ROOT, "build", "portbench", "mds-" + tag)


def write_shards(traffic: dict, config: dict) -> str:
    """The cell's MDS directory, written once per checkout (into a
    temporary directory, then renamed into place)."""
    out = _shard_dir(traffic, config)
    if os.path.isdir(out):
        return out
    from PIL import Image

    from diffusion_torch.data.mds import MDSWriter
    side, tokens = traffic["latent_side"], traffic["caption_tokens"]
    width = config["unet"]["cross_attention_dim"]
    rng = np.random.default_rng(traffic["data_seed"])
    # the image column the recipe's shards carry; a precomputed-latent run
    # never decodes it
    jpg = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(jpg, format="JPEG")
    tmp = f"{out}.{os.getpid()}.tmp"
    columns = {"jpg": "bytes", "caption": "str", "caption_latents": "bytes",
               f"latents_{side * 8}": "bytes"}
    with MDSWriter(tmp, columns) as w:
        for i in range(traffic["samples"]):
            w.write({"jpg": jpg.getvalue(), "caption": f"sample {i}",
                     f"latents_{side * 8}": rng.standard_normal(
                         (4, side, side)).astype(np.float16).tobytes(),
                     "caption_latents": rng.standard_normal(
                         (tokens, width)).astype(np.float16).tobytes()})
    os.replace(tmp, out)
    return out


def overrides(traffic: dict, config: dict) -> List[str]:
    """The dotted overrides of the cell's run: the shards, a card's batch,
    no eval, no loggers."""
    data = write_shards(traffic, config)
    return [f"batch_size={traffic['batch_size']}",
            f"trainer.device_train_microbatch_size={traffic['microbatch']}",
            f"dataset.train_dataset.remote={data}",
            f"dataset.train_dataset.local={data}",
            "~dataset.eval_dataset", "~logger"]


def compose(traffic: dict, config: dict) -> dict:
    """The yaml composed by the port's loader with the cell's overrides."""
    from diffusion_torch.config import load_config
    return load_config(os.path.join(ROOT, "yamls", traffic["yaml"]),
                       overrides(traffic, config))


def _unet_weights(config: dict, seed: int, device):
    with torch.device("meta"):
        names_from = UNet2DCondition(unet_spec(config["unet"]))
    return draw_like(names_from, derive_seed(seed, "unet"), device)


def _check_unet(model, config: dict) -> None:
    built, want = model.unet.config, unet_spec(config["unet"])
    got = {"block_out_channels": list(built.block_out_channels),
           "layers_per_block": built.layers_per_block,
           "attention_head_dim": list(built.attention_head_dim),
           "cross_attention_dim": built.cross_attention_dim,
           "norm_num_groups": built.norm_num_groups,
           "block_has_attention": list(built.block_has_attention),
           "use_linear_projection": built.use_linear_projection}
    diff = {k: (v, want[k]) for k, v in got.items() if v != want[k]}
    if diff:
        raise ValueError(f"the yaml's UNet is not the config's: {diff}")


def reference_batches(traffic: dict, config: dict,
                      recorded: List[Dict[str, np.ndarray]]
                      ) -> List[Dict[str, torch.Tensor]]:
    """The reference's own read of the rows of the program's checked
    batches, each found by its latents' bytes; raises where a row is in
    no shard or its caption latents are not that sample's."""
    side = traffic["latent_side"]
    by_latents = {}
    for s in read_samples(write_shards(traffic, config)):
        by_latents[s[f"latents_{side * 8}"]] = s
    out = []
    for host in recorded:
        lat, cap = [], []
        for row, ctx in zip(np.asarray(host[_LATENTS], np.float16),
                            np.asarray(host[_CAPTIONS], np.float16)):
            s = by_latents.get(row.transpose(2, 0, 1).tobytes())
            if s is None or s["caption_latents"] != ctx.tobytes():
                raise RuntimeError("a row of the program's batch is no "
                                   "sample of the shards")
            lat.append(np.frombuffer(s[f"latents_{side * 8}"], np.float16
                                     ).reshape(4, side, side))
            cap.append(np.frombuffer(s["caption_latents"], np.float16
                                     ).reshape(traffic["caption_tokens"], -1))
        out.append({_LATENTS: torch.from_numpy(
            np.stack(lat).transpose(0, 2, 3, 1).astype(np.float32)),
            _CAPTIONS: torch.from_numpy(np.stack(cap).astype(np.float32))})
    return out


def reference(config: dict, traffic: dict, seed: int, device,
              batches: List[Dict[str, torch.Tensor]], control: bool = False,
              keep: float = 1.0) -> dict:
    """The reference over the checked steps from its own batches and the
    run's draws (in fp8 with `control`; `keep` < 1 plants the half-batch
    fault)."""
    with torch.device("meta"):
        unet = UNet2DCondition(unet_spec(config["unet"]))
    unet.to_empty(device=device)
    flat, views = _unet_weights(config, seed, device)
    unet.load_state_dict(views)
    del flat, views
    batches = [{k: v.to(device) for k, v in b.items()} for b in batches]
    m = traffic["microbatch"]
    steps = config["scheduler"]["num_train_timesteps"]
    all_draws = [[draws(seed, s, i, b[_LATENTS][i * m:(i + 1) * m], steps)
                  for i in range(traffic["batch_size"] // m)]
                 for s, b in enumerate(batches)]
    abar = alphas_cumprod(config["scheduler"])
    if control:
        from portbench.reference.lowp import Fp8Products
        with Fp8Products():
            return train_steps(unet, batches, all_draws, config["train"],
                               abar, traffic["reference_rows"], keep)
    return train_steps(unet, batches, all_draws, config["train"], abar,
                       traffic["reference_rows"], keep)


def run(files: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, plant: Optional[Callable] = None) -> dict:
    """One run of a composed recipe cell."""
    from diffusion_torch.train.train import build_trainer
    config, traffic = files["config"], files["traffic"]
    checked = traffic["checked_steps"]
    steps = config["scheduler"]["num_train_timesteps"]

    def hook(step, micro, n_accum, mb):
        return draws(seed, step, micro, mb[_LATENTS], steps)

    composed = compose(traffic, config)
    composed["trainer"]["noise_hook"] = hook
    trainer = build_trainer(composed)
    model = trainer.model
    _check_unet(model, config)
    flat, views = _unet_weights(config, seed, device)
    model.unet.load_state_dict(views)
    feed = _Recorded(trainer.train_dataloader, checked)
    trainer.train_dataloader = feed
    names = [n for n, p in model.unet.named_parameters() if p.requires_grad]
    window = _Window([trainer], names, views, checked, seconds,
                     traffic["trace_steps"] if trace else 0, device)
    del flat, views
    trainer.engine.callbacks.append(window)
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
    print(f"portbench: {traffic['yaml']} composed, {len(feed.loader)} "
          f"batches an epoch, {trainer.state.timestamp.epoch} epochs "
          f"begun", file=sys.stderr)
    trainer.close()
    del trainer, model, window.ref
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ref = reference(config, traffic, seed, device,
                    reference_batches(traffic, config, feed.batches))
    checks = compare(prog, ref, files["check"]["limits"])
    return {
        "end_to_end": {"setup_s": setup_s,
                       "train_samples_per_s": samples / win_s},
        "attempted": int(window.window_steps),
        "failed": int(np.sum(~np.isfinite(in_window))),
        "checks": checks,
        "peak_bytes": window.peak,
        "trace": tr,
        "run": Run(cell=files["cell"], config=config, traffic=traffic,
                   window={"steps": window.window_steps, "samples": samples,
                           "seconds": win_s, "peak_bytes": window.peak,
                           "traced_steps": traffic["trace_steps"] if tr
                           else 0},
                   trace=tr),
    }


def control_numbers(files: dict, seed: int, device, fault: str) -> list:
    """The control (`fp8`) or the planted fault (`half_batch`) against the
    reference, on the first batches the yaml's reader gives."""
    from diffusion_torch.config import instantiate
    config, traffic = files["config"], files["traffic"]
    composed = compose(traffic, config)
    np.random.seed(int(composed.get("seed", 17)))
    loader = instantiate(composed["dataset"]["train_dataset"],
                         batch_size=traffic["batch_size"], _recursive_=False)
    recorded = []
    for batch in loader:
        recorded.append({k: np.array(v) for k, v in batch.items()})
        if len(recorded) == traffic["checked_steps"]:
            break
    batches = reference_batches(traffic, config, recorded)
    want = reference(config, traffic, seed, device, batches)
    low = reference(config, traffic, seed, device, batches,
                    control=fault == "fp8",
                    keep=0.5 if fault == "half_batch" else 1.0)
    limits = files["check"]["limits"]
    return [Check(n, v, limits.get(n, float("inf")))
            for n, v in numbers(low, want).items()]


def main(argv=None) -> int:
    import argparse
    from portbench import common
    ap = argparse.ArgumentParser(description="the control of a composed "
                                 "recipe cell's check, on the card")
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
