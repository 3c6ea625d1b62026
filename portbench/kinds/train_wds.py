"""Raw-image training cells: `Trainer.fit()` of the program's SD-2 model on
the wds yaml's reader online (`data/wds.py::build_wds_dataloader`): JPEGs
and captions read from tar shards, decoded, resized and tokenized on the
training thread, then the VAE encoder and CLIP encode them inside the step,
which stays eager (`StepGraph.reason` is `raw_batch`). Its window, check
and numbers are `kinds/train.py`'s, imported.

The shards hold `samples` seeded JPEGs of photo-like sizes (smooth colour
fields, 512 px on the short side) with captions of words from
`traffic/words.txt`, written once per checkout under `build/portbench/`
from the traffic file's own `data_seed`; the run's `--seed` draws the
weights, the noise and timesteps, and the reader's order. The accepted
`sd2-base-256` configuration carries the UNet's groups only: the towers'
published groups are SD-2-base's, read from `configs/sd2-base-512.json`
(the same source).

The reference reads the checked steps' samples from the shards itself
(`reference/wds.py`: its own tokenizer, JPEG decode, crop and resize),
finding each row of the program's batches by its token ids, and the check
holds the program's pixels to its decode (`pixels`). The posterior's eps,
the noise and the timesteps come from (seed, step, microbatch) and are
handed to the program through the `noise_hook`. The reference encodes its
batches with the reference VAE encoder and CLIP, then follows the checked
steps with `reference/train.py`.

    python3 portbench/kinds/train_wds.py --workload sd2-256-train-wds \\
        --seeds 1 2 3 [--fault fp8|half_batch]

runs the control on the card (from shards written by an earlier run of
the cell in this checkout) and prints the numbers the check compares.
"""

from __future__ import annotations

import gc
import hashlib
import importlib
import io
import json
import os
import sys
import tarfile
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from portbench.common import HERE, ROOT, Check, Run, load_json  # noqa: E402
from portbench.kinds.train import (_quarters, _recipe_trainer,  # noqa: E402
                                   compare, draws, numbers)
from portbench.kinds.train_mmdit import _CountedWindow  # noqa: E402
from portbench.reference.clip import CLIPTextModel  # noqa: E402
from portbench.reference.train import alphas_cumprod, train_steps  # noqa
from portbench.reference.unet import UNet2DCondition, unet_spec  # noqa: E402
from portbench.reference.vae import AutoencoderKL, vae_spec  # noqa: E402
from portbench.reference.wds import (PIXELS_LIMIT, Shards,  # noqa: E402
                                     pixel_gap)
from portbench.trace import read_trace  # noqa: E402
from portbench.weights import derive_seed, draw_like  # noqa: E402

__all__ = ["run", "write_shards", "towers_config", "reference",
           "reference_batches", "posterior_draws"]

_TOWERS_FROM = "sd2-base-512"
# the program's GroupNorm call counters, read over the traced steps
_COUNTERS = {"forward": "launches", "backward": "launches_bwd"}
_ASPECTS = ((1, 1), (4, 3), (3, 4), (3, 2), (2, 3), (16, 9))


def towers_config(config: dict) -> dict:
    """The configuration with SD-2-base's VAE and text-encoder groups."""
    if "vae" in config and "text_encoder" in config:
        return config
    towers = load_json(os.path.join(HERE, "configs", _TOWERS_FROM + ".json"))
    return dict(config, vae=towers["vae"],
                text_encoder=towers["text_encoder"])


def _shard_dir(traffic: dict) -> str:
    keys = ("data_seed", "samples", "image_side", "shard_samples")
    tag = hashlib.sha256(json.dumps({k: traffic[k] for k in keys},
                                    sort_keys=True).encode()).hexdigest()[:12]
    return os.path.join(ROOT, "build", "portbench", "wds-" + tag)


def _image(rng: np.random.Generator, short: int) -> bytes:
    """A smooth JPEG: a 6x6 grid of colours upsampled bicubically to a
    photo-like size, short side `short`, plus a little grain."""
    from PIL import Image
    a, b = _ASPECTS[rng.integers(len(_ASPECTS))]
    w, h = (short * a // b, short) if a >= b else (short, short * b // a)
    grid = rng.integers(0, 256, (6, 6, 3), dtype=np.uint8)
    img = np.asarray(Image.fromarray(grid).resize((w, h), Image.BICUBIC),
                     dtype=np.int16)
    img = img + rng.integers(-6, 7, img.shape, dtype=np.int16)
    out = io.BytesIO()
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
        out, format="JPEG", quality=90)
    return out.getvalue()


def write_shards(traffic: dict) -> List[str]:
    """The cell's tar shards, written once per checkout (into a temporary
    directory, then renamed into place)."""
    out = _shard_dir(traffic)
    n, per = traffic["samples"], traffic["shard_samples"]
    paths = [os.path.join(out, f"{i:05d}.tar") for i in range(-(-n // per))]
    if os.path.isdir(out):
        return paths
    with open(os.path.join(HERE, "traffic", "words.txt")) as f:
        words = f.read().split()
    tmp = f"{out}.{os.getpid()}.tmp"
    os.makedirs(tmp, exist_ok=True)
    rng = np.random.default_rng(traffic["data_seed"])
    for s, path in enumerate(paths):
        with tarfile.open(os.path.join(tmp, os.path.basename(path)),
                          "w") as tar:
            for i in range(s * per, min(n, (s + 1) * per)):
                caption = " ".join(rng.choice(words, rng.integers(5, 13)))
                for ext, data in (("jpg", _image(rng, traffic["image_side"])),
                                  ("txt", caption.encode())):
                    info = tarfile.TarInfo(f"{i:08d}.{ext}")
                    info.size = len(data)
                    tar.addfile(info, io.BytesIO(data))
    os.replace(tmp, out)
    return paths


class _Recorded:
    """The loader, keeping the first `n` batches it yields (host arrays,
    as the Trainer receives them)."""

    def __init__(self, loader, n: int):
        self.loader, self.n = loader, n
        self.batches: List[Dict[str, np.ndarray]] = []

    def __iter__(self):
        for batch in self.loader:
            if len(self.batches) < self.n:
                self.batches.append({k: np.array(v) for k, v in
                                     batch.items()})
            yield batch


def loader(traffic: dict, seed: int):
    from diffusion_torch.data.wds import build_wds_dataloader
    return build_wds_dataloader(
        urls=write_shards(traffic), batch_size=traffic["batch_size"],
        caption_drop_prob=traffic["caption_drop_prob"],
        resize_size=traffic["resize_size"],
        num_workers=traffic["num_workers"],
        prefetch_factor=traffic["prefetch_factor"], shuffle=True,
        seed=derive_seed(seed, "order") % 2 ** 31, drop_last=True)


def _reference_modules(config: dict):
    with torch.device("meta"):
        return {"unet": UNet2DCondition(unet_spec(config["unet"])),
                "vae": AutoencoderKL(vae_spec(config["vae"])),
                "text_encoder": CLIPTextModel(config["text_encoder"])}


def _weights(config: dict, seed: int, device) -> Dict[str, dict]:
    return {name: draw_like(m, derive_seed(seed, name), device)[1]
            for name, m in _reference_modules(config).items()}


def program_model(config: dict, seed: int, device):
    """The program's model (raw images: towers built) over the run's
    weights: made on the meta device, laid out on `device`, loaded."""
    module, fn = config["model"].rsplit(".", 1)
    make = getattr(importlib.import_module(module), fn)
    kwargs = dict(config.get("model_kwargs", {}), precomputed_latents=False)
    model = make(**kwargs, device="meta")
    weights = _weights(config, seed, device)
    for name, state in weights.items():
        mod = getattr(model, name)
        mod.to_empty(device=device)
        mod.load_state_dict(state)
    return model, weights["unet"]


def posterior_draws(seed: int, step: int, micro: int, shape, device
                    ) -> torch.Tensor:
    """The posterior's eps (B, h, w, 4) of microbatch `micro` of step
    `step`."""
    gen = torch.Generator(device=device).manual_seed(
        derive_seed(seed, "posterior", step, micro))
    return torch.randn(shape, generator=gen, device=device)


def reference_batches(traffic: dict, recorded: List[Dict[str, np.ndarray]]
                      ) -> tuple:
    """The reference's own read of the rows of the program's checked
    batches (found by their token ids), and the largest gap of the
    program's pixels to it."""
    shards = Shards(write_shards(traffic))
    batches, gap = [], 0.0
    for host in recorded:
        images, ids, found = shards.batch(host["captions"],
                                          traffic["resize_size"])
        gap = max(gap, pixel_gap(host["image"], images, found))
        batches.append({"image": images, "captions": ids})
    return batches, gap


def reference(config: dict, traffic: dict, seed: int, device,
              batches: List[Dict[str, np.ndarray]], control: bool = False,
              keep: float = 1.0) -> dict:
    """The reference over the checked steps: its own pixel batches and
    token ids (`reference_batches`) encoded by the reference VAE
    (posterior mean + std x the run's eps, x the scaling factor) and CLIP,
    then the UNet's steps from the same draws (in fp8 with `control`;
    `keep` < 1 plants the half-batch fault)."""
    import contextlib
    mods = _reference_modules(config)
    weights = _weights(config, seed, device)
    for name, m in mods.items():
        m.to_empty(device=device)
        m.load_state_dict(weights[name])
    del weights
    mode = contextlib.nullcontext()
    if control:
        from portbench.reference.lowp import Fp8Products
        mode = Fp8Products()
    m, side = traffic["microbatch"], traffic["latent_side"]
    n_micro = traffic["batch_size"] // m
    scale = config["vae"]["scaling_factor"]
    timesteps = config["scheduler"]["num_train_timesteps"]
    encoded, all_draws = [], []
    with mode:
        for s, host in enumerate(batches):
            images = torch.from_numpy(host["image"]).to(device).float()
            ids = torch.from_numpy(host["captions"]).to(device).long()
            lat, ctx = [], []
            with torch.no_grad():
                for i in range(n_micro):
                    rows = slice(i * m, (i + 1) * m)
                    e = posterior_draws(seed, s, i, (m, side, side, 4),
                                        device)
                    mean, logvar = mods["vae"].encode_moments(
                        images[rows].permute(0, 3, 1, 2)).chunk(2, dim=1)
                    std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
                    lat.append(((mean + std * e.permute(0, 3, 1, 2)) * scale
                                ).permute(0, 2, 3, 1))
                    ctx.append(mods["text_encoder"](ids[rows]))
            batch = {"image_latents": torch.cat(lat).contiguous(),
                     "caption_latents": torch.cat(ctx)}
            encoded.append(batch)
            all_draws.append([draws(seed, s, i, batch["image_latents"][
                i * m:(i + 1) * m], timesteps) for i in range(n_micro)])
        del mods["vae"], mods["text_encoder"]
        gc.collect()
        return train_steps(mods["unet"], encoded, all_draws, config["train"],
                           alphas_cumprod(config["scheduler"]),
                           traffic["reference_rows"], keep)


def run(files: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, plant: Optional[Callable] = None) -> dict:
    """One run of a raw-image training cell."""
    config = towers_config(files["config"])
    traffic = files["traffic"]
    checked = traffic["checked_steps"]
    model, views = program_model(config, seed, device)
    feed = _Recorded(loader(traffic, seed), checked)
    steps = config["scheduler"]["num_train_timesteps"]
    side = traffic["latent_side"]

    def hook(step, micro, n_accum, mb):
        shape = (mb["image"].shape[0], side, side, 4)
        return (*draws(seed, step, micro, mb["image"].new_empty(shape),
                       steps),
                posterior_draws(seed, step, micro, shape, device))

    names = [n for n, p in model.unet.named_parameters() if p.requires_grad]
    holder: List[Any] = []
    from diffusion_torch.ops import groupnorm
    window = _CountedWindow(holder, names, views, checked, seconds,
                            traffic["trace_steps"] if trace else 0, device,
                            counters={k: getattr(groupnorm, v) for k, v in
                                      _COUNTERS.items()})
    del views
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
    gn_calls = window.grown("close", "traced") if tr else None
    trainer.close()
    del trainer, model, holder, window.ref
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    limits = files["check"]["limits"]
    batches, gap = reference_batches(traffic, feed.batches)
    ref = reference(config, traffic, seed, device, batches)
    checks = compare(prog, ref, limits) + [Check("pixels", gap,
                                                 PIXELS_LIMIT)]
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
                           else 0, "group_norm_calls": gn_calls},
                   trace=tr),
    }


def control_numbers(files: dict, seed: int, device, fault: str) -> list:
    """The control (`fp8`) or the planted fault (`half_batch`) against the
    reference, on the rows the program's reader gives the run's seed, as
    the reference reads them."""
    config, traffic = towers_config(files["config"]), files["traffic"]
    checked = traffic["checked_steps"]
    recorded = []
    for batch in loader(traffic, seed):
        recorded.append({k: np.array(v) for k, v in batch.items()})
        if len(recorded) == checked:
            break
    batches, _ = reference_batches(traffic, recorded)
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
    ap = argparse.ArgumentParser(description="the control of a raw-image "
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
