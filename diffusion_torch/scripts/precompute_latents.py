"""Precompute VAE + CLIP latents into new MDS shards.

Counterpart of `scripts/precompute_latents.py` (the reference prices this
job at 3,784 A100-hours), with its flags plus `--device` (CUDA unless
`--device cpu`), `--seed` and `--allow-random-towers`. It reads an
image-caption MDS, encodes each image at the requested sizes with the
frozen VAE (a posterior sample times `latent_scale`, 0.18215) and each
caption with the frozen CLIP text tower (its last hidden states), and
writes a new MDS with the source's image and caption columns plus
`caption_latents` and `latents_<size>`: fp16 bytes, the latents NCHW, as
`data/laion.py` reads them. A `latents_<size>` column is empty where the
source image's short side is under `size`.

  python -m diffusion_torch.scripts.precompute_latents --remote <mds> \\
      --out <dir> --sizes 256 512 --model-name <diffusers dir> [--device cpu]

Differences from the JAX script:

- The VAE and the text tower are loaded from `--model-name`, a local
  diffusers directory (`models/pretrained.py`: the msgpack trio or the
  `vae/` and `text_encoder/` safetensors). The JAX script encodes with
  seed-0 random towers whatever `--model-name` says. Without weights the
  job refuses; `--allow-random-towers` opts in to random towers, for runs
  that exercise the path, not the values.
- Each batch's posterior noise is drawn on the CPU from a
  `torch.Generator` seeded by (`--seed`, the batch's first index), so it
  is the same on any device (`posterior_eps`). It is not JAX's draw.
- The encode runs at the builder's compute dtype (bf16 for SD-2-base, as
  `encode_latents_in_fp16` maps it), through the GroupNorm kernel on the
  card. Latents that are not finite after the fp16 cast stop the job.

Rank and world come from torch.distributed (`rank_and_world`; one process
is rank 0 of 1). Each rank takes `dataset.partition(0, rank, world)`,
writes under `out/<rank>/` (and, with `--out-remote`, uploads there in the
background, deleting its local shards unless `--keep-local`), and waits at
a barrier after each batch when the world is larger than one. Input shards
cached under `--local` are deleted as soon as this rank has read all of
their samples, unless `--keep-inputs`.
"""

from __future__ import annotations

import argparse
import io
import os
import time
from types import SimpleNamespace
from typing import Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from diffusion_torch.data.mds import MDSWriter
from diffusion_torch.data.streaming import StreamingDataset
from diffusion_torch.data.transforms import LargestCenterSquare, sd_normalize
from diffusion_torch.models import models
from diffusion_torch.models.pretrained import load_component, load_state_into
from diffusion_torch.ops import groupnorm
from diffusion_torch.utils.device import rank_and_world

__all__ = ["encode_batch", "posterior_eps", "load_towers", "main"]

TOWERS = ("vae", "text_encoder")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--remote", required=True, help="source MDS dir/bucket")
    p.add_argument("--local", default=None)
    p.add_argument("--out", required=True, help="local output root")
    p.add_argument("--out-remote", default=None,
                   help="optional remote root (s3://, gs://, or path): output "
                        "shards upload in the background as they complete")
    p.add_argument("--sizes", type=int, nargs="+", default=[256, 512])
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--image-key", default="jpg")
    p.add_argument("--caption-key", default="caption")
    p.add_argument("--model-name", default=None,
                   help="local diffusers dir holding the vae/ and "
                        "text_encoder/ weights (and the tokenizer)")
    p.add_argument("--keep-local", action="store_true",
                   help="with --out-remote: keep local output shards after "
                        "upload (default deletes them: the output dataset "
                        "is larger than the input)")
    p.add_argument("--keep-inputs", action="store_true",
                   help="do not delete consumed input shards from the local "
                        "cache (deletion only ever removes cached copies)")
    p.add_argument("--allow-random-towers", action="store_true",
                   help="encode with random (seed 0) towers when "
                        "--model-name holds no weights: latents from random "
                        "towers are noise")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the posterior noise")
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA, raising without it)")
    return p.parse_args(argv)


def _has_weights(path: Optional[str], name: str) -> bool:
    return bool(path) and (
        os.path.exists(os.path.join(path, f"{name}.msgpack"))
        or os.path.isdir(os.path.join(path, name)))


def load_towers(model, model_name: Optional[str],
                allow_random: bool = False) -> bool:
    """Load the VAE and the text tower of `model` from `model_name` in
    place; True when loaded. Without weights there it raises, unless
    `allow_random` (the towers then keep their random weights)."""
    if all(_has_weights(model_name, name) for name in TOWERS):
        for name in TOWERS:
            load_state_into(name, getattr(model, name),
                            load_component(model_name, name))
        return True
    if allow_random:
        return False
    raise RuntimeError(
        f"No pretrained VAE and text-tower weights under --model-name "
        f"{model_name!r}: it must name a local diffusers directory with "
        f"vae/ and text_encoder/ safetensors (or the vae.msgpack and "
        f"text_encoder.msgpack of tools/port_weights.py). Latents from "
        f"randomly initialized towers are noise; pass --allow-random-towers "
        f"only for runs that exercise the path, not the values.")


def _batch_seed(seed: int, start: int) -> int:
    return int(np.random.SeedSequence([seed, start]).generate_state(1)[0])


def posterior_eps(seed: int, start: int, batch: int, sizes: Iterable[int],
                  channels: int = 4) -> Dict[int, torch.Tensor]:
    """The posterior's standard normal draws of the batch that starts at
    `start`: NHWC (batch, size/8, size/8, channels) fp32 per size, in the
    order of `sizes`, from one CPU generator seeded by (seed, start)."""
    gen = torch.Generator().manual_seed(_batch_seed(seed, start))
    return {s: torch.randn((batch, s // 8, s // 8, channels), generator=gen)
            for s in sizes}


@torch.no_grad()
def encode_batch(model, images_by_size: Dict[int, torch.Tensor],
                 caption_ids: torch.Tensor,
                 eps_by_size: Dict[int, torch.Tensor],
                 dtype: torch.dtype = torch.float16) -> Dict[str, torch.Tensor]:
    """The job's encode. `model` has `vae`, `text_encoder` and
    `latent_scale`; images (B, S, S, 3) in [-1, 1] per size S, token ids
    (B, 77), eps (B, S/8, S/8, C) per size. Returns `latents_<S>`,
    (mean + std * eps) * latent_scale as (B, S/8, S/8, C), and
    `caption_latents`, the text tower's last hidden states (B, 77, D),
    each cast to `dtype` on the towers' device."""
    vae, text = model.vae, model.text_encoder
    device = next(vae.parameters()).device
    out = {}
    for size, images in images_by_size.items():
        posterior = vae.encode(images.to(device).permute(0, 3, 1, 2))
        eps = eps_by_size[size].to(device, torch.float32).permute(0, 3, 1, 2)
        latents = posterior.sample(eps) * model.latent_scale
        out[f"latents_{size}"] = latents.permute(0, 2, 3, 1).to(dtype)
    hidden, _ = text(caption_ids.to(device))
    out["caption_latents"] = hidden.to(dtype)
    return out


def main(argv=None) -> dict:
    args = parse_args(argv)
    from PIL import Image

    model = models.stable_diffusion_2(
        model_name=args.model_name, pretrained=False,
        encode_latents_in_fp16=True, fsdp=False, init_frozen_towers=True,
        device=args.device)
    loaded = load_towers(model, args.model_name, args.allow_random_towers)
    towers = SimpleNamespace(vae=model.vae, text_encoder=model.text_encoder,
                             latent_scale=model.latent_scale)
    channels = model.vae.config.latent_channels
    tokenizer = model.tokenizer
    del model           # the UNet the builder made is not needed

    dataset = StreamingDataset(remote=args.remote, local=args.local,
                               shuffle=False)
    rank, world = rank_and_world()
    ids = dataset.partition(0, rank, world)
    crops = {s: LargestCenterSquare(s) for s in args.sizes}

    # release consumed input shards from the local cache: count this
    # rank's samples per shard, release at zero
    shard_remaining: dict = {}
    for gid in ids:
        f = dataset.flat_shard_of(int(gid))
        shard_remaining[f] = shard_remaining.get(f, 0) + 1

    columns = {args.image_key: "bytes", args.caption_key: "str",
               "caption_latents": "bytes"}
    columns.update({f"latents_{s}": "bytes" for s in args.sizes})
    out_dir = os.path.join(args.out, str(rank))
    out = out_dir if not args.out_remote else \
        (out_dir, f"{args.out_remote.rstrip('/')}/{rank}")

    launches0 = groupnorm.launches.value
    t0 = time.perf_counter()
    with MDSWriter(out, columns,
                   keep_local=args.keep_local or not args.out_remote
                   ) as writer:
        for start in range(0, len(ids), args.batch_size):
            chunk = ids[start:start + args.batch_size]
            raws, captions = [], []
            imgs_by_size = {s: [] for s in args.sizes}
            valid_by_size = {s: [] for s in args.sizes}
            for gid in chunk:
                raw = dataset.get_sample(int(gid))
                raws.append(raw)
                img = Image.open(io.BytesIO(raw[args.image_key])).convert(
                    "RGB")
                captions.append(str(raw.get(args.caption_key, "")))
                for s in args.sizes:
                    # an empty column where the source is under the size
                    ok = min(img.size) >= s
                    valid_by_size[s].append(ok)
                    imgs_by_size[s].append(
                        sd_normalize(crops[s](img)) if ok
                        else np.zeros((s, s, 3), np.float32))
            batch_imgs = {s: torch.from_numpy(np.stack(v))
                          for s, v in imgs_by_size.items()}
            cap_ids = torch.from_numpy(np.asarray(
                tokenizer(captions)["input_ids"]))
            encoded = encode_batch(
                towers, batch_imgs, cap_ids,
                posterior_eps(args.seed, start, len(chunk), args.sizes,
                              channels))
            for name, value in encoded.items():
                if not bool(torch.isfinite(value).all()):
                    raise FloatingPointError(
                        f"{name} of the batch at {start} is not finite in "
                        f"fp16; nothing of it was written")
            encoded = {k: v.cpu().numpy() for k, v in encoded.items()}
            for i, raw in enumerate(raws):
                sample = {args.image_key: raw[args.image_key],
                          args.caption_key: captions[i],
                          "caption_latents":
                              encoded["caption_latents"][i].tobytes()}
                for s in args.sizes:
                    lat = encoded[f"latents_{s}"][i]
                    # NCHW fp16 bytes (the reader transposes to NHWC)
                    sample[f"latents_{s}"] = (
                        lat.transpose(2, 0, 1).tobytes()
                        if valid_by_size[s][i] else b"")
                writer.write(sample)
            if not args.keep_inputs:
                for gid in chunk:
                    f = dataset.flat_shard_of(int(gid))
                    shard_remaining[f] -= 1
                    if shard_remaining[f] == 0:
                        dataset.release_shard(f)
            if world > 1:
                dist.barrier()
    seconds = time.perf_counter() - t0
    summary = {"rank": rank, "world": world, "samples": len(ids),
               "out": out_dir, "seconds": seconds,
               "images_per_s": len(ids) / max(seconds, 1e-9),
               "towers": "loaded" if loaded else "random",
               "group_norm_launches": groupnorm.launches.value - launches0}
    print(f"rank {rank}: wrote {len(ids)} samples to {out_dir} in "
          f"{seconds:.2f} s ({summary['images_per_s']:.2f} images/s, "
          f"{summary['towers']} towers, "
          f"{summary['group_norm_launches']} GroupNorm kernel launches)")
    return summary


if __name__ == "__main__":
    main()
