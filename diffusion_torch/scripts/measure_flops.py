"""Count a training step's FLOPs per batch for SpeedMonitor's MFU.

Counterpart of `tools/measure_flops.py`. It prints `flops_per_batch` of
one loss-and-grad microbatch of the port's model at the given geometry,
split into matrix products, convolutions and the flash kernels
(`utils/flops.py`), to paste into the yaml:

    callbacks:
      speed_monitor:
        _target_: diffusion_tpu.callbacks.monitors.SpeedMonitor
        flops_per_batch: <printed value>

    python -m diffusion_torch.scripts.measure_flops --batch 16 --size 256 \\
        [--builder diffusion_torch.models.models.stable_diffusion_tiny] \\
        [--device cpu|meta]

Unlike JAX's tool, which prices a lowered program without running it, this
one executes the microbatch (the count is a dispatch mode around a real
step), on the card by default, so the flash class is the kernels the card
runs. `--device cpu` prices the CPU's plain attention instead.
`--device meta` executes nothing: the model holds shapes only and takes the
card's routes (`utils/device.py::route_meta_as`), the card's count on any
host.
"""

from __future__ import annotations

import argparse

from diffusion_torch.config.loader import _import_target
from diffusion_torch.utils.device import route_meta_as
from diffusion_torch.utils.flops import flops_by_class


def microbatch_flops(model, batch: int, size: int) -> dict:
    """FLOPs by class of one loss-and-grad microbatch of `batch` random
    latents at `size` px on the model's device (a meta model under
    `route_meta_as`)."""
    data = model.example_batch(batch, size)

    def step():
        model.loss_fn(data).backward()

    return flops_by_class(step)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=24)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--builder",
                   default="diffusion_torch.models.models.stable_diffusion_2")
    p.add_argument("--device", default=None,
                   help="cuda (the default), cpu, or meta (shapes only, "
                        "priced as the card runs them)")
    args = p.parse_args(argv)
    model = _import_target(args.builder)(
        precomputed_latents=True, device=args.device, seed=0)
    with route_meta_as("cuda"):      # a no-op but on the meta device
        by_class = microbatch_flops(model, args.batch, args.size)
    flops = sum(by_class.values())
    print(f"flops_per_batch: {flops:.6e}  (batch {args.batch} @ "
          f"{args.size}px -> {flops / args.batch:.4e} per sample; on "
          f"{model.device})")
    print("by class: " + ", ".join(f"{k} {v:.6e}" for k, v in
                                    by_class.items()))
    return by_class


if __name__ == "__main__":
    main()
