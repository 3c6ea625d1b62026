"""The port's device default: its entry points run on the card unless the
caller asks for the CPU."""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["Device", "resolve_device"]

Device = Union[str, torch.device, None]


def resolve_device(device: Device) -> torch.device:
    """`None` means CUDA; raise, naming the `device="cpu"` argument, when
    no CUDA device is present. Never falls back to the CPU silently."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present: pass device=\"cpu\" to run on the "
            "CPU (the plain PyTorch versions of the kernels)")
    return torch.device("cuda")
