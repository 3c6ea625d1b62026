"""The port's device default: its entry points run on the card unless the
caller asks for the CPU. And this process's rank and world size, over the
processes that hold different examples. And the routing of meta tensors
(shapes without data), for a FLOP count (`utils/flops.py`)."""

from __future__ import annotations

import contextlib
from typing import Tuple, Union

import torch
import torch.distributed as dist

__all__ = ["Device", "resolve_device", "rank_and_world",
           "set_example_layout", "route_meta_as", "kernel_device_type"]

Device = Union[str, torch.device, None]

# (rank, world) over a process mesh's batch axes (parallel/mesh.py)
_EXAMPLE_LAYOUT: list = [None]


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


def set_example_layout(rank: int, world: int) -> None:
    """Record this process's position over a process mesh's batch axes
    (`parallel.mesh.create_mesh` does)."""
    _EXAMPLE_LAYOUT[0] = (int(rank), int(world))


def rank_and_world() -> Tuple[int, int]:
    """(rank, world size) of this process among the processes that read
    different examples: torch.distributed's when it is initialised (under
    a process mesh, the position over its batch axes: the ranks of a
    sequence-parallel group read the same examples), else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        layout = _EXAMPLE_LAYOUT[0]
        if layout is not None:
            return layout
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


# the device type whose routes meta tensors take (`route_meta_as`), or None
_META_ROUTE: list = [None]


@contextlib.contextmanager
def route_meta_as(device_type: str = "cuda"):
    """While active, a meta tensor (a shape without data) takes the route a
    tensor of its shape and dtype takes on `device_type`: on "cuda" the
    flash op where the kernels' rule takes the shape, whose fake version
    stands in for the kernels; on "cpu" the plain versions. A FLOP count
    of either path on a host without a card (`utils/flops.py`). Outside
    it, the entry points refuse meta tensors."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"meta tensors take the cuda or cpu routes, not "
                         f"{device_type!r}")
    prev = _META_ROUTE[0]
    _META_ROUTE[0] = device_type
    try:
        yield
    finally:
        _META_ROUTE[0] = prev


def kernel_device_type(device: torch.device) -> str:
    """The device type whose route a tensor on `device` takes: a meta
    tensor's under `route_meta_as`, else the device's own type."""
    if device.type == "meta" and _META_ROUTE[0] is not None:
        return _META_ROUTE[0]
    return device.type
