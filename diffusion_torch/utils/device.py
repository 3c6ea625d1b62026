"""The port's device default: its entry points run on the card unless the
caller asks for the CPU. And this process's rank and world size, over the
processes that hold different examples."""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.distributed as dist

__all__ = ["Device", "resolve_device", "rank_and_world",
           "set_example_layout"]

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
