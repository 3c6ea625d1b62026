"""Process-level distributed utilities: launch, rank, barrier.

Counterpart of `diffusion_tpu/parallel/dist.py`. The JAX package runs one
process per host; the port runs one process per card, launched by
`torchrun --nproc_per_node N -m diffusion_torch.run ...`, as the reference
launched one process per GPU (`sensecore/run_cmd.sh`). `initialize()`
reads torchrun's environment (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
`MASTER_ADDR`, `MASTER_PORT`) or takes an explicit `init_method`, and
joins the default process group: NCCL on CUDA, gloo on the CPU. This
process's rank and world come from `utils/device.py::rank_and_world`.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["initialize", "launched", "get_world_size", "get_global_rank",
           "get_local_rank", "barrier", "is_coordinator", "device"]


def launched() -> bool:
    """Whether a launcher (torchrun) started this process as one of
    several, or as a rank of its own."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def initialize(backend: Optional[str] = None,
               init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None) -> bool:
    """Join the default process group; a no-op where it is joined already
    or where nothing asks for one (no launcher's environment and no
    `init_method`). `backend` defaults to NCCL where CUDA is present and
    gloo elsewhere; under NCCL the current device becomes
    `cuda:LOCAL_RANK`. Returns whether a process group is up."""
    if dist.is_initialized():
        return True
    if init_method is None and not launched():
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(get_local_rank())
    kwargs = {}
    if init_method is not None:
        kwargs = {"init_method": init_method, "world_size": world_size,
                  "rank": rank}
    dist.init_process_group(backend=backend, **kwargs)
    return True


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def get_global_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def is_coordinator() -> bool:
    return get_global_rank() == 0


def device() -> torch.device:
    """The device this rank computes on: its CUDA card under NCCL, the CPU
    under gloo or without a process group."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    """Block until every rank arrives (the reference's precompute_latents
    barrier); a no-op on one process."""
    if get_world_size() > 1:
        dist.barrier()
