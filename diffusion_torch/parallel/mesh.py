"""The process mesh: (dcn, fsdp, data, sp, tp) axes over the ranks.

Counterpart of `diffusion_tpu/parallel/mesh.py`. The JAX mesh spans devices
and XLA inserts the collectives; here one process drives one card, so the
mesh is a `torch.distributed.device_mesh.DeviceMesh` over the ranks of the
default process group, in row-major order with `dcn` outermost (a host's
ranks, consecutive under torchrun, share a `dcn` index). The axes' roles are
JAX's:

- dcn, fsdp, data: the global batch splits over them; the UNet's
  parameters shard over `fsdp` (FSDP2, `parallel/sharding.py`) and
  replicate over the others but `tp`;
- sp: sequence parallelism. The ranks of an sp group hold the same
  examples and split the UNet body's rows; long self-attention runs as a
  ring over them (`ops/ring_attention.py`);
- tp: Megatron tensor parallelism, the innermost axis. The ranks of a tp
  group hold the same examples and split the attention heads and the
  GEGLU's hidden features (`parallel/sharding.py::shard_tensor_parallel`,
  `ops/attention.py::tensor_parallel`); convolutions and norms run whole
  on each of them.

One axis may be -1, inferred from the world size, with JAX's errors.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from diffusion_torch.utils.device import set_example_layout

__all__ = ["MESH_AXES", "mesh_sizes", "create_mesh", "example_layout"]

MESH_AXES = ("dcn", "fsdp", "data", "sp", "tp")
BATCH_AXES = ("dcn", "fsdp", "data")


def mesh_sizes(n: int, fsdp: int = -1, data: int = 1, dcn: int = 1,
               sp: int = 1, tp: int = 1) -> Dict[str, int]:
    """The axes' sizes for `n` ranks, the one -1 inferred; JAX's
    ValueErrors where they do not cover `n`."""
    sizes = {"dcn": dcn, "fsdp": fsdp, "data": data, "sp": sp, "tp": tp}
    unknown = [k for k, v in sizes.items() if v == -1]
    if len(unknown) > 1:
        raise ValueError("at most one mesh axis may be -1")
    if unknown:
        known = math.prod(v for v in sizes.values() if v != -1)
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[unknown[0]] = n // known
    if math.prod(sizes.values()) != n:
        raise ValueError(f"mesh {sizes} does not cover {n} devices")
    return sizes


def example_layout(mesh) -> tuple:
    """(rank, world) of this rank over the mesh's batch axes: the ranks that
    hold different examples (an sp or tp group shares its examples)."""
    coord = dict(zip(MESH_AXES, mesh.get_coordinate()))
    rank, world = 0, 1
    for axis in BATCH_AXES:
        size = mesh.size(MESH_AXES.index(axis))
        rank, world = rank * size + coord[axis], world * size
    return rank, world


def create_mesh(fsdp: int = -1, data: int = 1, dcn: int = 1, sp: int = 1,
                tp: int = 1, device_type: Optional[str] = None):
    """A (dcn, fsdp, data, sp, tp) `DeviceMesh` over the default process
    group's ranks (which must be initialised: `parallel/dist.py`). It also
    makes `utils/device.py::rank_and_world` the rank's position over the
    batch axes, so the data readers split examples over them alone."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs torch.distributed initialised "
                           "(diffusion_torch.parallel.dist.initialize)")
    sizes = mesh_sizes(dist.get_world_size(), fsdp=fsdp, data=data, dcn=dcn,
                       sp=sp, tp=tp)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(dist.get_world_size()).reshape(
        tuple(sizes[a] for a in MESH_AXES))
    mesh = DeviceMesh(device_type, ranks, mesh_dim_names=MESH_AXES)
    set_example_layout(*example_layout(mesh))
    return mesh
