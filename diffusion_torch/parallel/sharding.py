"""FSDP of the UNet, the batch split over ranks, and the token-sharded
(sequence-parallel) UNet body.

Counterpart of `diffusion_tpu/parallel/sharding.py`. There a partition spec
per parameter and `constrain_batch` anchors let XLA shard the step; here
each rank runs its part of the step and the communication is explicit:

- FSDP (`shard_unet`): FSDP2's `fully_shard` over a (replicate, shard)
  mesh, `shard` the mesh's `fsdp` axis and `replicate` every other axis
  (HSDP), with `reshard_after_forward=False` for the yamls'
  `SHARD_GRAD_OP` (ZeRO-2: parameters stay gathered from the forward to
  the backward). The frozen VAE and CLIP stay whole on every rank (JAX's
  `shard=False`). FSDP2 averages the gradients over all the mesh's ranks,
  the sp ranks included: each sp rank backpropagates the mean loss of its
  own rows, whose gradients sum over the sp group to sp times the
  example's, so the average over dcn x fsdp x data x sp ranks is the mean
  over the examples (JAX: parameters replicated over `sp`, their
  gradients summed over it).
- The batch (`batch_slice`): every rank of an sp group reads the same
  examples; microbatch i of a step is the concatenation, in batch-rank
  order, of every batch rank's microbatch i (JAX's layout of a microbatch
  sharded over dcn x fsdp x data). An eval batch needs no padding: each
  rank evaluates what its reader yields, and the sums add over ranks.
- The body under sp (`RowShard`): an sp group's ranks split the rows of
  every (B, C, H, W) activation whose H divides into shards of at least 2
  rows (JAX's `constrain_batch` rule, `:86-93`); the deeper stages stay
  whole on every rank. 3x3 convolutions exchange a row with each
  neighbour (`halo_rows`, whose backward returns the halo's gradient),
  GroupNorm merges its statistics over the group
  (`ops/groupnorm.py::group_norm_sp`), short self-attention gathers K and V
  (`gather_rows`, whose backward reduce-scatters), long self-attention runs
  the ring (`ops/ring_attention.py`). The communication runs inside
  dispatcher ops (`torch.library.custom_op`) that name their process group,
  so a selective-checkpoint policy sees one op for each.
- Megatron tensor parallelism over the mesh's `tp` axis
  (`shard_tensor_parallel`, JAX's `_tp_dim` table and head gate): each tp
  rank keeps its slice of the attention and GEGLU pairs' weights, the
  column-parallel ones (q/k/v and their LoRA B, the GEGLU's value and
  gate rows) by output features, the row-parallel ones (`to_out` and its
  LoRA A, the GEGLU's `net.2`) by input features; their biases, the
  norms, the convolutions and `Transformer2D`'s `proj_in`/`proj_out`
  stay whole. An attention layer whose heads do not divide over the tp
  ranks stays whole on each (SD2's 5-head stage at tp = 2). A sharded
  layer reads its input through `tp_copy` (identity; the backward sums the
  cotangent over the tp group) and sums its row-parallel product over the
  group with `tp_reduce` before its bias: one all-reduce a layer forward.
  FSDP then shards each tp rank's parameters over the other axes; it
  never averages over `tp`, whose ranks hold different slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from diffusion_torch.parallel.mesh import MESH_AXES

__all__ = ["RowShard", "row_shard", "halo_rows", "gather_rows", "take_rows",
           "process_group", "register_group", "fsdp_mesh", "shard_unet",
           "batch_slice", "tp_copy", "tp_reduce", "tp_reduce_op",
           "tp_placement", "model_tp_head_dim", "tp_slice", "tp_join",
           "shard_tensor_parallel"]

# process groups by name, for the dispatcher ops (whose arguments are
# tensors, numbers and strings)
_GROUPS: Dict[str, Any] = {}


def register_group(group) -> str:
    """Name a process group for the dispatcher ops; returns the name."""
    name = group.group_name
    _GROUPS[name] = group
    return name


def process_group(name: str):
    return _GROUPS[name]


@dataclasses.dataclass(frozen=True)
class RowShard:
    """This rank's place in its sp (or tp) group: shard `index` of `size`,
    over the process group named `group` (`register_group`)."""

    group: str
    index: int
    size: int

    def holds(self, rows: int) -> bool:
        """Whether an activation of `rows` rows (the whole image's) is
        split over the group: JAX's rule, every shard keeps >= 2 rows."""
        return rows % self.size == 0 and rows // self.size >= 2


def row_shard(mesh, axis: str = "sp") -> Optional[RowShard]:
    """The RowShard of a mesh's `axis`, or None where it has one rank."""
    dim = MESH_AXES.index(axis)
    if mesh is None or mesh.size(dim) == 1:
        return None
    return RowShard(register_group(mesh.get_group(dim)),
                    mesh.get_local_rank(dim), mesh.size(dim))


def _ranks(name: str):
    group = _GROUPS[name]
    return group, dist.get_process_group_ranks(group), dist.get_rank(group)


def _p2p(sends, recvs, group) -> None:
    """Send and receive (tensor, global peer) pairs in one batch."""
    ops = ([dist.P2POp(dist.isend, t.contiguous(), peer, group)
            for t, peer in sends]
           + [dist.P2POp(dist.irecv, t, peer, group) for t, peer in recvs])
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


def _rows_like(x: torch.Tensor, n: int) -> torch.Tensor:
    b, c, _, w = x.shape
    return x.new_zeros((b, c, n, w))


@torch.library.custom_op("diffusion_torch::halo_rows", mutates_args=())
def _halo(x: torch.Tensor, group: str, top: int, bottom: int
          ) -> torch.Tensor:
    grp, ranks, i = _ranks(group)
    n = len(ranks)
    up, down = _rows_like(x, top), _rows_like(x, bottom)
    sends, recvs = [], []
    # rank i takes the last `top` rows of rank i - 1 and the first `bottom`
    # rows of rank i + 1
    if i > 0 and top:
        recvs.append((up, ranks[i - 1]))
    if i > 0 and bottom:
        sends.append((x[:, :, :bottom], ranks[i - 1]))
    if i < n - 1 and bottom:
        recvs.append((down, ranks[i + 1]))
    if i < n - 1 and top:
        sends.append((x[:, :, x.shape[2] - top:], ranks[i + 1]))
    _p2p(sends, recvs, grp)
    return torch.cat([up, x, down], dim=2).contiguous(
        memory_format=torch.channels_last)


def _halo_setup(ctx, inputs, output):
    ctx.group, ctx.top, ctx.bottom = inputs[1:]


def _halo_backward(ctx, g):
    grp, ranks, i = _ranks(ctx.group)
    n, top, bottom = len(ranks), ctx.top, ctx.bottom
    h = g.shape[2] - top - bottom
    dx = g[:, :, top:top + h].contiguous(memory_format=torch.channels_last)
    from_prev, from_next = _rows_like(g, bottom), _rows_like(g, top)
    sends, recvs = [], []
    # each halo's gradient goes back to the rank whose rows it was
    if i > 0 and top:
        sends.append((g[:, :, :top], ranks[i - 1]))
    if i > 0 and bottom:
        recvs.append((from_prev, ranks[i - 1]))
    if i < n - 1 and bottom:
        sends.append((g[:, :, top + h:], ranks[i + 1]))
    if i < n - 1 and top:
        recvs.append((from_next, ranks[i + 1]))
    _p2p(sends, recvs, grp)
    if i > 0 and bottom:
        dx[:, :, :bottom] += from_prev
    if i < n - 1 and top:
        dx[:, :, h - top:] += from_next
    return dx, None, None, None


_halo.register_autograd(_halo_backward, setup_context=_halo_setup)


def halo_rows(x: torch.Tensor, shard: RowShard, top: int = 1,
              bottom: int = 1) -> torch.Tensor:
    """(B, C, h, W) rows of a split activation with `top` rows of the shard
    above and `bottom` of the shard below on either side (zeros beyond the
    image's edges: a 3x3 convolution's zero padding)."""
    return _halo(x, shard.group, top, bottom)


def _gathered(x: torch.Tensor, grp, n: int, dim: int) -> torch.Tensor:
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0], *src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=grp)
    return out.movedim(0, dim)


@torch.library.custom_op("diffusion_torch::gather_rows", mutates_args=())
def _gather(x: torch.Tensor, group: str, dim: int, channels_last: bool
            ) -> torch.Tensor:
    grp, ranks, _ = _ranks(group)
    out = _gathered(x, grp, len(ranks), dim)
    return out.contiguous(memory_format=torch.channels_last
                          if channels_last else torch.contiguous_format)


def _gather_setup(ctx, inputs, output):
    ctx.group, ctx.dim, ctx.channels_last = inputs[1:]


def _gather_backward(ctx, g):
    grp, ranks, _ = _ranks(ctx.group)
    src = g.movedim(ctx.dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // len(ranks), *src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM, group=grp)
    dx = out.movedim(0, ctx.dim).contiguous(
        memory_format=torch.channels_last if ctx.channels_last
        else torch.contiguous_format)
    return dx, None, None, None


_gather.register_autograd(_gather_backward, setup_context=_gather_setup)


def gather_rows(x: torch.Tensor, shard: RowShard, dim: int = 2
                ) -> torch.Tensor:
    """The whole tensor from every shard's part along `dim` (2: the rows of
    a (B, C, H, W) activation, kept channels_last; 1: the tokens of a
    (B, S, H, D) one); the backward sums the cotangents of the group's
    ranks and returns each its own part."""
    return _gather(x, shard.group, dim, x.ndim == 4 and dim == 2)


def take_rows(x: torch.Tensor, shard: RowShard, dim: int = 2
              ) -> torch.Tensor:
    """This shard's part of a whole tensor along `dim` (its gradient stays
    partial on each rank and sums over the group through the parameters'
    reduction)."""
    n = x.shape[dim] // shard.size
    return x.narrow(dim, shard.index * n, n)


def fsdp_mesh(mesh):
    """The (replicate, shard) mesh FSDP2 runs on for this rank's tp
    coordinate: `shard` is the mesh's fsdp axis, `replicate` every other
    axis but tp, flattened. (Every rank builds the (tp, replicate, shard)
    mesh, whose process groups all ranks create together, and keeps its
    tp coordinate's plane.)"""
    from torch.distributed.device_mesh import DeviceMesh
    fsdp, tp = MESH_AXES.index("fsdp"), MESH_AXES.index("tp")
    order = ([tp] + [d for d in range(len(MESH_AXES)) if d not in (fsdp, tp)]
             + [fsdp])
    ranks = mesh.mesh.permute(order).reshape(mesh.size(tp), -1,
                                             mesh.size(fsdp))
    planes = DeviceMesh(mesh.device_type, ranks,
                        mesh_dim_names=("tp", "replicate", "shard"))
    return planes["replicate", "shard"]


def shard_unet(unet: torch.nn.Module, mesh,
               reshard_after_forward: bool = False) -> None:
    """FSDP2 over the UNet in place: each ResnetBlock and Transformer2D a
    unit, the rest in the root's (`SHARD_GRAD_OP`: parameters stay gathered
    from the forward to the backward)."""
    from torch.distributed.fsdp import fully_shard

    from diffusion_torch.models.layers import ResnetBlock, Transformer2D
    for module in unet.modules():
        if isinstance(module, (ResnetBlock, Transformer2D)):
            fully_shard(module, mesh=mesh,
                        reshard_after_forward=reshard_after_forward)
    fully_shard(unet, mesh=mesh, reshard_after_forward=reshard_after_forward)


def batch_slice(n: int, rank: int, world: int) -> slice:
    """The rows of an n-example global (micro)batch that batch rank `rank`
    of `world` holds: a contiguous block, in rank order."""
    if n % world:
        raise ValueError(f"a batch of {n} examples does not split over "
                         f"{world} ranks")
    m = n // world
    return slice(rank * m, (rank + 1) * m)


# ------------------------------------------------- tensor parallelism


@torch.library.custom_op("diffusion_torch::tp_copy", mutates_args=())
def _tp_copy(x: torch.Tensor, group: str) -> torch.Tensor:
    return x.clone()


def _tp_group_setup(ctx, inputs, output):
    ctx.group = inputs[1]


def _summed(x: torch.Tensor, group: str) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=_GROUPS[group])
    return out


def _tp_copy_backward(ctx, g):
    return _summed(g, ctx.group), None


_tp_copy.register_autograd(_tp_copy_backward, setup_context=_tp_group_setup)


@torch.library.custom_op("diffusion_torch::tp_reduce", mutates_args=())
def _tp_reduce(x: torch.Tensor, group: str) -> torch.Tensor:
    return _summed(x, group)


def _tp_reduce_backward(ctx, g):
    return g.clone(), None


_tp_reduce.register_autograd(_tp_reduce_backward,
                             setup_context=_tp_group_setup)

tp_reduce_op = torch.ops.diffusion_torch.tp_reduce.default


def tp_copy(x: torch.Tensor, shard: RowShard) -> torch.Tensor:
    """Megatron's f, at a column-parallel layer's input: x itself (the
    same on every rank of the tp group); the backward sums the ranks'
    cotangents."""
    return _tp_copy(x, shard.group)


def tp_reduce(x: torch.Tensor, shard: RowShard) -> torch.Tensor:
    """Megatron's g, after a row-parallel product: the sum of the tp
    group's partial outputs (an all-reduce); the backward hands the
    cotangent to each rank as it is."""
    return _tp_reduce(x, shard.group)


# The Megatron table (JAX `sharding.py::_tp_dim`) over the parameters of
# the port's layers, by their diffusers names inside the layer: the dim of
# the (out, in) weight that splits over tp. Column-parallel: q/k/v and
# their LoRA B, the GEGLU's fused value+gate projection and its bias;
# row-parallel: to_out and its LoRA A, the GEGLU's output projection.
# Everything else (the row-parallel biases, LoRA A of q/k/v and B of
# to_out, norms, convolutions, Transformer2D's proj_in/proj_out) is whole.
_ATTN_TP = {"to_q.weight": 0, "to_k.weight": 0, "to_v.weight": 0,
            "to_q_lora_b.weight": 0, "to_k_lora_b.weight": 0,
            "to_v_lora_b.weight": 0,
            "to_out.0.weight": 1, "to_out_lora_a.weight": 1}
_FF_TP = {"net.0.proj.weight": 0, "net.0.proj.bias": 0, "net.2.weight": 1}
# diffusers' fused GEGLU projection: `inner` value rows, then `inner` gate
_FUSED = ("net.0.proj.weight", "net.0.proj.bias")


def _fused(name: str) -> bool:
    return name.endswith(_FUSED)


def model_tp_head_dim(model: Any) -> Optional[int]:
    """The uniform attention head width of a model's UNet, for the head
    gate (JAX `model_tp_head_dim`): None without a UNet config, -1 where
    the width varies over the stages (no attention layer shards)."""
    cfg = getattr(getattr(model, "unet", None), "config", None)
    if cfg is None:
        return None
    widths = {c // h for c, h in zip(cfg.block_out_channels,
                                     cfg.attention_head_dim)}
    return widths.pop() if len(widths) == 1 else -1


def tp_placement(module: torch.nn.Module, tp: int,
                 head_dim: Optional[int] = None) -> Dict[str, int]:
    """The parameters of `module`'s attention and GEGLU layers that split
    over `tp` ranks, by name, with the weight dim that splits. A
    width that does not divide by tp stays whole; with `head_dim`, so does
    an attention layer whose head count (width // head_dim) does not
    divide by tp (JAX's `param_spec` head gate; -1 gates every attention
    layer off). The GEGLU has no heads and is never gated."""
    from diffusion_torch.models.layers import Attention, FeedForwardGEGLU
    out: Dict[str, int] = {}
    if tp <= 1:
        return out
    for prefix, m in module.named_modules():
        if isinstance(m, Attention):
            table, gated = _ATTN_TP, True
        elif isinstance(m, FeedForwardGEGLU):
            table, gated = _FF_TP, False
        else:
            continue
        params = dict(m.named_parameters())
        for local, d in table.items():
            p = params.get(local)
            if p is None:
                continue
            width = p.shape[d] // (2 if _fused(local) else 1)
            if width % tp:
                continue
            if gated and head_dim is not None:
                heads = width // head_dim
                if width % head_dim or heads <= 0 or heads % tp:
                    continue
            out[f"{prefix}.{local}" if prefix else local] = d
    return out


def tp_slice(name: str, whole: torch.Tensor, dim: int, index: int,
             size: int) -> torch.Tensor:
    """Rank `index`'s slice of a whole tensor over `size` tp ranks (a view,
    but for the fused GEGLU projection, which gives each rank its value
    rows followed by its gate rows, so that its own `chunk(2)` pairs
    them)."""
    if _fused(name):
        n = whole.shape[0] // 2 // size
        return torch.cat([h.narrow(0, index * n, n)
                          for h in whole.chunk(2, 0)])
    n = whole.shape[dim] // size
    return whole.narrow(dim, index * n, n)


def tp_join(name: str, parts: Sequence[torch.Tensor],
            dim: int) -> torch.Tensor:
    """The whole tensor from the tp ranks' slices, in rank order (the
    inverse of `tp_slice`)."""
    if _fused(name):
        halves = [p.chunk(2, 0) for p in parts]
        return torch.cat([h[0] for h in halves] + [h[1] for h in halves])
    return torch.cat(list(parts), dim)


@torch.no_grad()
def shard_tensor_parallel(module: torch.nn.Module, index: int, size: int,
                          head_dim: Optional[int] = None) -> Dict[str, int]:
    """Keep rank `index`'s slices (of `size` tp ranks) of the parameters
    `tp_placement` names, in place (the same Parameter objects), and mark
    each attention and GEGLU layer that now holds slices with `tp = size`
    (its forward then runs under `ops.attention.tensor_parallel`).
    Returns the placement."""
    from diffusion_torch.models.layers import Attention, FeedForwardGEGLU
    dims = tp_placement(module, size, head_dim)
    params = dict(module.named_parameters())
    for name, d in dims.items():
        p = params[name]
        p.data = tp_slice(name, p.data, d, index, size).clone(
            memory_format=torch.contiguous_format)
    for prefix, m in module.named_modules():
        key = {Attention: "to_q.weight", FeedForwardGEGLU:
               "net.0.proj.weight"}.get(type(m))
        if key is None or (f"{prefix}.{key}" if prefix else key) not in dims:
            continue
        if isinstance(m, Attention) and m.heads % size:
            raise ValueError(f"{prefix}: {m.heads} heads do not split over "
                             f"{size} tp ranks (give the head width)")
        m.tp = size
    return dims
