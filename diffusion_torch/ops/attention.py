"""Attention dispatch: plain attention, the flash kernel, or under sequence
parallelism the ring; and the tensor-parallel context.

Counterpart of `diffusion_tpu/ops/attention.py`. Every entry point takes
(B, S, H, D) q/k/v. The eligibility rule is the JAX one, with "the
backend is a TPU" read as "the tensor lies on a CUDA device", plus what
the CUDA kernels take: bf16 q/k/v with head dim 64 or 128. The JAX rule's
128-multiple lengths are dropped: the CUDA kernels mask a ragged last
tile, so MMDiT's joint attention over 4,096 + 154 tokens runs the kernel,
as FLUX's over 512 + 4,096 tokens at head dim 128 does.
At 512px the bf16 UNet's S=4096 and S=1024 self-attention run the kernel;
cross-attention (77 keys), the S=256 and S=64 stages, CLIP's masked
attention, and every fp32 or fp16 call stay on plain torch
math (a matmul, a softmax and a matmul), which computes the same function
(the JAX kernel runs in any dtype). `flash_calls` and `plain_calls` count
the calls that took each path (a CUDA graph's replay adds those it
captured, as it adds the kernels' launches).

`sequence_parallel(mesh, min_seq=)` (the Trainer enters it when the mesh's
sp axis is > 1) makes `active_shard()` the rank's `RowShard`; the UNet then
splits the rows of its body over the sp group and hands self-attention its
token shard. Such a call with at least `min_seq` tokens in all runs as
ring attention over the group (`ops/ring_attention.py`); a shorter one
gathers K and V from the group (`parallel/sharding.py::gather_rows`) and
attends locally. Cross-attention (77 keys) never takes the ring.

`tensor_parallel(mesh)` (the Trainer enters it when the mesh's tp axis is
> 1) makes `active_tp()` the rank's place in its tp group. The attention
and GEGLU layers that `parallel/sharding.py::shard_tensor_parallel` sliced
then run on their own heads and hidden features, and sum their
row-parallel products over the group (JAX's `_tp_dispatch` and its
allreduce): a sharded attention layer hands `multi_head_attention` its
local heads, so the flash kernel runs per head shard. Under both contexts
each tp rank runs the ring over its sp group on its own heads (JAX's
`_ring_dispatch` with heads over tp): the sp group of a tp coordinate is
the mesh's sp group.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch

from diffusion_torch.ops._build import LaunchCounter
from diffusion_torch.ops.flash_attention import HEAD_DIMS, flash_attention
from diffusion_torch.utils.device import kernel_device_type

__all__ = ["multi_head_attention", "flash_eligible", "sequence_parallel",
           "active_shard", "tensor_parallel", "active_tp", "flash_calls",
           "plain_calls"]

# multi_head_attention's calls by path (the ring's are in neither)
flash_calls = LaunchCounter()
plain_calls = LaunchCounter()

# (RowShard, min_seq) while a sequence_parallel context is active
_SEQ_PARALLEL: list = [None]


@contextlib.contextmanager
def sequence_parallel(mesh, axis_name: str = "sp", min_seq: int = 512):
    """Split the UNet body's rows over the mesh's `axis_name` while active;
    self-attention over >= `min_seq` tokens then runs as a ring. A no-op
    where the mesh is None or its axis has one rank."""
    from diffusion_torch.parallel.sharding import row_shard
    shard = row_shard(mesh, axis_name)
    prev = _SEQ_PARALLEL[0]
    _SEQ_PARALLEL[0] = None if shard is None else (shard, int(min_seq))
    try:
        yield shard
    finally:
        _SEQ_PARALLEL[0] = prev


def active_shard():
    """The active sequence_parallel context's RowShard, or None."""
    ctx = _SEQ_PARALLEL[0]
    return None if ctx is None else ctx[0]


# the tp group's RowShard while a tensor_parallel context is active
_TENSOR_PARALLEL: list = [None]


@contextlib.contextmanager
def tensor_parallel(mesh):
    """Run the tp-sliced layers over the mesh's tp group while active. A
    no-op where the mesh is None or its tp axis has one rank."""
    from diffusion_torch.parallel.sharding import row_shard
    shard = row_shard(mesh, "tp")
    prev = _TENSOR_PARALLEL[0]
    _TENSOR_PARALLEL[0] = shard
    try:
        yield shard
    finally:
        _TENSOR_PARALLEL[0] = prev


def active_tp():
    """The active tensor_parallel context's RowShard (the rank's place in
    its tp group), or None."""
    return _TENSOR_PARALLEL[0]


def _xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain (B, S, H, D) attention, the counterpart of JAX's
    `_xla_attention`: fp32 scores, probabilities in q's dtype. `mask`
    broadcasts against (B, H, Sq, Sk); False drops the key."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _shape_eligible(q_shape: Sequence[int], k_shape: Sequence[int]) -> bool:
    # the JAX rule (attention.py `_flash_eligible`): long queries, at least
    # 256 keys, 64-multiple heads; any lengths, where JAX asks for
    # 128-multiples (the kernels mask a ragged tail)
    return (q_shape[1] >= 1024 and k_shape[1] >= 256
            and q_shape[-1] % 64 == 0)


def flash_eligible(device_type: str, dtype: torch.dtype,
                   q_shape: Sequence[int], k_shape: Sequence[int],
                   masked: bool) -> bool:
    """Whether (B, S, H, D) attention goes to the flash kernel: unmasked,
    on a CUDA device, in bf16 with head dim 64 or 128 (the kernels'
    instances), at a shape the JAX rule sends to its kernel."""
    return (not masked and device_type == "cuda" and dtype == torch.bfloat16
            and q_shape[-1] in HEAD_DIMS and _shape_eligible(q_shape, k_shape))


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: Optional[torch.Tensor] = None,
                         shard=None) -> torch.Tensor:
    """Scaled dot-product attention over (B, S, H, D) tensors. With
    `shard` (self-attention whose tokens the sp group splits), q/k/v are
    this rank's token shards and so is the output."""
    if shard is not None and mask is None:
        ctx = _SEQ_PARALLEL[0]
        min_seq = ctx[1] if ctx is not None else 512
        if q.shape[1] * shard.size >= min_seq:
            from diffusion_torch.ops.ring_attention import ring_attention
            return ring_attention(q, k, v, shard)
        from diffusion_torch.parallel.sharding import gather_rows
        k, v = gather_rows(k, shard, dim=1), gather_rows(v, shard, dim=1)
    if mask is None and flash_eligible(kernel_device_type(q.device), q.dtype,
                                       q.shape, k.shape, False):
        flash_calls.add()
        return flash_attention(q, k, v)[0]
    plain_calls.add()
    return _xla_attention(q, k, v, mask)
