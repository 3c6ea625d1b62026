"""Flash attention, forward and backward: the Hopper kernels and their plain
PyTorch versions.

Counterpart of `diffusion_tpu/ops/flash_attention.py`. Every function takes
`(B, S, H, D)` q/k/v, as the JAX entry points do. The forward returns
`(out, lse)`: out `(B, Sq, H, D)` in q's dtype and lse `(B, H, Sq)` fp32, the
logsumexp of the scaled scores, as `flash_attention_with_lse` returns them.
The backward takes those and the output's cotangent and returns
`(dq, dk, dv)`, as `flash_attention_bwd_with_lse` does.

`flash_attention` is differentiable in q, k and v: a dispatcher op
(`torch.library.custom_op`, `flash_attention_op`) whose forward saves
`(q, k, v, out, lse)` only (no S x S residual), as JAX's `_flash_fwd_rule`
does; a selective-checkpoint policy can keep its outputs by naming the op.
Its backward is a dispatcher op too (`flash_attention_bwd_op`), so that a
dispatch mode counts both (`utils/flops.py`). On CUDA tensors they
launch the kernels (`csrc/flash_attention.cu` forward,
`csrc/flash_attention_bwd.cu` dQ and dK/dV: bf16, head dim 64 or 128, any
sequence lengths) or raise; on CPU tensors they run
`flash_attention_reference` and `flash_attention_bwd_reference`, which
mirror JAX's `_xla_attention_with_lse` and `_xla_attention_bwd_with_lse`.

A length that is not a multiple of 64 (MMDiT's joint attention: 4,096
image and 154 text tokens) leaves a ragged last tile, which the kernels
mask: keys past Skv score -inf in the forward and take dS = 0 in dQ, and
queries past Sq add nothing to dK and dV. Each launch that masks such a
tail is also counted in its `*_tail` counter, and each launch at head dim
128 (FLUX's joint attention) in its `*_d128` counter; neither has host time
of its own.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import torch

from diffusion_torch.ops._build import LaunchCounter, library
from diffusion_torch.utils.device import kernel_device_type

__all__ = ["flash_attention", "flash_attention_op", "flash_attention_bwd_op",
           "flash_attention_reference",
           "flash_attention_cuda", "flash_attention_bwd_reference",
           "flash_attention_bwd_cuda", "flash_attention_bwd_dq_cuda",
           "flash_attention_bwd_dkv_cuda", "launches", "launches_bwd_dq",
           "launches_bwd_dkv", "launches_tail", "launches_bwd_dq_tail",
           "launches_bwd_dkv_tail", "launches_d128", "launches_bwd_dq_d128",
           "launches_bwd_dkv_d128", "HEAD_DIMS"]

launches = LaunchCounter()
launches_bwd_dq = LaunchCounter()
launches_bwd_dkv = LaunchCounter()
# the launches above that masked a ragged tail (a length not a multiple of
# 64); no host time of their own
launches_tail = LaunchCounter()
launches_bwd_dq_tail = LaunchCounter()
launches_bwd_dkv_tail = LaunchCounter()
# the launches above at head dim 128
launches_d128 = LaunchCounter()
launches_bwd_dq_d128 = LaunchCounter()
launches_bwd_dkv_d128 = LaunchCounter()

HEAD_DIMS = (64, 128)       # the kernels' instances
_TILE = 64


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain attention with the logsumexp: fp32 scores, probabilities cast
    to q's dtype before the product with v."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None]).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v), lse


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, out: torch.Tensor,
                                  lse: torch.Tensor, do: torch.Tensor,
                                  delta: Optional[torch.Tensor] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Plain backward from the saved lse: p = exp(s - lse) recomputed in
    fp32, delta = rowsum(dO * O) (B, H, Sq) in fp32 unless given (ring
    attention computes it once for every KV block), p and ds cast to the
    operands' dtype before their products."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(logits - lse[..., None])                   # (B, H, Sq, Sk)
    if delta is None:
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype), do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype), k) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype), q) * scale
    return dq, dk, dv


def _view_ok(t: torch.Tensor) -> bool:
    """What the kernels read through strides: unit last stride, strides
    that are multiples of 8 elements, 16-byte alignment."""
    return (t.stride(-1) == 1 and not any(s % 8 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def _check_views(ref: torch.Tensor, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if not t.is_cuda or t.device != ref.device:
            raise ValueError(f"{name} must be a CUDA tensor on {ref.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"flash kernel takes bf16, {name} is {t.dtype}")
        if t.ndim != 4 or t.shape[-1] != ref.shape[-1] \
                or t.shape[-1] not in HEAD_DIMS:
            raise ValueError(f"flash kernel takes (B, S, H, 64) or "
                             f"(B, S, H, 128) of q's head dim, {name} is "
                             f"{tuple(t.shape)}")
        if not _view_ok(t):
            raise ValueError(f"{name} needs a unit last stride, strides that "
                             f"are multiples of 8 and 16-byte alignment")


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    _check_views(q, q=q, k=k, v=v)
    b, sq, h, _ = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != h:
        raise ValueError(f"k/v {tuple(k.shape)}, {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if not sq or not k.shape[1]:
        raise ValueError(f"flash kernel needs sequences, got lengths {sq} "
                         f"and {k.shape[1]}")


def _count(q: torch.Tensor, k: torch.Tensor, tail: LaunchCounter,
           d128: LaunchCounter) -> None:
    """Count a launch that masks a ragged last tile, and one at head dim
    128."""
    if q.shape[1] % _TILE or k.shape[1] % _TILE:
        tail.add()
    if q.shape[-1] == 128:
        d128.add()


def _strides(*tensors: torch.Tensor):
    return [s for t in tensors for s in t.stride()[:3]]


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on (B, S, H, 64 or 128) bf16 views with
    unit last stride."""
    t0 = time.perf_counter_ns()
    _check_qkv(q, k, v)
    b, sq, h, d = q.shape
    out = torch.empty((b, sq, h, d), device=q.device, dtype=q.dtype)
    lse = torch.empty((b, h, sq), device=q.device, dtype=torch.float32)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = library().dt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, sq, k.shape[1], d, *_strides(q, k, v),
            d ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: "
                           f"CUDA error {rc}")
    launches.launched(t0)
    _count(q, k, launches_tail, launches_d128)
    return out, lse


def flash_attention_bwd_dq_cuda(q, k, v, out, lse, do,
                                start_ns: Optional[int] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dQ kernel alone on inputs `flash_attention_bwd_cuda` has
    checked: returns (dq, delta), delta = rowsum(dO * O) (B, H, Sq) fp32,
    which the dK/dV kernel reads. Its host time counts from `start_ns`
    (the checking caller's entry), else from here."""
    t0 = time.perf_counter_ns() if start_ns is None else start_ns
    b, sq, h, d = q.shape
    delta = torch.empty_like(lse)
    dq = torch.empty((b, sq, h, d), device=q.device, dtype=q.dtype)
    with torch.cuda.device(q.device):
        rc = library().dt_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            b, h, sq, k.shape[1], d, *_strides(q, k, v, out, do), d ** -0.5,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash attention dQ kernel launch failed: "
                           f"CUDA error {rc}")
    launches_bwd_dq.launched(t0)
    _count(q, k, launches_bwd_dq_tail, launches_bwd_dq_d128)
    return dq, delta


def flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dK/dV kernel alone on checked inputs and the dQ launch's
    delta: returns (dk, dv)."""
    t0 = time.perf_counter_ns()
    b, sq, h, d = q.shape
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(dk)
    with torch.cuda.device(q.device):
        rc = library().dt_flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, sq, k.shape[1], d, *_strides(q, k, v, do), d ** -0.5,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash attention dK/dV kernel launch failed: "
                           f"CUDA error {rc}")
    launches_bwd_dkv.launched(t0)
    _count(q, k, launches_bwd_dkv_tail, launches_bwd_dkv_d128)
    return dk, dv


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Launch the dQ kernel (which also writes delta = rowsum(dO * O)), then
    the dK/dV kernel. q/k/v/out/do: (B, S, H, 64 or 128) bf16 views with
    unit last stride; lse: the forward's contiguous (B, H, Sq) fp32. Returns
    contiguous dq, dk, dv."""
    t0 = time.perf_counter_ns()
    _check_qkv(q, k, v)
    _check_views(q, out=out, do=do)
    b, sq, h, _ = q.shape
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and do {tuple(do.shape)} "
                         f"must match q {tuple(q.shape)}")
    if (lse.device != q.device or lse.dtype != torch.float32
            or lse.shape != (b, h, sq) or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous fp32 ({b}, {h}, {sq}) "
                         f"tensor on {q.device}")
    dq, delta = flash_attention_bwd_dq_cuda(q, k, v, out, lse, do, t0)
    return (dq, *flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta))


@torch.library.custom_op("diffusion_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel (CUDA) or the plain version (CPU) as one dispatcher op,
    so that a selective-checkpoint policy sees it and keeps its outputs
    (`models/unet.py`'s remat), as JAX names `flash_out`/`flash_lse`."""
    fwd = flash_attention_cuda if q.is_cuda else flash_attention_reference
    return fwd(q, k, v)


@_flash_op.register_fake
def _flash_fake(q, k, v):
    b, sq, h, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((b, h, sq), dtype=torch.float32)


@torch.library.custom_op("diffusion_torch::flash_attention_bwd",
                         mutates_args=())
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward as one dispatcher op, so that a dispatch mode (the FLOP
    count of `utils/flops.py`) sees it: the dQ and dK/dV kernels (CUDA) or
    the plain version (CPU)."""
    if q.is_cuda:
        if not _view_ok(do):
            do = do.contiguous()
        return flash_attention_bwd_cuda(q, k, v, out, lse, do)
    return flash_attention_bwd_reference(q, k, v, out, lse, do)


@_flash_bwd_op.register_fake
def _flash_bwd_fake(q, k, v, out, lse, do):
    return (q.new_empty(q.shape), k.new_empty(k.shape),
            v.new_empty(v.shape))


def _flash_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs, *output)


def _flash_backward(ctx, dout, _dlse):
    """lse is an output for callers but carries no gradient."""
    return _flash_bwd_op(*ctx.saved_tensors, dout)


_flash_op.register_autograd(_flash_backward, setup_context=_flash_setup)
flash_attention_op = torch.ops.diffusion_torch.flash_attention.default
flash_attention_bwd_op = torch.ops.diffusion_torch.flash_attention_bwd.default


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax(q k^T / sqrt(d)) v over (B, S, H, D) and its logsumexp;
    differentiable in q, k and v."""
    if kernel_device_type(q.device) not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention runs on CUDA or CPU, not {q.device}")
    return _flash_op(q, k, v)
