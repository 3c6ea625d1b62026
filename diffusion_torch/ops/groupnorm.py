"""GroupNorm(+SiLU) with fp32 statistics, forward and backward: the Hopper
kernels and their plain PyTorch versions.

Counterpart of `diffusion_tpu/ops/groupnorm.py`. The public op keeps the JAX
layout: `x` is channels-last `(..., C)`, the first axis is
the batch, and statistics run per (image, group) over every other axis.
The port's modules hold NCHW tensors in `torch.channels_last`, whose memory
is NHWC, so `x.permute(0, 2, 3, 1)` hands this op a contiguous slab for free.

`group_norm` is differentiable in x, scale and bias: a
`torch.autograd.Function` whose forward saves x, scale, bias and the
statistics (mean, rstd) and whose backward is the analytic GN(+SiLU) VJP of
JAX's `_bwd_kernel`, with dscale/dbias shaped `(C,)` like the parameters. On
CUDA tensors it launches the kernels (`diffusion_torch/csrc/group_norm.cu`)
or raises; on CPU tensors it runs the plain versions,
`group_norm_reference` (two-pass, mirrors JAX's `_xla_group_norm`) and
`group_norm_bwd_reference` (mirrors `_bwd_kernel`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from diffusion_torch.ops._build import LaunchCounter, library

__all__ = ["group_norm", "group_norm_reference", "group_norm_cuda",
           "group_norm_bwd_reference", "group_norm_bwd_cuda", "launches",
           "launches_bwd", "contiguity_copies"]

launches = LaunchCounter()
launches_bwd = LaunchCounter()
# cotangents that reached the backward kernel non-contiguous and were copied
contiguity_copies = LaunchCounter()


def _check(x: torch.Tensor, num_groups: int, act: Optional[str]) -> None:
    if act not in (None, "silu"):
        raise ValueError(f"unsupported activation: {act!r}")
    if x.ndim < 2:
        raise ValueError(f"group_norm needs (B, ..., C), got {tuple(x.shape)}")
    if x.shape[-1] % num_groups:
        raise ValueError(f"channels {x.shape[-1]} do not split into "
                         f"{num_groups} groups")


def _reference_with_stats(x, scale, bias, num_groups, epsilon, act):
    _check(x, num_groups, act)
    b, c = x.shape[0], x.shape[-1]
    xg = x.float().reshape(b, -1, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    rstd = torch.rsqrt(var + epsilon)
    y = ((xg - mean) * rstd).reshape(x.shape) * scale.float() + bias.float()
    if act == "silu":
        y = y * torch.sigmoid(y)
    return (y.to(x.dtype), mean.reshape(b, num_groups),
            rstd.reshape(b, num_groups))


def group_norm_reference(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, num_groups: int = 32,
                         epsilon: float = 1e-5,
                         act: Optional[str] = None) -> torch.Tensor:
    """Plain PyTorch GroupNorm(+SiLU): fp32 two-pass statistics, output in
    x's dtype."""
    return _reference_with_stats(x, scale, bias, num_groups, epsilon, act)[0]


def group_norm_stats_reference(x: torch.Tensor, num_groups: int = 32,
                               epsilon: float = 1e-5
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, rstd), each (B, G) fp32, as the kernel writes them."""
    c = x.shape[-1]
    ones = torch.ones(c, device=x.device)
    return _reference_with_stats(x, ones, torch.zeros_like(ones), num_groups,
                                 epsilon, None)[1:]


def group_norm_bwd_reference(x: torch.Tensor, scale: torch.Tensor,
                             bias: torch.Tensor, mean: torch.Tensor,
                             rstd: torch.Tensor, g: torch.Tensor,
                             num_groups: int = 32, act: Optional[str] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Plain GN(+SiLU) VJP in fp32 from the saved (mean, rstd), each (B, G):
    returns dx in x's dtype and dscale, dbias (C,) fp32 summed over the
    batch."""
    _check(x, num_groups, act)
    b, c = x.shape[0], x.shape[-1]
    cg = c // num_groups
    xg = x.float().reshape(b, -1, num_groups, cg)
    rstd_g = rstd.reshape(b, 1, num_groups, 1)
    xhat = (xg - mean.reshape(b, 1, num_groups, 1)) * rstd_g
    dz = g.float().reshape(xg.shape)
    sc = scale.float().reshape(num_groups, cg)
    if act == "silu":
        y = xhat * sc + bias.float().reshape(num_groups, cg)
        s = torch.sigmoid(y)
        dz = dz * (s * (1.0 + y * (1.0 - s)))
    dscale = (dz * xhat).sum(dim=(0, 1)).reshape(c)
    dbias = dz.sum(dim=(0, 1)).reshape(c)
    dxhat = dz * sc
    n = xg.shape[1] * cg
    m1 = dxhat.sum(dim=(1, 3), keepdim=True) / n
    m2 = (dxhat * xhat).sum(dim=(1, 3), keepdim=True) / n
    dx = rstd_g * (dxhat - m1 - xhat * m2)
    return dx.reshape(x.shape).to(x.dtype), dscale, dbias


def _rows_per_chunk(b: int, l: int) -> int:
    # at least 32 rows a block, and about 512 blocks over the batch: enough
    # to fill 132 SMs while the partials stay small next to the slab
    return min(l, max(32, -(-b * l // 512)))


def group_norm_cuda(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    num_groups: int = 32, epsilon: float = 1e-5,
                    act: Optional[str] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel: returns (y, mean, rstd); mean/rstd are (B, G)."""
    _check(x, num_groups, act)
    if not x.is_cuda:
        raise ValueError("group_norm_cuda needs a CUDA tensor")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"group_norm kernel takes bf16 or fp32, not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("group_norm kernel needs a contiguous channels-last "
                         "slab (modules keep activations in channels_last)")
    c = x.shape[-1]
    for name, p in (("scale", scale), ("bias", bias)):
        if (p.device != x.device or p.dtype != torch.float32
                or p.shape != (c,) or not p.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous fp32 ({c},) tensor "
                             f"on {x.device}")
    b = x.shape[0]
    l = x.numel() // (b * c)
    if l == 0:
        raise ValueError("group_norm kernel got an empty tensor")
    rows = _rows_per_chunk(b, l)
    n_chunks = -(-l // rows)
    y = torch.empty_like(x)
    mean = torch.empty((b, num_groups), device=x.device, dtype=torch.float32)
    rstd = torch.empty_like(mean)
    partials = torch.empty((b, n_chunks, c, 2), device=x.device,
                           dtype=torch.float32)
    vec = 16 // x.element_size()
    if c % vec or x.data_ptr() % 16:
        vec = 1
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = library().dt_group_norm_fwd(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), partials.data_ptr(), b, l, c,
            num_groups, rows, float(epsilon), int(act == "silu"),
            int(x.dtype == torch.bfloat16), vec, stream)
    if rc != 0:
        raise RuntimeError(f"group_norm kernel launch failed: CUDA error {rc}")
    launches.add()
    return y, mean, rstd


def group_norm_bwd_cuda(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, mean: torch.Tensor,
                        rstd: torch.Tensor, g: torch.Tensor,
                        num_groups: int = 32, act: Optional[str] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels: returns (dx, dscale, dbias); x and g
    are contiguous slabs of one shape and dtype, mean/rstd the forward's
    (B, G)."""
    _check(x, num_groups, act)
    if not x.is_cuda:
        raise ValueError("group_norm_bwd_cuda needs a CUDA tensor")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"group_norm kernel takes bf16 or fp32, not {x.dtype}")
    if g.device != x.device or g.dtype != x.dtype or g.shape != x.shape:
        raise ValueError(f"the cotangent {tuple(g.shape)} {g.dtype} must "
                         f"match x {tuple(x.shape)} {x.dtype}")
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("group_norm backward kernel needs contiguous "
                         "channels-last slabs")
    b, c = x.shape[0], x.shape[-1]
    for name, p in (("scale", scale), ("bias", bias)):
        if (p.device != x.device or p.dtype != torch.float32
                or p.shape != (c,) or not p.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous fp32 ({c},) tensor "
                             f"on {x.device}")
    for name, t in (("mean", mean), ("rstd", rstd)):
        if (t.device != x.device or t.dtype != torch.float32
                or t.shape != (b, num_groups) or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous fp32 "
                             f"({b}, {num_groups}) tensor on {x.device}")
    l = x.numel() // (b * c)
    if l == 0:
        raise ValueError("group_norm kernel got an empty tensor")
    rows = _rows_per_chunk(b, l)
    n_chunks = -(-l // rows)
    dx = torch.empty_like(x)
    dscale = torch.empty(c, device=x.device, dtype=torch.float32)
    dbias = torch.empty_like(dscale)
    partials = torch.empty((b, n_chunks, c, 2), device=x.device,
                           dtype=torch.float32)
    m12 = torch.empty((2, b, num_groups), device=x.device,
                      dtype=torch.float32)
    vec = 16 // x.element_size()
    if c % vec or x.data_ptr() % 16 or g.data_ptr() % 16:
        vec = 1
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = library().dt_group_norm_bwd(
            x.data_ptr(), g.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
            dscale.data_ptr(), dbias.data_ptr(), partials.data_ptr(),
            m12.data_ptr(), b, l, c, num_groups, rows, int(act == "silu"),
            int(x.dtype == torch.bfloat16), vec, stream)
    if rc != 0:
        raise RuntimeError(f"group_norm backward kernel launch failed: "
                           f"CUDA error {rc}")
    launches_bwd.add()
    return dx, dscale, dbias


class _GroupNorm(torch.autograd.Function):
    """The kernels (CUDA) or the plain versions (CPU) as one differentiable
    op."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, epsilon, act):
        if x.is_cuda:
            y, mean, rstd = group_norm_cuda(x, scale, bias, num_groups,
                                            epsilon, act)
        else:
            y, mean, rstd = _reference_with_stats(x, scale, bias, num_groups,
                                                  epsilon, act)
        ctx.save_for_backward(x, scale, bias, mean, rstd)
        ctx.num_groups, ctx.act = num_groups, act
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, mean, rstd = ctx.saved_tensors
        if x.is_cuda:
            if not g.is_contiguous():
                # e.g. a cotangent that arrives in NCHW order for an NHWC
                # slab: one copy, counted, never the plain version
                g = g.contiguous()
                contiguity_copies.add()
            grads = group_norm_bwd_cuda(x, scale, bias, mean, rstd, g,
                                        ctx.num_groups, ctx.act)
        else:
            grads = group_norm_bwd_reference(x, scale, bias, mean, rstd, g,
                                             ctx.num_groups, ctx.act)
        return (*grads, None, None, None)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, epsilon: float = 1e-5,
               act: Optional[str] = None) -> torch.Tensor:
    """GroupNorm with fp32 statistics over channels-last `x` (..., C),
    optionally fused with SiLU; `scale`/`bias` are fp32 (C,).
    Differentiable in x, scale and bias. Raises when C is not a multiple of
    `num_groups`."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"group_norm runs on CUDA or CPU, not {x.device}")
    return _GroupNorm.apply(x, scale, bias, num_groups, epsilon, act)
