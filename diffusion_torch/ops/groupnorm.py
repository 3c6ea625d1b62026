"""GroupNorm(+SiLU) with fp32 statistics: the Hopper kernel and its plain
PyTorch version.

Counterpart of `diffusion_tpu/ops/groupnorm.py` (forward only). The public
op keeps the JAX layout: `x` is channels-last `(..., C)`, the first axis is
the batch, and statistics run per (image, group) over every other axis.
The port's modules hold NCHW tensors in `torch.channels_last`, whose memory
is NHWC, so `x.permute(0, 2, 3, 1)` hands this op a contiguous slab for free.

On a CUDA tensor `group_norm` launches the kernel
(`diffusion_torch/csrc/group_norm.cu`) or raises; on a CPU tensor it runs
`group_norm_reference`, the two-pass plain version that mirrors JAX's
`_xla_group_norm`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from diffusion_torch.ops._build import LaunchCounter, library

__all__ = ["group_norm", "group_norm_reference", "group_norm_cuda",
           "launches"]

launches = LaunchCounter()


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


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, epsilon: float = 1e-5,
               act: Optional[str] = None) -> torch.Tensor:
    """GroupNorm with fp32 statistics over channels-last `x` (..., C),
    optionally fused with SiLU; `scale`/`bias` are fp32 (C,). Raises when
    C is not a multiple of `num_groups`."""
    if x.is_cuda:
        return group_norm_cuda(x, scale, bias, num_groups, epsilon, act)[0]
    if x.device.type != "cpu":
        raise ValueError(f"group_norm runs on CUDA or CPU, not {x.device}")
    return group_norm_reference(x, scale, bias, num_groups, epsilon, act)
