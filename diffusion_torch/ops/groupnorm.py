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
CUDA tensors it launches the kernels (`diffusion_torch/csrc/group_norm.cu`,
one launch a call where a thread-block cluster holds an image's channel
slice, as `plan` decides from the shape) or raises; on CPU tensors it runs
the plain versions,
`group_norm_reference` (two-pass, mirrors JAX's `_xla_group_norm`) and
`group_norm_bwd_reference` (mirrors `_bwd_kernel`).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import threading
from typing import Optional, Tuple

import torch

from diffusion_torch.ops._build import LaunchCounter, library

__all__ = ["group_norm", "group_norm_reference", "group_norm_cuda",
           "group_norm_bwd_reference", "group_norm_bwd_cuda", "Plan", "plan",
           "launches", "launches_bwd", "contiguity_copies"]

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


# the H100's limits the plan keeps to
SMEM_PER_BLOCK = 232448 - 1024   # dynamic shared memory a block may ask for
MAX_CLUSTER = 8                  # portable thread-block cluster size
MAX_CLUSTER_NONPORTABLE = 16     # with the non-portable cluster attribute
# The one-launch plan's preferences (`plan`), fitted to CUDA-graph times of
# every feasible plan at the UNet's shapes on the H100 (PERF.md):
_SMS = 132
_SMEM_PER_SM = 228 * 1024
_REGS = {False: 64, True: 112}       # registers a thread (bf16, ptxas)
_TILE_MAX = 128 * 1024    # tiles above this leave the SM's copies too long
_FILL = {False: 96, True: 128}       # blocks that keep the card busy
_MIN_SLICE = {False: 160, True: 80}  # bytes a slice row below which long
_NARROW_ROWS = 256                   # tiles waste DRAM sectors
_TILE_SPLIT = 64 * 1024   # row chunks of the two-launch path


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernels cut one call's (B, L, C) slab: channel slices of
    `width` channels (whole groups), each image's slice over `parts` blocks
    of `rows` rows and `threads` threads. One launch (`split` False):
    `parts` is the cluster size and the blocks merge through distributed
    shared memory. Two launches (`split` True): `parts` row chunks, merged
    through partials in device memory. `vec` elements a 16-byte access, or 1
    (scalar loads) where C or a pointer is not 16-byte aligned."""

    width: int
    parts: int
    rows: int
    threads: int
    split: bool
    vec: int
    tiles: int          # tiles a block holds: 1 (x) forward, 2 (x, g) backward
    itemsize: int
    groups_per_slice: int

    @property
    def launches(self) -> int:
        return 2 if self.split else 1

    @property
    def path(self) -> str:
        if self.split:
            return "split"
        return "generic" if self.vec == 1 else "cluster"

    @property
    def smem(self) -> int:
        """Dynamic shared memory a block asks for (group_norm.cu's
        smem_bytes)."""
        tile = -(-self.rows * self.width * self.itemsize // 16) * 16
        return (self.tiles * tile + 16 * self.groups_per_slice
                + 4 * (2 * self.threads * self.vec + 2 * self.threads
                       + 4 * self.width))

    def scratch(self, b: int, c: int, groups: int) -> int:
        """float2 elements of device scratch the kernels need."""
        if self.tiles == 1:
            return b * self.parts * groups if self.split else 0
        return b * (self.parts * (c + groups) + c) if self.split else b * c


def _threads(v: int) -> int:
    """Threads for `v` 16-byte columns: whole row lanes of v threads, about
    256, rounded up to whole warps."""
    lanes = max(1, 256 // v)
    return -(-v * lanes // 32) * 32


def _blocks_per_sm(p: Plan) -> int:
    """Blocks of plan `p` an SM holds by shared memory, threads and
    registers."""
    return max(1, min(_SMEM_PER_SM // (p.smem + 1024), 2048 // p.threads,
                      65536 // (p.threads * _REGS[p.tiles == 2])))


@functools.lru_cache(maxsize=None)
def plan(b: int, l: int, c: int, groups: int, itemsize: int,
         backward: bool = False, aligned: bool = True) -> Plan:
    """The kernels' plan for a (b, l, c) slab of `itemsize`-byte elements.

    One launch where a cluster of <= 8 blocks (else <= 16, non-portable)
    holds a slice of >= 64 bytes (or of all C). Of those plans the first by
    (tiles <= `_TILE_MAX`; the fewest waves; blocks up to `_FILL`; no long
    tiles of narrow slices; two blocks an SM in the backward, whose SFU
    work then overlaps the other block's copies; the smallest cluster,
    since each block pays its own statistics and barriers; the fewest
    blocks; the wider slice).
    Otherwise two launches over 64 KB row chunks of the narrowest slice of
    >= 128 bytes."""
    cg = c // groups
    tiles = 2 if backward else 1
    vec = 16 // itemsize if aligned and (c * itemsize) % 16 == 0 else 1
    unit = math.lcm(cg * itemsize, 16) // itemsize if vec > 1 else cg
    widths = [w for w in range(unit, c + 1, unit)
              if c % w == 0 and w // vec <= 512]
    if not widths:
        raise ValueError(f"group_norm kernel cannot slice C={c} into groups "
                         f"of {cg}")

    def make(w, parts, rows, split):
        return Plan(w, parts, rows, _threads(w // vec), split, vec, tiles,
                    itemsize, w // cg)

    # portable clusters first, then the non-portable sizes up to 16
    for sizes in (range(1, MAX_CLUSTER + 1),
                  range(MAX_CLUSTER + 1, MAX_CLUSTER_NONPORTABLE + 1)):
        best, best_key = None, None
        for w in widths:
            if w * itemsize < 64 and w != widths[-1]:
                continue
            for parts in sizes:
                rows = -(-l // parts)
                if parts > 1 and (parts - 1) * rows >= l:
                    break                             # a block without rows
                p = make(w, parts, rows, False)
                if p.smem > SMEM_PER_BLOCK:
                    continue
                blocks = b * (c // w) * parts
                per_sm = _blocks_per_sm(p)
                narrow = (w * itemsize < _MIN_SLICE[backward]
                          and rows > _NARROW_ROWS)
                key = (tiles * rows * w * itemsize > _TILE_MAX,
                       -(-blocks // (_SMS * per_sm)),       # waves
                       -min(blocks, _FILL[backward]), narrow,
                       backward and per_sm < 2, parts, blocks, -w)
                if best_key is None or key < best_key:
                    best, best_key = p, key
        if best is not None:
            return best
    w = next((w for w in widths if w * itemsize >= 128), widths[-1])
    rows = max(1, min(l, _TILE_SPLIT // (tiles * w * itemsize)))
    parts = -(-l // rows)
    return make(w, parts, -(-l // parts), True)


_tickets_cache: dict = {}
_tickets_lock = threading.Lock()


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """Zeroed int32 tickets for the backward's last-arrival sum of dscale
    and dbias, one per slice; the kernel leaves them zero, so one buffer per
    (device, stream) serves every call queued on that stream."""
    key = (device.index, stream)
    with _tickets_lock:
        t = _tickets_cache.get(key)
        if t is None or t.numel() < n:
            t = torch.zeros(max(n, 1024), device=device, dtype=torch.int32)
            _tickets_cache[key] = t
        return t


def _check_params(x, c, **params):
    for name, p in params.items():
        if (p.device != x.device or p.dtype != torch.float32
                or p.shape != (c,) or not p.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous fp32 ({c},) tensor "
                             f"on {x.device}")


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
    b, c = x.shape[0], x.shape[-1]
    _check_params(x, c, scale=scale, bias=bias)
    l = x.numel() // (b * c)
    if l == 0:
        raise ValueError("group_norm kernel got an empty tensor")
    pl = plan(b, l, c, num_groups, x.element_size(), False,
              x.data_ptr() % 16 == 0)
    y = torch.empty_like(x)
    stats = torch.empty((2, b, num_groups), device=x.device,
                        dtype=torch.float32)
    n_scratch = pl.scratch(b, c, num_groups)
    scratch = (torch.empty(2 * n_scratch, device=x.device,
                           dtype=torch.float32) if n_scratch else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = library().dt_group_norm_fwd(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            stats[0].data_ptr(), stats[1].data_ptr(),
            scratch.data_ptr() if n_scratch else None, b, l, c,
            num_groups, pl.width, pl.parts, pl.rows, pl.threads,
            int(pl.split), float(epsilon), int(act == "silu"),
            int(x.dtype == torch.bfloat16), pl.vec, stream)
    if rc != 0:
        raise RuntimeError(f"group_norm kernel launch failed: CUDA error {rc}")
    launches.add()
    return y, stats[0], stats[1]


def group_norm_bwd_cuda(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, mean: torch.Tensor,
                        rstd: torch.Tensor, g: torch.Tensor,
                        num_groups: int = 32, act: Optional[str] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernel: returns (dx, dscale, dbias); x and g
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
    _check_params(x, c, scale=scale, bias=bias)
    for name, t in (("mean", mean), ("rstd", rstd)):
        if (t.device != x.device or t.dtype != torch.float32
                or t.shape != (b, num_groups) or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous fp32 "
                             f"({b}, {num_groups}) tensor on {x.device}")
    l = x.numel() // (b * c)
    if l == 0:
        raise ValueError("group_norm kernel got an empty tensor")
    pl = plan(b, l, c, num_groups, x.element_size(), True,
              x.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0)
    dx = torch.empty_like(x)
    dparams = torch.empty((2, c), device=x.device, dtype=torch.float32)
    scratch = torch.empty(2 * pl.scratch(b, c, num_groups), device=x.device,
                          dtype=torch.float32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        tickets = _tickets(x.device, stream, c // pl.width)
        rc = library().dt_group_norm_bwd(
            x.data_ptr(), g.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
            dparams[0].data_ptr(), dparams[1].data_ptr(), scratch.data_ptr(),
            tickets.data_ptr(), b, l, c, num_groups, pl.width, pl.parts,
            pl.rows, pl.threads, int(pl.split), int(act == "silu"),
            int(x.dtype == torch.bfloat16), pl.vec, stream)
    if rc != 0:
        raise RuntimeError(f"group_norm backward kernel launch failed: "
                           f"CUDA error {rc}")
    launches_bwd.add()
    return dx, dparams[0], dparams[1]


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
