"""AdamW, with the EMA of the weights where a step has one, in one pass
over the parameters: the Hopper kernel and its plain PyTorch version.

The kernel (`diffusion_torch/csrc/adamw.cu`) replaces no TPU kernel: the
JAX package leaves the update to optax, which XLA fuses. On the card the
plain version's foreach operators make some twenty passes over every
parameter and hold two parameter-sized temporaries; the update is a few
flops an element, so bytes bound it, and the kernel reads g, p, mu and nu
(and e) once and writes p, mu and nu (and e) once, with no temporary. Its
arithmetic is the plain version's as the foreach operators round it on the
card, operation for operation (each product, sum, quotient and root rounded
on its own, but a division by a scalar as a product with its fp32
reciprocal and the EMA's `add_(alpha=)` as one fused multiply-add, as
those operators compute them), so the two agree bit for bit.

`adamw_reference` is the plain version (the CPU tensors' path; on the card
it is the kernel's yardstick): optax's clip + adamw update as
`train/optim.py::AdamW` has always computed it, then `ema_reference`, the
EMA's two foreach passes (`algorithms/ema.py::apply_ema`). `adamw_cuda`
launches the kernel over CUDA tensors or raises on what it does not take:
p, g and nu fp32, mu fp32 or bf16, e fp32, each contiguous, all on one
device. Neither changes `grads`.

A launch takes up to `MAX_TENSORS` tensors as its parameters, cut into
chunks of `CHUNK` elements that the blocks take in contiguous runs; `plan`
splits a longer list over a few launches and numbers the chunks.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from diffusion_torch.ops._build import LaunchCounter, library

__all__ = ["adamw_reference", "ema_reference", "adamw_cuda", "plan",
           "Launch", "launches", "CHUNK", "MAX_TENSORS"]

CHUNK = 16384         # elements a block takes at a time (kChunk)
MAX_TENSORS = 512     # tensors one launch's parameters hold (kMaxTensors)

launches = LaunchCounter()

Tensors = Sequence[torch.Tensor]


def ema_reference(ema: Tensors, params: Tensors, smoothing: float) -> None:
    """In place: e = s * e + (1 - s) * p, by two foreach passes; nothing
    at s = 1 (a held step)."""
    if smoothing == 1.0:
        return
    torch._foreach_mul_(ema, smoothing)
    torch._foreach_add_(ema, params, alpha=1.0 - smoothing)


@torch.no_grad()
def adamw_reference(params: Tensors, grads: Tensors, mu: Tensors,
                    nu: Tensors, ema: Optional[Tensors] = None, *,
                    lr: float, b1: float, b2: float, eps: float,
                    weight_decay: float, bc1: float, bc2: float,
                    grad_norm: Optional[torch.Tensor] = None,
                    clip: Optional[float] = None,
                    smoothing: float = 1.0) -> None:
    """One AdamW update of `params`, `mu` and `nu` in place, then the EMA
    `ema` at `smoothing` where given. `lr`, `bc1` and `bc2` (1 - b ** count)
    are fp32 values; with `clip`, the gradients are scaled by c / ||g||
    where `grad_norm` ||g|| >= c (computed on the device: no host sync)."""
    if clip:
        # g / ||g|| * c where ||g|| >= c, else g / 1 * 1
        hit = grad_norm >= clip
        one = torch.ones_like(grad_norm)
        grads = torch._foreach_div(grads, torch.where(hit, grad_norm, one))
        torch._foreach_mul_(grads, torch.where(
            hit, torch.full_like(grad_norm, clip), one))
    # nu = (1 - b2) (g g) + b2 nu
    tmp = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(tmp, 1.0 - b2)
    torch._foreach_mul_(nu, b2)
    torch._foreach_add_(nu, tmp)
    # mu = (1 - b1) g + b1 mu. JAX's promotion: b1 * mu runs in mu's
    # dtype with b1 rounded to it (a weakly typed scalar), the sum in
    # fp32 even when mu is kept in bf16
    tmp = torch._foreach_mul(grads, 1.0 - b1)
    if mu[0].dtype == torch.float32:
        mu32 = list(mu)
        torch._foreach_mul_(mu32, b1)
    else:
        mu32 = [m.float() for m in torch._foreach_mul(
            mu, torch.tensor(b1, dtype=mu[0].dtype).item())]
    torch._foreach_add_(mu32, tmp)
    del tmp
    # update = mu_hat / (sqrt(nu_hat) + eps), the corrections in fp32
    update = torch._foreach_div(mu32, bc1)
    denom = torch._foreach_div(nu, bc2)
    if denom[0].device.type == "cpu":
        # torch's vectorized fp32 sqrt on the CPU is not correctly
        # rounded (XLA's and CUDA's are): round it from fp64
        for d in denom:
            d.copy_(d.double().sqrt_())
    else:
        torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    torch._foreach_div_(update, denom)
    del denom
    # + weight_decay * p, then * -lr, then p + update
    torch._foreach_add_(update, torch._foreach_mul(params, weight_decay))
    torch._foreach_mul_(update, -lr)
    torch._foreach_add_(params, update)
    if mu[0].dtype != torch.float32:
        for old, new in zip(mu, mu32):
            old.copy_(new)
    if ema is not None:
        ema_reference(ema, params, smoothing)


@dataclasses.dataclass(frozen=True)
class Launch:
    """One launch: tensors `start` .. `stop` - 1 of the list, and their
    chunk offsets (`first_chunk[t + 1] - first_chunk[t]` chunks of
    `CHUNK` elements for the launch's tensor t, its last one short)."""

    start: int
    stop: int
    numels: np.ndarray          # int64, stop - start
    first_chunk: np.ndarray     # int32, stop - start + 1


@functools.lru_cache(maxsize=16)
def plan(numels: Tuple[int, ...]) -> Tuple[Launch, ...]:
    """The launches over tensors of `numels` elements: as few as hold
    `MAX_TENSORS` tensors each, the tensors spread evenly over them."""
    n = len(numels)
    if n == 0:
        return ()
    count = -(-n // MAX_TENSORS)
    per = -(-n // count)
    out = []
    for start in range(0, n, per):
        sizes = np.asarray(numels[start:start + per], dtype=np.int64)
        chunks = -(-sizes // CHUNK)
        first = np.zeros(len(sizes) + 1, dtype=np.int64)
        np.cumsum(chunks, out=first[1:])
        if first[-1] >= 2 ** 31:
            raise ValueError(f"{first[-1]} chunks of {CHUNK} elements do "
                             f"not fit one launch")
        out.append(Launch(start, start + len(sizes), sizes,
                          first.astype(np.int32)))
    return tuple(out)


_LISTS = ("params", "grads", "mu", "nu", "ema")


def _pointers(lists, device: torch.device, mu_dtype: torch.dtype
              ) -> Tuple[np.ndarray, Tuple[int, ...]]:
    """(the data pointers, list by list, as uint64; the tensors' sizes),
    raising on a tensor the kernel does not take. A few thousand tensors a
    step: each is read through as few accessors as the checks need."""
    if device.type != "cuda":
        raise ValueError(f"adamw_cuda needs CUDA tensors, not {device}")
    index = device.index
    numels = [t.numel() for t in lists[0]]
    ptrs = []
    for name, tensors in zip(_LISTS, lists):
        dtype = mu_dtype if name == "mu" else torch.float32
        for i, (t, n) in enumerate(zip(tensors, numels)):
            if (t.dtype is not dtype or t.get_device() != index
                    or not t.is_contiguous() or t.numel() != n):
                raise ValueError(
                    f"adamw kernel: {name}[{i}] is {t.dtype} of "
                    f"{t.numel()} values on {t.device}"
                    f"{'' if t.is_contiguous() else ', not contiguous'}; it "
                    f"takes contiguous {dtype} tensors on {device}, each the "
                    f"size of its parameter ({n})")
        ptrs += [t.data_ptr() for t in tensors]
    return np.asarray(ptrs, dtype=np.uint64), tuple(numels)


@torch.no_grad()
def adamw_cuda(params: Tensors, grads: Tensors, mu: Tensors, nu: Tensors,
               ema: Optional[Tensors] = None, *, lr: float, b1: float,
               b2: float, eps: float, weight_decay: float, bc1: float,
               bc2: float, grad_norm: Optional[torch.Tensor] = None,
               clip: Optional[float] = None,
               smoothing: float = 1.0) -> None:
    """`adamw_reference` by the kernel, in one pass (a launch per
    `MAX_TENSORS` tensors) on the current stream; the EMA folds in where
    `ema` is given and `smoothing` is not 1."""
    t0 = time.perf_counter_ns()
    n = len(params)
    if not n:
        return
    if ema is not None and smoothing == 1.0:
        ema = None
    lists = [params, grads, mu, nu] + ([ema] if ema is not None else [])
    if any(len(tensors) != n for tensors in lists):
        raise ValueError(f"adamw kernel: lists of "
                         f"{[len(t) for t in lists]} tensors")
    mu_dtype = mu[0].dtype
    if mu_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"adamw kernel: mu in fp32 or bf16, not {mu_dtype}")
    device = params[0].device
    ptrs, numels = _pointers(lists, device, mu_dtype)
    norm = None
    if clip:
        if (grad_norm is None or grad_norm.device != device
                or grad_norm.dtype != torch.float32 or grad_norm.numel() != 1):
            raise ValueError("adamw kernel: clipping needs the gradients' "
                             f"norm as an fp32 scalar on {device}")
        norm = grad_norm.data_ptr()
    ptrs = ptrs.reshape(len(lists), n)
    # fp32 scalars as the foreach operators round the plain version's
    # Python floats; b1 in mu's dtype where mu is bf16
    b1k = b1 if mu_dtype == torch.float32 else torch.tensor(
        b1, dtype=mu_dtype).item()
    # the foreach division by a scalar multiplies by its reciprocal,
    # taken in fp64 and rounded to fp32
    inv_bc1, inv_bc2 = (float(np.float32(1.0 / bc)) for bc in (bc1, bc2))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for ln in plan(numels):
            part = np.ascontiguousarray(ptrs[:, ln.start:ln.stop])
            rc = library().dt_adamw_ema_foreach(
                part.ctypes.data, ln.numels.ctypes.data,
                ln.first_chunk.ctypes.data, ln.stop - ln.start,
                int(mu_dtype == torch.bfloat16), int(ema is not None), norm,
                float(clip or 0.0), b1k, 1.0 - b1, b2, 1.0 - b2, inv_bc1,
                inv_bc2, eps, weight_decay, -lr, smoothing, 1.0 - smoothing,
                stream)
            if rc != 0:
                raise RuntimeError(f"adamw kernel launch failed: CUDA error "
                                   f"{rc}")
            launches.launched(t0)
            t0 = time.perf_counter_ns()
