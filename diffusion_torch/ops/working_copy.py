"""The bf16 working copy of a training step's weights: one cast of every
trained weight a step, and each microbatch's weight gradient added into
the fp32 `.grad` in one pass.

`Linear` and `Conv2d` (`models/layers.py`) compute in their input's dtype
over fp32 parameters; `operands(weight, bias, dtype)` gives them the two in
that dtype. Outside a scope it is the per-call cast `p.to(dtype)`, which
autograd differentiates: on the card three passes over the weight for each
microbatch (the cast, `ToCopyBackward`'s cast of the bf16 gradient back to
fp32, `AccumulateGrad`'s add into `.grad`). Inside `working_copies(module)`,
the scope the Trainer enters around an unsharded step's forward and
backward:

- entering it casts every covered weight into one bf16 buffer in one pass
  (`refresh_cuda`: a multi-tensor launch per `MAX_TENSORS` weights,
  planned as `ops/adamw.py::plan` plans the update), and leaving it frees
  the buffer. Inside the step's CUDA graph the pass is captured with the
  step and the buffer lies in the graph's pool, where the per-call casts
  lay: every replay copies the weights the last update (or a checkpoint
  load, or an EMA swap back) wrote. Nothing is kept across steps, so
  nothing can go stale. A kh x kw convolution's copy (kh * kw > 1) lies
  in channels_last order, the order cuDNN takes the weight in beside the
  port's channels_last activations (a contiguous weight it re-lays out on
  every call, forward and backward; `Conv2d` hands cuDNN a contiguous
  weight where its input is not channels_last, as the per-call cast
  does);
- a covered layer gets its copies through `_Alias`, one autograd node a
  call, with no cast. The node's backward hands each bf16 gradient to
  `accumulate`, which writes `.grad` in fp32 (a new `.grad` where it is
  None, else `.grad += float(g)`) and returns no gradient for the
  parameter, so `AccumulateGrad` does not run (Megatron's `main_grad`
  works the same way).

A scope covers the `weight` and `bias` of each submodule with a true
`casts_weights` (the two layers) whose parameters are all trained: plain
fp32 `Parameter`s (no DTensor) that require grad, contiguous, with no
gradient hook, where the module's `dtype` is bf16. Everything else keeps
the per-call cast: eval, serving and samplers (no scope), frozen weights
(the VAE, CLIP, LoRA's base), hooked parameters, and the sharded steps
(FSDP2's DTensors and their hooks, tp and sp), whose scope the Trainer does
not enter.

The numbers are the per-call cast's, bit for bit: the copy rounds as
`.to(torch.bfloat16)` does, the first microbatch's `.grad` is float(g) and
each later one adds float(g) in one fp32 rounding, as `AccumulateGrad`
does. On CUDA tensors the kernels (`csrc/working_copy.cu`) do the
work; on the CPU, `copy_` and `add_`.

`.grad` is contiguous, as the parameter is; the pass also reads the
channels_last order cuDNN gives a convolution's weight gradient. A
gradient in another layout takes `.grad`'s own `add_` and is counted in
`fallbacks`, as is each per-call cast of a
parameter that requires grad while autograd records (a gradient that
reaches `.grad` through `AccumulateGrad`). `accumulations` counts the
gradients the op's pass added, `refreshes` the copy's launches. The copies
are neither parameters nor buffers, and live only inside the scope: no
state_dict, checkpoint or storage signature sees them.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from diffusion_torch.ops._build import LaunchCounter, library
from diffusion_torch.ops.adamw import plan

__all__ = ["operands", "working_copies", "refresh_cuda", "accumulate",
           "accumulate_cuda", "refreshes", "accumulations", "fallbacks",
           "MAX_TAPS"]

MAX_TAPS = 16          # kh * kw of a channels_last gradient (kMaxTaps)
_ALIGN = 64            # values: 128 bytes of bf16

refreshes = LaunchCounter()
accumulations = LaunchCounter()
fallbacks = LaunchCounter()

Pair = Tuple[torch.Tensor, Optional[torch.Tensor]]

# inside a scope: each covered layer's weight -> its (weight, bias) copies.
# Process-wide, not per thread: the autograd engine's device thread runs a
# rematerialized block's forward again inside the backward
_active: Optional[Dict[torch.Tensor, Pair]] = None


class _Alias(torch.autograd.Function):
    """The copies as the layer's operands (views of them, with this node
    as their grad_fn); the backward adds their gradients into the
    parameters' `.grad` and passes nothing on."""

    @staticmethod
    def forward(ctx, weight, weight_copy, bias, bias_copy):
        ctx.set_materialize_grads(False)
        ctx.params = (weight, bias)
        return weight_copy, bias_copy

    @staticmethod
    def backward(ctx, grad_weight, grad_bias):
        for p, g in zip(ctx.params, (grad_weight, grad_bias)):
            if g is not None:
                accumulate(p, g)
        return None, None, None, None


def operands(weight: torch.Tensor, bias: Optional[torch.Tensor],
             dtype: torch.dtype) -> Pair:
    """(weight, bias) in `dtype` for one call of a layer: the scope's
    copies where it covers the layer, else the per-call cast."""
    if weight.dtype == dtype:
        return weight, bias
    copies = None if _active is None else _active.get(weight)
    if copies is not None and copies[0].dtype == dtype:
        if torch.is_grad_enabled():
            return _Alias.apply(weight, copies[0], bias, copies[1])
        return copies
    if torch.is_grad_enabled():
        trained = int(weight.requires_grad) + int(
            bias is not None and bias.requires_grad)
        if trained:
            fallbacks.add(trained)
    return weight.to(dtype), None if bias is None else bias.to(dtype)


def _taps(g: torch.Tensor) -> Optional[int]:
    """1 where `g` lies in a contiguous parameter's order; kh * kw where it
    is a 4-D gradient in channels_last order; None otherwise."""
    if g.is_contiguous():
        return 1
    if g.dim() == 4 and g.is_contiguous(memory_format=torch.channels_last):
        taps = g.shape[2] * g.shape[3]
        return taps if taps <= MAX_TAPS and g.shape[0] <= 65535 else None
    return None


def accumulate(p: torch.Tensor, g: torch.Tensor) -> None:
    """`p.grad` (+)= float(g) for a bf16 gradient `g` of a contiguous fp32
    parameter: `p.grad` made like `p` where it is None. Runs in the
    backward (no grad mode to enter: the host time counts a launch)."""
    t0 = time.perf_counter_ns()
    grad = p.grad
    taps = _taps(g) if g.dtype == torch.bfloat16 else None
    if taps is not None and (grad is None or grad.is_contiguous()):
        fresh = grad is None
        if fresh:
            grad = torch.empty_like(p, memory_format=torch.contiguous_format)
        if g.is_cuda:
            _launch(grad, g, taps, not fresh, t0)
        else:
            if fresh:
                grad.copy_(g)
            else:
                grad.add_(g)
            accumulations.add()
        if fresh:
            p.grad = grad
        return
    fallbacks.add()
    if grad is None:
        p.grad = torch.empty_like(p).copy_(g)
    else:
        grad.add_(g.float())


def accumulate_cuda(grad: torch.Tensor, g: torch.Tensor,
                    add: bool) -> None:
    """`grad` (+)= float(g) by the kernel on the current stream: `grad`
    contiguous fp32, `g` bf16 of its shape, contiguous or (4-D) in
    channels_last order."""
    t0 = time.perf_counter_ns()
    taps = _taps(g)
    if (grad.dtype != torch.float32 or g.dtype != torch.bfloat16
            or not grad.is_contiguous() or taps is None
            or grad.shape != g.shape or grad.device != g.device
            or g.device.type != "cuda"):
        raise ValueError(
            f"grad accumulate kernel: takes a contiguous fp32 gradient on "
            f"CUDA and a bf16 one of its shape, contiguous or channels_last; "
            f"got {grad.dtype} {tuple(grad.shape)} on {grad.device} and "
            f"{g.dtype} {tuple(g.shape)} on {g.device}")
    _launch(grad, g, taps, add, t0)


def _launch(grad: torch.Tensor, g: torch.Tensor, taps: int, add: bool,
            t0: int) -> None:
    """The accumulate kernel's launch, its arguments checked: on `g`'s
    device's current stream (the autograd engine's device thread already
    runs on that device, so no device switch on that path)."""
    if g.numel():
        rows, cols = (g.shape[0], g.shape[1]) if taps > 1 else (1, g.numel())
        switch = (torch.cuda.device(g.device)
                  if g.device.index != torch.cuda.current_device()
                  else contextlib.nullcontext())
        with switch:
            rc = library().dt_grad_accumulate(
                g.data_ptr(), grad.data_ptr(), rows, cols, taps, int(add),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"grad accumulate kernel launch failed: CUDA "
                               f"error {rc}")
    accumulations.launched(t0)


def _copy_taps(p: torch.Tensor) -> int:
    """kh * kw where `p`'s copy lies in channels_last order (a kh x kw
    convolution's weight, 1 < kh * kw <= MAX_TAPS), else 1."""
    if p.dim() != 4 or p.shape[0] > 65535:
        return 1
    taps = p.shape[2] * p.shape[3]
    return taps if 1 < taps <= MAX_TAPS else 1


def refresh_cuda(params: Sequence[torch.Tensor],
                 copies: Sequence[torch.Tensor]) -> None:
    """copies[i] = params[i] rounded to bf16, by the kernels on the current
    stream: params contiguous fp32, copies bf16 of their shapes, all on one
    CUDA device. The contiguous copies in one pass (a launch per
    `MAX_TENSORS` tensors), each channels_last one (a convolution's weight
    of `_copy_taps` > 1) in a launch of its own."""
    t0 = time.perf_counter_ns()
    n = len(params)
    if not n:
        return
    device = params[0].device
    if device.type != "cuda" or len(copies) != n:
        raise ValueError(f"working copy kernel: {n} parameters on {device} "
                         f"and {len(copies)} copies; it takes as many of "
                         f"each, on CUDA")
    flat, tiled = [], []
    for i, (p, c) in enumerate(zip(params, copies)):
        taps = _copy_taps(p)
        layout = torch.channels_last if c.dim() == 4 and not \
            c.is_contiguous() else torch.contiguous_format
        if (p.dtype is not torch.float32 or c.dtype is not torch.bfloat16
                or p.device != device or c.device != device
                or not p.is_contiguous() or c.shape != p.shape
                or not c.is_contiguous(memory_format=layout)
                or (layout == torch.channels_last and taps == 1)):
            raise ValueError(
                f"working copy kernel: parameter {i} is {p.dtype} "
                f"{tuple(p.shape)} on {p.device}, its copy {c.dtype} "
                f"{tuple(c.shape)} on {c.device}; it takes a contiguous fp32 "
                f"parameter on {device} and a bfloat16 copy of its shape, "
                f"contiguous or (a kh x kw convolution's weight) "
                f"channels_last")
        (tiled if layout == torch.channels_last else flat).append((p, c))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        if flat:
            numels = tuple(p.numel() for p, _ in flat)
            ptrs = np.asarray([p.data_ptr() for p, _ in flat]
                              + [c.data_ptr() for _, c in flat],
                              dtype=np.uint64).reshape(2, len(flat))
            for ln in plan(numels):
                part = np.ascontiguousarray(ptrs[:, ln.start:ln.stop])
                _launched(library().dt_working_copy_refresh(
                    part.ctypes.data, ln.numels.ctypes.data,
                    ln.first_chunk.ctypes.data, ln.stop - ln.start, stream),
                    t0)
                t0 = time.perf_counter_ns()
        for p, c in tiled:
            _launched(library().dt_working_copy_refresh_tiled(
                p.data_ptr(), c.data_ptr(), p.shape[0], p.shape[1],
                p.shape[2] * p.shape[3], stream), t0)
            t0 = time.perf_counter_ns()


def _launched(rc: int, t0: int) -> None:
    if rc != 0:
        raise RuntimeError(f"working copy kernel launch failed: CUDA error "
                           f"{rc}")
    refreshes.launched(t0)


def _trained(p: Optional[torch.Tensor]) -> bool:
    return (type(p) is nn.Parameter and p.requires_grad
            and p.dtype == torch.float32 and p.is_contiguous()
            and not p._backward_hooks
            and not getattr(p, "_post_accumulate_grad_hooks", None))


def _covered(module: nn.Module) -> List[Pair]:
    """The (weight, bias) of each layer of `module` that a scope covers."""
    if getattr(module, "dtype", None) != torch.bfloat16:
        return []
    return [(m.weight, m.bias) for m in module.modules()
            if getattr(m, "casts_weights", False) and _trained(m.weight)
            and (m.bias is None or _trained(m.bias))]


def _view(flat: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """`flat` as `p`'s copy: channels_last where `_copy_taps(p)` > 1."""
    if _copy_taps(p) == 1:
        return flat.view(p.shape)
    o, i, kh, kw = p.shape
    return flat.view(o, kh, kw, i).permute(0, 3, 1, 2)


@contextlib.contextmanager
def working_copies(module: nn.Module):
    """Copy `module`'s covered weights into one bf16 buffer in one pass,
    and hand the copies to the covered layers until the scope ends, which
    frees them: inside a CUDA graph's capture they take the graph's pool,
    where the per-call casts lay, and every replay rewrites them there."""
    global _active
    pairs = _covered(module)
    params = [p for pair in pairs for p in pair if p is not None]
    copies: List[torch.Tensor] = []
    if params:
        # each copy 128-byte aligned in the buffer
        sizes = [-(-p.numel() // _ALIGN) * _ALIGN for p in params]
        buf = torch.empty(sum(sizes), dtype=torch.bfloat16,
                          device=params[0].device)
        offsets = np.cumsum([0] + sizes[:-1]).tolist()
        copies = [_view(buf[o:o + p.numel()], p)
                  for o, p in zip(offsets, params)]
        del buf
        if params[0].is_cuda:
            refresh_cuda(params, copies)
        else:
            with torch.no_grad():
                for c, p in zip(copies, params):
                    c.copy_(p)
    it = iter(copies)
    covered = {w: (next(it), None if b is None else next(it))
               for w, b in pairs}
    previous, _active = _active, covered
    try:
        yield
    finally:
        _active = previous
