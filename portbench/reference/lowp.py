"""The control: the reference in the nearest precision below the
configuration's bf16, which is fp8, as fp8 training computes: inside
`Fp8Products`, every input of a product (linear, convolution, matmul) is
rounded to e4m3, and the gradient that reaches a product's output to
e5m2, each after a per-tensor scale to its largest magnitude. The
rounding is otherwise passed straight through."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

__all__ = ["Fp8Products", "fp8_round"]

_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    scale = _MAX[dtype] / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 in the forward; the gradient passes through."""
    if not x.is_floating_point():
        return x
    with torch.no_grad():
        rounded = _round(x, torch.float8_e4m3fn)
    return x + (rounded - x).detach()


class _GradE5M2(torch.autograd.Function):
    """Identity forward; the incoming gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


_PRODUCTS = {F.linear, F.conv2d, torch.matmul, torch.Tensor.__matmul__,
             torch.bmm, torch.Tensor.matmul}


class Fp8Products(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in _PRODUCTS:
            return func(*args, **kwargs)
        # the two operands of every product: input and weight, or a @ b
        args = tuple(fp8_round(a) if isinstance(a, torch.Tensor) and i < 2
                     else a for i, a in enumerate(args))
        out = func(*args, **kwargs)
        return _GradE5M2.apply(out) if out.requires_grad else out
