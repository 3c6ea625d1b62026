"""Weights drawn from the run's seed, in diffusers' parameter names.

The benchmark makes the weights and hands the same to the program and to
the reference. They are drawn on the device in one call, into one flat
float32 buffer (the type the program keeps its master weights in), and
shaped per leaf in a few foreach calls: a kernel N(0, 1/fan_in), a norm's
scale 1 + N(0, 0.05^2), a bias N(0, 0.05^2). The same seed gives the same
bits on the same device.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ["derive_seed", "draw_like"]


def derive_seed(*parts) -> int:
    """A 63-bit generator seed from the run's seed and a path of labels."""
    words = [int(p) if isinstance(p, (int, np.integer)) else
             int.from_bytes(str(p).encode(), "little") % (2 ** 32)
             for p in parts]
    words = [w for p in words for w in (p % 2 ** 32, p >> 32)]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) | (int(state[1]) << 32)) & (2 ** 63 - 1)


def draw_like(module: torch.nn.Module, seed: int, device
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(flat buffer, {name: view}) with `module`'s parameter names and
    shapes (the module may lie on the meta device)."""
    shapes = [(n, tuple(p.shape)) for n, p in module.named_parameters()]
    total = sum(int(np.prod(s)) for _, s in shapes)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    views, offset = {}, 0
    kernels, k_scale, ones, rest = [], [], [], []
    for name, shape in shapes:
        n = int(np.prod(shape))
        v = flat[offset:offset + n].view(shape)
        offset += n
        views[name] = v
        if len(shape) >= 2:
            kernels.append(v)
            k_scale.append(float(np.prod(shape[1:])) ** -0.5)
        else:
            (ones if name.endswith("weight") else rest).append(v)
    if kernels:
        torch._foreach_mul_(kernels, k_scale)
    if ones or rest:
        torch._foreach_mul_(ones + rest, 0.05)
    if ones:
        torch._foreach_add_(ones, 1.0)
    return flat, views
