"""Rectified-flow training draws and target, as SD3 trains (Esser et al.
2024, arXiv:2403.03206, sections 2 and 3.1; `SHIFT` is the published
`scheduler/scheduler_config.json`'s, `FlowMatchEulerDiscreteScheduler`).

The noised sample is the straight line x_t = (1 - t) x_0 + t eps between
the data (t = 0) and the noise (t = 1); the network predicts the velocity
v = eps - x_0 and sees t x `NUM_TRAIN_TIMESTEPS`. t is logit-normal,
sigmoid(u) with u ~ N(0, 1), then shifted toward the noise for high
resolutions: t <- SHIFT t / (1 + (SHIFT - 1) t).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["SHIFT", "NUM_TRAIN_TIMESTEPS", "sample_timesteps", "add_noise",
           "velocity"]

SHIFT = 3.0
NUM_TRAIN_TIMESTEPS = 1000


def sample_timesteps(n: int, generator: Optional[torch.Generator] = None,
                     device=None) -> torch.Tensor:
    """n draws of t in (0, 1), fp32: sigmoid of a standard normal,
    shifted."""
    t = torch.sigmoid(torch.randn((n,), generator=generator, device=device,
                                  dtype=torch.float32))
    return SHIFT * t / (1.0 + (SHIFT - 1.0) * t)


def add_noise(x0: torch.Tensor, noise: torch.Tensor,
              t: torch.Tensor) -> torch.Tensor:
    """(1 - t) x0 + t noise, t per sample."""
    t = t.to(x0.dtype).reshape(t.shape[0], *([1] * (x0.ndim - 1)))
    return (1.0 - t) * x0 + t * noise


def velocity(x0: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The target: d x_t / d t = noise - x0."""
    return noise - x0
