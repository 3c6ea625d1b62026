"""Rectified-flow training draws and target, as SD3 and FLUX.1 train (Esser
et al. 2024, arXiv:2403.03206, sections 2 and 3.1; `SHIFT` is SD3's
published `scheduler/scheduler_config.json`'s,
`FlowMatchEulerDiscreteScheduler`).

The noised sample is the straight line x_t = (1 - t) x_0 + t eps between
the data (t = 0) and the noise (t = 1); the network predicts the velocity
v = eps - x_0 and sees t x `NUM_TRAIN_TIMESTEPS`. t is logit-normal,
sigmoid(u) with u ~ N(0, 1), then shifted toward the noise for high
resolutions: t <- s t / (1 + (s - 1) t), s = `SHIFT` for SD3. FLUX.1's
scheduler shifts by s = e^mu, mu on the published line through
(`BASE_SEQ_LEN`, `BASE_SHIFT`) and (`MAX_SEQ_LEN`, `MAX_SHIFT`) at the
packed image length (`dynamic_shift`; diffusers' `calculate_shift`): 1.15
at 4,096 tokens (1,024px), e^1.15 = 3.158.
"""

from __future__ import annotations

from typing import Optional

import math

import torch

__all__ = ["SHIFT", "NUM_TRAIN_TIMESTEPS", "sample_timesteps", "add_noise",
           "velocity", "dynamic_mu", "dynamic_shift"]

SHIFT = 3.0
NUM_TRAIN_TIMESTEPS = 1000
# FLUX.1-dev's `scheduler/scheduler_config.json` (use_dynamic_shifting)
BASE_SEQ_LEN, MAX_SEQ_LEN = 256, 4096
BASE_SHIFT, MAX_SHIFT = 0.5, 1.15


def sample_timesteps(n: int, generator: Optional[torch.Generator] = None,
                     device=None, shift: float = SHIFT) -> torch.Tensor:
    """n draws of t in (0, 1), fp32: sigmoid of a standard normal,
    shifted by `shift`."""
    t = torch.sigmoid(torch.randn((n,), generator=generator, device=device,
                                  dtype=torch.float32))
    return shift * t / (1.0 + (shift - 1.0) * t)


def dynamic_mu(image_seq_len: int) -> float:
    """mu of the published dynamic-shift line at `image_seq_len` packed
    image tokens: 0.5 at 256, 1.15 at 4,096, linear between and beyond."""
    m = (MAX_SHIFT - BASE_SHIFT) / (MAX_SEQ_LEN - BASE_SEQ_LEN)
    return image_seq_len * m + (BASE_SHIFT - m * BASE_SEQ_LEN)


def dynamic_shift(image_seq_len: int) -> float:
    """The shift e^mu at `image_seq_len` packed image tokens."""
    return math.exp(dynamic_mu(image_seq_len))


def add_noise(x0: torch.Tensor, noise: torch.Tensor,
              t: torch.Tensor) -> torch.Tensor:
    """(1 - t) x0 + t noise, t per sample."""
    t = t.to(x0.dtype).reshape(t.shape[0], *([1] * (x0.ndim - 1)))
    return (1.0 - t) * x0 + t * noise


def velocity(x0: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The target: d x_t / d t = noise - x0."""
    return noise - x0
