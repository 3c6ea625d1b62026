"""Plain DDIM (Song et al. 2021, eta 0) as diffusers' DDIMScheduler runs
Stable Diffusion 2's `scheduler_config.json`: scaled-linear betas
0.00085 -> 0.012 over 1000 steps, "leading" spacing with steps_offset 1,
set_alpha_to_one false (the last step lands on alpha-bar[0]), epsilon
prediction, no clipping."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.train import alphas_cumprod

__all__ = ["timesteps", "step"]


def timesteps(scheduler: dict, steps: int) -> np.ndarray:
    ratio = scheduler["num_train_timesteps"] // steps
    return (np.arange(steps) * ratio)[::-1] + scheduler.get("steps_offset",
                                                            1)


def step(scheduler: dict, eps: torch.Tensor, t: int, steps: int,
         x: torch.Tensor) -> torch.Tensor:
    """x_t -> x_{t - ratio} given the predicted noise."""
    abar = alphas_cumprod(scheduler)
    prev = t - scheduler["num_train_timesteps"] // steps
    a_t = float(abar[t])
    a_prev = float(abar[prev]) if prev >= 0 else float(abar[0])
    x0 = (x - (1.0 - a_t) ** 0.5 * eps) / a_t ** 0.5
    return a_prev ** 0.5 * x0 + (1.0 - a_prev) ** 0.5 * eps
