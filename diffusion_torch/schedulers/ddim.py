"""Deterministic (eta = 0) DDIM sampler.

Counterpart of `diffusion_tpu/schedulers/ddim.py`: `timesteps(n)` returns the
whole descending (t, t_prev) grid up front and `step` is a pure function of
(model_output, t, t_prev, sample). The coefficients are fp32, as the JAX
tables are, and the update runs in fp32 whatever the sample's dtype. SD2's
settings are fixed: no sample clipping, and the last step lands on
alpha-bar[0] (`set_alpha_to_one=False`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from diffusion_torch.schedulers.ddpm import (alphas_cumprod_f32,
                                             uniform_timestep_grid)

__all__ = ["DDIMScheduler"]


@dataclasses.dataclass(frozen=True)
class DDIMScheduler:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "epsilon"
    steps_offset: int = 1
    rescale_betas_zero_snr: bool = False
    timestep_spacing: str = "leading"

    def __post_init__(self):
        if self.rescale_betas_zero_snr and self.prediction_type == "epsilon":
            raise ValueError(
                "rescale_betas_zero_snr requires prediction_type "
                "v_prediction (or sample), not epsilon")
        if self.rescale_betas_zero_snr and self.timestep_spacing != "trailing":
            raise ValueError(
                "rescale_betas_zero_snr requires "
                "timestep_spacing='trailing' so sampling starts at t=T-1")

    @property
    def alphas_cumprod(self) -> np.ndarray:
        """fp32 alpha-bar table (numpy: indexed on the host every step)."""
        return alphas_cumprod_f32(self.beta_schedule, self.num_train_timesteps,
                                  self.beta_start, self.beta_end,
                                  self.rescale_betas_zero_snr)

    @property
    def init_noise_sigma(self) -> float:
        return 1.0

    def scale_model_input(self, sample: torch.Tensor, t) -> torch.Tensor:
        return sample

    def noise_to(self, x0: torch.Tensor, noise: torch.Tensor,
                 t: int) -> torch.Tensor:
        """Clean latents noised to timestep t, sqrt(abar_t) x0 +
        sqrt(1 - abar_t) eps in fp32: the img2img (SDEdit) entry point into
        the middle of the trajectory."""
        a2 = self.alphas_cumprod[int(t)]
        return (float(np.sqrt(a2)) * x0.float()
                + float(np.sqrt(np.float32(1.0) - a2)) * noise.float())

    def timesteps(self, num_inference_steps: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """(t, t_prev) int32 arrays, descending; t_prev < 0 means final."""
        return uniform_timestep_grid(self.num_train_timesteps,
                                     num_inference_steps, self.steps_offset,
                                     self.timestep_spacing)

    def step(self, model_output: torch.Tensor, t: int, t_prev: int,
             sample: torch.Tensor) -> torch.Tensor:
        """One eta = 0 DDIM update x_t -> x_{t_prev}."""
        abar = self.alphas_cumprod
        a_t = abar[int(t)]
        # the final step lands on alpha-bar[0] (SD2's set_alpha_to_one=False)
        a_prev = abar[int(t_prev)] if t_prev >= 0 else abar[0]
        sqrt_at, sqrt_1m_at = np.sqrt(a_t), np.sqrt(np.float32(1.0) - a_t)

        x = sample.float()
        out = model_output.float()
        if self.prediction_type == "epsilon":
            x0 = (x - float(sqrt_1m_at) * out) / float(sqrt_at)
            eps = out
        elif self.prediction_type == "sample":
            x0 = out
            eps = (x - float(sqrt_at) * x0) / float(sqrt_1m_at)
        elif self.prediction_type == "v_prediction":
            x0 = float(sqrt_at) * x - float(sqrt_1m_at) * out
            eps = float(sqrt_at) * out + float(sqrt_1m_at) * x
        else:
            raise ValueError(f"unknown prediction_type {self.prediction_type!r}")

        prev = (float(np.sqrt(a_prev)) * x0
                + float(np.sqrt(np.float32(1.0) - a_prev)) * eps)
        return prev.to(sample.dtype)
