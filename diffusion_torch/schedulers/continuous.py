"""Continuous-time VP-SDE scheduler (Song et al. 2020, arXiv:2011.13456).

Counterpart of `diffusion_tpu/schedulers/continuous.py`: the angle
schedule beta(t) = 2 tan(t), signal cos(t), noise sin(t), taken in fp32
from float timesteps; Euler-Maruyama steps of the reverse SDE or Euler
steps of the probability-flow ODE; the sampler protocol (`timesteps`,
`init_noise_sigma`, `scale_model_input`, `step`). The SDE's noise is an
explicit tensor: the caller draws it (or hands JAX's over).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["ContinuousTimeScheduler", "tangent_schedule"]


def tangent_schedule(times) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """beta(t), sin(phi(t)), cos(phi(t)) for the angle = time schedule
    (beta = 2 tan t), fp32."""
    times = torch.as_tensor(times, dtype=torch.float32)
    return 2.0 * torch.tan(times), torch.sin(times), torch.cos(times)


def _expand(t: torch.Tensor, ndim: int) -> torch.Tensor:
    t = torch.atleast_1d(t)
    return t.reshape(t.shape[0], *([1] * (ndim - 1)))


@dataclasses.dataclass(frozen=True)
class ContinuousTimeScheduler:
    t_max: float = 1.57
    num_inference_timesteps: int = 50
    prediction_type: str = "epsilon"
    use_ode: bool = False

    @property
    def init_noise_sigma(self) -> float:
        return 1.0

    def __len__(self) -> int:
        return self.num_inference_timesteps

    def scale_model_input(self, sample: torch.Tensor, t) -> torch.Tensor:
        return sample

    def timesteps(self, num_inference_steps: Optional[int] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """(t, t_prev) float32 arrays, t descending from t_max (0
        excluded)."""
        n = num_inference_steps or self.num_inference_timesteps
        ts = np.linspace(self.t_max, 0.0, num=n,
                         endpoint=False).astype(np.float32)
        dt = self.t_max / n
        return ts, ts - dt

    def add_noise(self, inputs: torch.Tensor, noise: torch.Tensor,
                  timesteps: torch.Tensor) -> torch.Tensor:
        _, sin_phi, cos_phi = tangent_schedule(
            _expand(timesteps.to(inputs.device), inputs.ndim))
        return cos_phi * inputs + sin_phi * noise

    def get_velocity(self, inputs: torch.Tensor, noise: torch.Tensor,
                     timesteps: torch.Tensor) -> torch.Tensor:
        _, sin_phi, cos_phi = tangent_schedule(
            _expand(timesteps.to(inputs.device), inputs.ndim))
        return -sin_phi * inputs + cos_phi * noise

    def step(self, model_output: torch.Tensor, t, t_prev,
             sample: torch.Tensor,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Integrate x_t back by dt = t_max / num_inference_timesteps
        (Euler ODE, or Euler-Maruyama SDE with standard normal `noise` of
        the sample's shape; None only with `use_ode`). At t == 0 it returns
        x unchanged."""
        beta_t, sin_phi, cos_phi = (v.to(sample.device)
                                    for v in tangent_schedule(t))
        dt = self.t_max / self.num_inference_timesteps
        x = sample.float()
        out = model_output.float()
        if self.prediction_type == "sample":
            x0 = out
        elif self.prediction_type == "epsilon":
            x0 = (x - sin_phi * out) / cos_phi
        elif self.prediction_type == "v_prediction":
            x0 = cos_phi * x - sin_phi * out
        else:
            raise ValueError(
                f"unknown prediction_type {self.prediction_type!r}")
        score = -(x - cos_phi * x0) / torch.square(sin_phi)
        if self.use_ode:
            x_prev = x + 0.5 * (x + score) * beta_t * dt
        else:
            x_prev = x + (0.5 * x + score) * beta_t * dt
            if noise is None:
                raise ValueError(
                    "SDE step requires a noise array (use_ode=False)")
            x_prev = x_prev + torch.sqrt(beta_t * dt) * noise.to(
                sample.device, torch.float32)
        # the reference returns x unchanged at exactly t == 0
        x_prev = torch.where(torch.as_tensor(t, dtype=torch.float32,
                                             device=x.device) == 0.0,
                             x, x_prev)
        return x_prev.to(sample.dtype)
