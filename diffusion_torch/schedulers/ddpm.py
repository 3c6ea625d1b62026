"""DDPM noise schedule: the numpy tables every sampler derives from, and
the training-time forward diffusion.

Counterpart of `diffusion_tpu/schedulers/ddpm.py`. `make_beta_schedule`,
`alphas_cumprod_np` and `uniform_timestep_grid` are copies of the JAX
module's numpy helpers (that module imports jax.numpy at top level, so it
cannot be imported here); ROADMAP.md lists lifting them into a shared
framework-free module. `add_noise` and `get_velocity` compute in fp32 and
return the sample's dtype, as the JAX scheduler does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["DDPMScheduler", "make_beta_schedule", "alphas_cumprod_np",
           "uniform_timestep_grid"]


def make_beta_schedule(schedule: str, num_timesteps: int, beta_start: float,
                       beta_end: float) -> np.ndarray:
    if schedule == "linear":
        return np.linspace(beta_start, beta_end, num_timesteps, dtype=np.float64)
    if schedule == "scaled_linear":
        return np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_timesteps,
                           dtype=np.float64) ** 2
    if schedule == "squaredcos_cap_v2":
        # Nichol & Dhariwal cosine schedule
        def abar(t: np.ndarray) -> np.ndarray:
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
        t = np.arange(num_timesteps, dtype=np.float64)
        betas = 1.0 - abar((t + 1) / num_timesteps) / abar(t / num_timesteps)
        return np.clip(betas, 0.0, 0.999)
    raise ValueError(f"unknown beta schedule {schedule!r}")


def alphas_cumprod_np(schedule: str, num_timesteps: int, beta_start: float,
                      beta_end: float,
                      rescale_zero_terminal_snr: bool = False) -> np.ndarray:
    """Cumulative product of (1 - beta), float64. `rescale_zero_terminal_snr`
    applies Lin et al. 2023 (arXiv:2305.08891 alg. 1): sqrt(alpha-bar) is
    rescaled so the last timestep has alpha-bar exactly 0."""
    abar = np.cumprod(1.0 - make_beta_schedule(schedule, num_timesteps,
                                               beta_start, beta_end))
    if rescale_zero_terminal_snr:
        s = np.sqrt(abar)
        s0, sT = s[0], s[-1]
        s = (s - sT) * (s0 / (s0 - sT))
        abar = s ** 2
    return abar


def uniform_timestep_grid(num_train_timesteps: int, num_inference_steps: int,
                          steps_offset: int,
                          spacing: str = "leading"
                          ) -> "tuple[np.ndarray, np.ndarray]":
    """Descending (t, t_prev) int32 arrays; t_prev[i] is the timestep step i
    moves to, negative meaning "final". `spacing` is diffusers'
    timestep_spacing: "leading" (SD2's shipped config) or "trailing"."""
    step_ratio = num_train_timesteps // num_inference_steps
    if spacing == "leading":
        ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1]
        ts = ts.astype(np.int64) + steps_offset
    elif spacing == "trailing":
        ts = np.arange(num_train_timesteps, 0,
                       -num_train_timesteps / num_inference_steps)
        ts = ts.round().astype(np.int64) - 1
    else:
        raise ValueError(f"unknown timestep spacing {spacing!r}; "
                         "choose leading or trailing")
    ts = np.minimum(ts, num_train_timesteps - 1)
    t_prev = ts - step_ratio
    return ts.astype(np.int32), t_prev.astype(np.int32)


def _expand(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """(B,) -> (B, 1, ..., 1) of rank `ndim`."""
    return t.reshape(t.shape[0], *([1] * (ndim - 1)))


@dataclasses.dataclass(frozen=True)
class DDPMScheduler:
    """The training noise schedule: ``add_noise(x, eps, t) = sqrt(abar_t) x +
    sqrt(1 - abar_t) eps`` and ``get_velocity(x, eps, t) = sqrt(abar_t) eps -
    sqrt(1 - abar_t) x`` over the fp32 alpha-bar table (diffusers' math)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "epsilon"
    variance_type: str = "fixed_small"
    rescale_betas_zero_snr: bool = False
    # carried into samplers built like this schedule; training ignores it
    timestep_spacing: str = "leading"

    @property
    def betas(self) -> torch.Tensor:
        return torch.from_numpy(
            make_beta_schedule(self.beta_schedule, self.num_train_timesteps,
                               self.beta_start, self.beta_end
                               ).astype(np.float32))

    @property
    def alphas_cumprod(self) -> torch.Tensor:
        return torch.from_numpy(
            alphas_cumprod_np(self.beta_schedule, self.num_train_timesteps,
                              self.beta_start, self.beta_end,
                              self.rescale_betas_zero_snr).astype(np.float32))

    @property
    def init_noise_sigma(self) -> float:
        return 1.0

    def __len__(self) -> int:
        return self.num_train_timesteps

    def _sqrt_coefficients(self, timesteps: torch.Tensor, ndim: int):
        abar = self.alphas_cumprod.to(timesteps.device)[timesteps]
        return (_expand(torch.sqrt(abar), ndim),
                _expand(torch.sqrt(1.0 - abar), ndim))

    def add_noise(self, original: torch.Tensor, noise: torch.Tensor,
                  timesteps: torch.Tensor) -> torch.Tensor:
        sqrt_abar, sqrt_1m = self._sqrt_coefficients(timesteps, original.ndim)
        return (sqrt_abar * original.float()
                + sqrt_1m * noise.float()).to(original.dtype)

    def get_velocity(self, sample: torch.Tensor, noise: torch.Tensor,
                     timesteps: torch.Tensor) -> torch.Tensor:
        sqrt_abar, sqrt_1m = self._sqrt_coefficients(timesteps, sample.ndim)
        return (sqrt_abar * noise.float()
                - sqrt_1m * sample.float()).to(sample.dtype)

    def scale_model_input(self, sample: torch.Tensor, t) -> torch.Tensor:
        return sample
