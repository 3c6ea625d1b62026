"""DPM-Solver++(2M) and Euler samplers.

Counterpart of `diffusion_tpu/schedulers/dpm.py`, with its dataclass fields
and protocol: `timesteps(n)` is the shared descending (t, t_prev) grid of
`ddpm.uniform_timestep_grid` (DDIM's), `scale_model_input` and `noise_to`
(the img2img entry, in the sampler's own working space), and
`init_noise_sigma`. DPM-Solver++(2M) (Lu et al. 2022, arXiv:2211.01095) is
a second-order multistep solver in log-SNR (lambda) space: it reuses the
previous step's denoised prediction, which it carries as explicit state
(`init_state` / `step_with_state`); `StableDiffusion.denoise_loop` looks
for `init_state`. EulerDiscrete (Karras et al. 2022, arXiv:2206.00364
algorithm 1) is the first-order sampler in sigma space (x = x0 + sigma *
eps), whose initial noise is scaled by `init_sigma(num_inference_steps)`.

The coefficients are computed as the JAX package computes them: in fp32
from the fp32 alpha-bar table (numpy float32 scalars here, indexed on the
host every step), with a 1e-12 floor on sigma at the terminal step, where
DPM++ integrates to sigma = 0 and lands on the denoised prediction. The
updates run in fp32 whatever the sample's dtype, and return its dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from diffusion_torch.schedulers.ddpm import (alphas_cumprod_f32,
                                             alphas_cumprod_np,
                                             uniform_timestep_grid)

__all__ = ["DPMSolverMultistepScheduler", "EulerDiscreteScheduler"]

_F32 = np.float32


def _x0_from_output(model_output: torch.Tensor, sample: torch.Tensor,
                    alpha_t: float, sigma_t: float,
                    prediction_type: str) -> torch.Tensor:
    """Denoised prediction in the VP parameterization x_t = a x0 + s eps."""
    if prediction_type == "epsilon":
        return (sample - sigma_t * model_output) / alpha_t
    if prediction_type == "sample":
        return model_output
    if prediction_type == "v_prediction":
        return alpha_t * sample - sigma_t * model_output
    raise ValueError(f"unknown prediction_type {prediction_type!r}")


def _table(sched) -> np.ndarray:
    return alphas_cumprod_f32(sched.beta_schedule, sched.num_train_timesteps,
                              sched.beta_start, sched.beta_end)


@dataclasses.dataclass(frozen=True)
class DPMSolverMultistepScheduler:
    """DPM-Solver++(2M), the data-prediction variant with the midpoint
    update. `lower_order_final` drops the terminal step to first order only
    for runs of fewer than 15 steps (diffusers' gate). The state is the
    previous step's denoised prediction and its lambda."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "epsilon"
    steps_offset: int = 1
    lower_order_final: bool = True
    rescale_betas_zero_snr: bool = False
    timestep_spacing: str = "leading"

    def __post_init__(self):
        if self.rescale_betas_zero_snr:
            raise ValueError(
                "rescale_betas_zero_snr: lambda(T) = log(alpha/sigma) "
                "diverges at zero terminal SNR — sample the rescaled "
                "schedule with DDIM (+ v_prediction), not DPM-Solver++")

    @property
    def alphas_cumprod(self) -> np.ndarray:
        """fp32 alpha-bar table (numpy: indexed on the host every step)."""
        return _table(self)

    @property
    def init_noise_sigma(self) -> float:
        return 1.0

    def scale_model_input(self, sample: torch.Tensor, t) -> torch.Tensor:
        return sample

    def noise_to(self, x0: torch.Tensor, noise: torch.Tensor,
                 t: int) -> torch.Tensor:
        """Clean latents noised to timestep t in VP space, fp32: the
        img2img entry point."""
        a2 = self.alphas_cumprod[int(t)]
        return (float(np.sqrt(a2)) * x0.float()
                + float(np.sqrt(_F32(1.0) - a2)) * noise.float())

    def timesteps(self, num_inference_steps: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """The same descending (t, t_prev) grid as DDIMScheduler's."""
        return uniform_timestep_grid(self.num_train_timesteps,
                                     num_inference_steps, self.steps_offset,
                                     self.timestep_spacing)

    def init_state(self, latents: torch.Tensor):
        """(prev_x0, prev_lambda); their values are unused on the first
        step."""
        return (torch.zeros_like(latents, dtype=torch.float32), _F32(0.0))

    def _coeffs(self, t: int, t_prev: int):
        abar = self.alphas_cumprod
        a2_t = abar[int(t)]
        # t_prev < 0 is the final step: sigma -> 0 (abar -> 1), the solver
        # lands on the denoised prediction; the floor keeps lambda finite
        a2_p = abar[int(t_prev)] if t_prev >= 0 else _F32(1.0)
        alpha_t, sigma_t = np.sqrt(a2_t), np.sqrt(_F32(1.0) - a2_t)
        alpha_p = np.sqrt(a2_p)
        sigma_p = np.maximum(np.sqrt(_F32(1.0) - a2_p), _F32(1e-12))
        lam_t = np.log(alpha_t / sigma_t)
        lam_p = np.log(alpha_p / sigma_p)
        return alpha_t, sigma_t, lam_t, alpha_p, sigma_p, lam_p

    def step_with_state(self, model_output: torch.Tensor, t: int,
                        t_prev: int, sample: torch.Tensor, state,
                        step_index: int, num_steps: int):
        """One DPM-Solver++(2M) update x_t -> x_{t_prev}; `step_index` is
        the position in the descending grid, `num_steps` its length.
        Returns (x_{t_prev} in the sample's dtype, the new state)."""
        alpha_t, sigma_t, lam_t, alpha_p, sigma_p, lam_p = \
            self._coeffs(t, t_prev)
        x = sample.float()
        x0 = _x0_from_output(model_output.float(), x, float(alpha_t),
                             float(sigma_t), self.prediction_type)
        prev_x0, prev_lam = state
        h = lam_p - lam_t
        coef = alpha_p * (_F32(1.0) - np.exp(-h))
        first = x * float(sigma_p / sigma_t) + float(coef) * x0
        # the first step, and the terminal step of a short run
        # (lower_order_final), stay first order
        lof = bool(self.lower_order_final) and num_steps < 15
        if step_index == 0 or (lof and step_index == num_steps - 1):
            prev = first
        else:
            # midpoint 2M correction: D1 = (x0_t - x0_{t-1}) / r,
            # r = h_last / h
            r = np.maximum((lam_t - prev_lam) / h, _F32(1e-12))
            d1 = (x0 - prev_x0) / float(r)
            prev = first + float(_F32(0.5) * coef) * d1
        return prev.to(sample.dtype), (x0, lam_t)

    def step(self, model_output: torch.Tensor, t: int, t_prev: int,
             sample: torch.Tensor) -> torch.Tensor:
        """Stateless first-order step (DPM-Solver++(1))."""
        out, _ = self.step_with_state(model_output, t, t_prev, sample,
                                      self.init_state(sample), 0, 1)
        return out


@dataclasses.dataclass(frozen=True)
class EulerDiscreteScheduler:
    """Euler over the discrete VP noise schedule, in sigma space (x = x0 +
    sigma * eps). The model is fed x / sqrt(sigma^2 + 1), which is the VP
    x_t, so a UNet trained under DDPM drops in unchanged. First order,
    stateless."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "epsilon"
    steps_offset: int = 1
    rescale_betas_zero_snr: bool = False
    timestep_spacing: str = "leading"

    def __post_init__(self):
        if self.rescale_betas_zero_snr:
            raise ValueError(
                "rescale_betas_zero_snr: sigma(T) is infinite at zero "
                "terminal SNR — sample the rescaled schedule with DDIM "
                "(+ v_prediction), not Euler")

    @property
    def alphas_cumprod(self) -> np.ndarray:
        return _table(self)

    def _sigma(self, t: int) -> np.float32:
        if t < 0:
            return _F32(0.0)
        a2 = self.alphas_cumprod[int(t)]
        return np.sqrt((_F32(1.0) - a2) / a2)

    def init_sigma(self, num_inference_steps: int) -> float:
        """The initial noise's scale: sigma at the inference grid's top
        step (diffusers EulerDiscrete's init_noise_sigma). The full grid's
        sigma(999) would over-scale x_T by 1.33x at 20 steps. Taken from
        the float64 table, as the JAX package takes it."""
        abar = alphas_cumprod_np(self.beta_schedule, self.num_train_timesteps,
                                 self.beta_start, self.beta_end)
        ts, _ = self.timesteps(num_inference_steps)
        a2 = abar[int(ts[0])]
        return float(np.sqrt((1.0 - a2) / a2))

    @property
    def init_noise_sigma(self) -> float:
        """The full grid's value; generate uses init_sigma(num_steps)."""
        return self.init_sigma(self.num_train_timesteps)

    def scale_model_input(self, sample: torch.Tensor, t) -> torch.Tensor:
        sigma = self._sigma(int(t))
        scale = float(np.sqrt(sigma * sigma + _F32(1.0)))
        return (sample.float() / scale).to(sample.dtype)

    def noise_to(self, x0: torch.Tensor, noise: torch.Tensor,
                 t: int) -> torch.Tensor:
        """Clean latents noised to timestep t in this sampler's working
        space: sigma space (x0 + sigma eps), not VP."""
        return x0.float() + float(self._sigma(int(t))) * noise.float()

    def timesteps(self, num_inference_steps: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
        return uniform_timestep_grid(self.num_train_timesteps,
                                     num_inference_steps, self.steps_offset,
                                     self.timestep_spacing)

    def step(self, model_output: torch.Tensor, t: int, t_prev: int,
             sample: torch.Tensor) -> torch.Tensor:
        """x_{t_prev} = x_t + (sigma_prev - sigma_t) d, d = (x_t - x0) /
        sigma_t."""
        sigma = self._sigma(int(t))
        sigma_prev = self._sigma(int(t_prev))
        x = sample.float()
        out = model_output.float()
        if self.prediction_type == "epsilon":
            x0 = x - float(sigma) * out
        elif self.prediction_type == "sample":
            x0 = out
        elif self.prediction_type == "v_prediction":
            # the model saw x / sqrt(sigma^2 + 1): EulerDiscrete's
            # conversion
            s2p1 = sigma * sigma + _F32(1.0)
            x0 = (-out * float(sigma / np.sqrt(s2p1)) + x / float(s2p1))
        else:
            raise ValueError(
                f"unknown prediction_type {self.prediction_type!r}")
        d = (x - x0) / float(np.maximum(sigma, _F32(1e-12)))
        prev = x + float(sigma_prev - sigma) * d
        return prev.to(sample.dtype)
