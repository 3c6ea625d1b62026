"""DDPM schedule tables and the DDIM, DPM-Solver++(2M) and Euler samplers."""

from diffusion_torch.schedulers.ddim import DDIMScheduler
from diffusion_torch.schedulers.ddpm import DDPMScheduler
from diffusion_torch.schedulers.dpm import (DPMSolverMultistepScheduler,
                                            EulerDiscreteScheduler)

__all__ = ["DDIMScheduler", "DDPMScheduler", "DPMSolverMultistepScheduler",
           "EulerDiscreteScheduler"]
