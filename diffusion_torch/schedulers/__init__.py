"""DDPM schedule tables, the DDIM, DPM-Solver++(2M) and Euler samplers,
and the continuous-time VP-SDE scheduler."""

from diffusion_torch.schedulers.continuous import (ContinuousTimeScheduler,
                                                   tangent_schedule)
from diffusion_torch.schedulers.ddim import DDIMScheduler
from diffusion_torch.schedulers.ddpm import DDPMScheduler
from diffusion_torch.schedulers.dpm import (DPMSolverMultistepScheduler,
                                            EulerDiscreteScheduler)

__all__ = ["ContinuousTimeScheduler", "DDIMScheduler", "DDPMScheduler",
           "DPMSolverMultistepScheduler", "EulerDiscreteScheduler",
           "tangent_schedule"]
