"""DDPM schedule tables, the DDIM, DPM-Solver++(2M) and Euler samplers,
the continuous-time VP-SDE scheduler, and rectified flow's training draws
(SD3)."""

from diffusion_torch.schedulers.continuous import (ContinuousTimeScheduler,
                                                   tangent_schedule)
from diffusion_torch.schedulers.ddim import DDIMScheduler
from diffusion_torch.schedulers.ddpm import DDPMScheduler
from diffusion_torch.schedulers.dpm import (DPMSolverMultistepScheduler,
                                            EulerDiscreteScheduler)
from diffusion_torch.schedulers import flow_match

__all__ = ["ContinuousTimeScheduler", "DDIMScheduler", "DDPMScheduler",
           "DPMSolverMultistepScheduler", "EulerDiscreteScheduler",
           "flow_match", "tangent_schedule"]
