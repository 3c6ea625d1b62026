"""DDPM schedule tables and the DDIM sampler."""

from diffusion_torch.schedulers.ddim import DDIMScheduler
from diffusion_torch.schedulers.ddpm import DDPMScheduler

__all__ = ["DDIMScheduler", "DDPMScheduler"]
