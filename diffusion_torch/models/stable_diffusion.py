"""StableDiffusion text-to-image generation: CLIP text -> CFG DDIM loop over
the UNet -> VAE decode.

Counterpart of the generation half of
`diffusion_tpu/models/stable_diffusion.py`. The modules own their weights,
so no param trees are passed around; the denoise loop is a Python loop in
place of `lax.scan`; noise comes from an explicit `torch.Generator`.

Public layouts match JAX: `latents` in and out are (B, H/8, W/8, 4) and
`generate` returns images (B, H, W, 3) in [0, 1]. Inside, latents are NCHW
views of that same memory (channels_last).

Not ported yet: img2img and inpainting and guidance rescale (each raises
NotImplementedError naming its ROADMAP.md item), precomputed prompt
embeddings, latent output, and the training forward.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from diffusion_torch.models.clip import CLIPTextModel
from diffusion_torch.models.unet import UNet2DCondition
from diffusion_torch.models.vae import AutoencoderKL
from diffusion_torch.schedulers import DDIMScheduler

__all__ = ["StableDiffusion"]

_IMG2IMG = ("img2img and inpainting come with ROADMAP.md queue 1 item 4 "
            "(VAE encoder, img2img and inpainting)")
_RESCALE = ("guidance_rescale > 0 comes with ROADMAP.md queue 1 item 5 "
            "(DPM++/Euler samplers and guidance rescale)")


@dataclasses.dataclass
class StableDiffusion:
    unet: UNet2DCondition
    vae: AutoencoderKL
    text_encoder: CLIPTextModel
    tokenizer: Any
    inference_scheduler: DDIMScheduler
    latent_scale: float = 0.18215
    val_seed: int = 1138

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    def _empty_prompt_ids(self, batch: int, length: int) -> torch.Tensor:
        """Ids of the empty prompt: BOS, EOS, then padding (the CFG
        unconditional row when no negative prompt is given)."""
        pad = getattr(self.tokenizer, "pad_token_id", 0)
        bos = getattr(self.tokenizer, "bos_token_id", 0)
        eos = getattr(self.tokenizer, "eos_token_id", 0)
        ids = torch.full((batch, length), pad, dtype=torch.int64,
                         device=self.device)
        ids[:, 0] = bos
        ids[:, 1] = eos
        return ids

    def encode_text(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.text_encoder(input_ids.to(self.device))[0]

    def embed_prompts(self, prompt_ids: torch.Tensor,
                      negative_ids: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """(uncond, cond) embeddings stacked into the 2x CFG batch."""
        if negative_ids is None:
            negative_ids = self._empty_prompt_ids(*prompt_ids.shape)
        cond = self.encode_text(prompt_ids)
        uncond = self.encode_text(negative_ids)
        return torch.cat([uncond, cond], dim=0)

    def denoise_loop(self, latents: torch.Tensor,
                     text_embeddings: torch.Tensor, guidance_scale: float,
                     num_inference_steps: int) -> torch.Tensor:
        """CFG DDIM loop over NCHW latents (one UNet call on the 2x batch
        per step)."""
        sched = self.inference_scheduler
        for t, tp in zip(*sched.timesteps(num_inference_steps)):
            model_in = sched.scale_model_input(
                torch.cat([latents, latents], dim=0), t)
            tt = torch.full((model_in.shape[0],), int(t), dtype=torch.int64,
                            device=latents.device)
            uncond, cond = self.unet(model_in, tt, text_embeddings).chunk(2)
            pred = uncond + guidance_scale * (cond - uncond)
            latents = sched.step(pred, int(t), int(tp), latents)
        return latents

    @torch.inference_mode()
    def generate(self, prompt_ids: torch.Tensor,
                 negative_ids: Optional[torch.Tensor] = None,
                 height: int = 256, width: int = 256,
                 guidance_scale: float = 3.0, num_inference_steps: int = 50,
                 num_images_per_prompt: int = 1,
                 seed: Optional[int] = None,
                 latents: Optional[torch.Tensor] = None,
                 image: Optional[torch.Tensor] = None,
                 mask: Optional[torch.Tensor] = None,
                 guidance_rescale: float = 0.0) -> torch.Tensor:
        """Text -> images (B, H, W, 3) in [0, 1]. The initial latents are
        `latents` (B, H/8, W/8, 4) when given, else drawn from a
        `torch.Generator` seeded with `seed` (`val_seed` by default)."""
        if image is not None or mask is not None:
            raise NotImplementedError(_IMG2IMG)
        if guidance_rescale > 0.0:
            raise NotImplementedError(_RESCALE)
        device = self.device
        bsz = prompt_ids.shape[0]
        embeddings = self.embed_prompts(prompt_ids, negative_ids)
        if num_images_per_prompt > 1:
            uncond, cond = embeddings.chunk(2)
            embeddings = torch.cat(
                [uncond.repeat_interleave(num_images_per_prompt, dim=0),
                 cond.repeat_interleave(num_images_per_prompt, dim=0)])
            bsz *= num_images_per_prompt

        lat_shape = (bsz, height // 8, width // 8,
                     self.vae.config.latent_channels)
        if latents is None:
            generator = torch.Generator(device=device).manual_seed(
                self.val_seed if seed is None else seed)
            latents = torch.randn(lat_shape, generator=generator,
                                  device=device, dtype=torch.float32)
        elif tuple(latents.shape) != lat_shape:
            raise ValueError(f"latents {tuple(latents.shape)} != {lat_shape}")
        latents = latents.to(device, torch.float32)
        latents = latents * self.inference_scheduler.init_noise_sigma
        # NHWC memory viewed as NCHW: channels_last, no copy
        lat = self.denoise_loop(latents.permute(0, 3, 1, 2), embeddings,
                                guidance_scale, num_inference_steps)
        images = self.vae.decode(lat / self.latent_scale)
        return (images * 0.5 + 0.5).clamp(0.0, 1.0).permute(0, 2, 3, 1)
