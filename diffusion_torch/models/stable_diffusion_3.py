"""StableDiffusion3: the training forward and loss of SD3's MMDiT, or of
FLUX.1's transformer, on precomputed latents and text states, with the
rectified-flow objective.

The model object the Trainer drives, as `StableDiffusion` is for the UNet:
it holds the denoiser under `unet`, the attribute the Trainer, its step
graph and the EMA read, and gives `loss_fn` and `training_draws` with
`StableDiffusion`'s signatures. A batch holds
`image_latents` (B, H/8, W/8, 16) NHWC, `caption_latents` (B, T, 4,096)
(SD3's CLIP-L/G and T5 states, concatenated; FLUX's T5 states) and
`pooled_caption_latents` (B, 2,048; FLUX: CLIP-L's 768). Towers are not
part of it: the batch is precomputed, and generation and the eval loop are
not ported.

The two networks differ here in two fields: `shift`, SD3's fixed 3.0 or
None for FLUX's dynamic shift at the packed image length
(`flow_match.dynamic_shift`), and `guidance`, None for SD3, or the
guidance FLUX's embedding sees for every sample (3.5 by default, as
diffusers' FLUX fine-tuning scripts give it).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from diffusion_torch.models.mmdit import MMDiT
from diffusion_torch.models.stable_diffusion import _draw
from diffusion_torch.schedulers import flow_match

__all__ = ["StableDiffusion3", "POOLED"]

_LATENTS, _CAPTIONS = "image_latents", "caption_latents"
POOLED = "pooled_caption_latents"


@dataclasses.dataclass
class StableDiffusion3:
    unet: MMDiT
    shift: Optional[float] = flow_match.SHIFT
    guidance: Optional[float] = None
    # read by the Trainer's step graph: every batch is precomputed
    precomputed_latents = True

    @property
    def device(self) -> torch.device:
        return next(self.unet.parameters()).device

    def timestep_shift(self, shape: Sequence[int]) -> float:
        """The shift of t for latents of `shape` (B, h, w, C)."""
        if self.shift is not None:
            return self.shift
        return flow_match.dynamic_shift((shape[1] // 2) * (shape[2] // 2))

    def training_draws(self, shape: Sequence[int],
                       generator: Optional[torch.Generator] = None,
                       timesteps: Optional[torch.Tensor] = None,
                       noise: Optional[torch.Tensor] = None,
                       examples: Optional[Tuple[int, int]] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(t, noise) for latents of `shape` (B, h, w, C): t in (0, 1), then
        the noise, each from `generator` unless given; with `examples`,
        drawn for the whole batch and sliced."""
        device = self.device
        if timesteps is None:
            shift = self.timestep_shift(shape)
            timesteps = _draw((shape[0],), lambda shp: flow_match
                              .sample_timesteps(shp[0], generator, device,
                                                shift), examples)
        if noise is None:
            noise = _draw(shape, lambda shp: torch.randn(
                shp, generator=generator, device=device,
                dtype=torch.float32), examples)
        return timesteps, noise

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None,
                timesteps: Optional[torch.Tensor] = None,
                latent_noise: Optional[torch.Tensor] = None,
                examples: Optional[Tuple[int, int]] = None,
                dropout_key: Optional[Tuple[int, ...]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """-> (predicted velocity, target velocity, t), the first two fp32
        (B, H/8, W/8, 16). `latent_noise` and `dropout_key` are taken for
        the Trainer's signature and unused (no towers, no dropout)."""
        if _LATENTS not in batch:
            raise ValueError("SD3 trains on precomputed latents: the batch "
                             "needs image_latents, caption_latents and "
                             f"{POOLED}")
        device = self.device
        latents = batch[_LATENTS].to(device, torch.float32)
        t, noise = self.training_draws(latents.shape, generator, timesteps,
                                       noise, examples)
        t = t.to(device, torch.float32)
        noise = noise.to(device, torch.float32)
        noised = flow_match.add_noise(latents, noise, t)
        guidance = () if self.guidance is None else (torch.full_like(
            t, self.guidance * flow_match.NUM_TRAIN_TIMESTEPS),)
        # NHWC memory viewed as NCHW: channels_last, no copy
        pred = self.unet(noised.permute(0, 3, 1, 2),
                         t * flow_match.NUM_TRAIN_TIMESTEPS,
                         batch[_CAPTIONS].to(device),
                         batch[POOLED].to(device), *guidance
                         ).permute(0, 2, 3, 1)
        return pred, flow_match.velocity(latents, noise), t

    def loss(self, outputs: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        """MSE(predicted, target velocity) in fp32."""
        return torch.square(outputs[0].float() - outputs[1].float()).mean()

    def loss_fn(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None,
                timesteps: Optional[torch.Tensor] = None,
                latent_noise: Optional[torch.Tensor] = None,
                **kwargs: Any) -> torch.Tensor:
        return self.loss(self.forward(batch, generator, noise, timesteps,
                                      latent_noise, **kwargs))

    def example_batch(self, batch: int, size: int, text_tokens: int = 154,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, torch.Tensor]:
        """A batch of N(0, 1) latents, text states and pooled text for
        `size` px images, on the model's device."""
        cfg, device = self.unet.config, self.device
        side = size // 8

        def draw(*shape):
            return torch.randn(shape, generator=generator, device=device)
        channels = getattr(self.unet, "latent_channels", cfg.in_channels)
        return {_LATENTS: draw(batch, side, side, channels),
                _CAPTIONS: draw(batch, text_tokens, cfg.joint_attention_dim),
                POOLED: draw(batch, cfg.pooled_projection_dim)}
