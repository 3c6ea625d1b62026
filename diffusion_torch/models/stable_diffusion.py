"""StableDiffusion: the training forward and loss on precomputed latents,
and text-to-image generation (CLIP text -> CFG DDIM loop over the UNet ->
VAE decode).

Counterpart of `diffusion_tpu/models/stable_diffusion.py`. The modules own
their weights, so no param trees are passed around; the denoise loop is a
Python loop in place of `lax.scan`; timesteps and noise come from an
explicit `torch.Generator`, or are passed in (`forward(noise=,
timesteps=)`), so a test can hand both packages the same draws.

Public layouts match JAX: the batch's `image_latents` are (B, H/8, W/8, 4)
and `caption_latents` (B, 77, D); `forward` returns the prediction and
target in that NHWC layout; `generate` takes latents (B, H/8, W/8, 4) and
returns images (B, H, W, 3) in [0, 1]. Inside, latents are NCHW views of
the same memory (channels_last).

Not ported yet (each raises NotImplementedError naming its ROADMAP.md
item): raw-image training batches (the VAE encoder), img2img and
inpainting, guidance rescale.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from diffusion_torch.models.clip import CLIPTextModel
from diffusion_torch.models.unet import UNet2DCondition
from diffusion_torch.models.vae import AutoencoderKL
from diffusion_torch.schedulers import DDIMScheduler, DDPMScheduler

__all__ = ["StableDiffusion"]

# the JAX batch contract's keys for precomputed VAE and CLIP latents
_LATENTS, _CAPTIONS = "image_latents", "caption_latents"
_ENCODER = ("VAE encoding of raw-image batches comes with ROADMAP.md queue 1 "
            "item 6 (VAE encoder, img2img and inpainting)")
_IMG2IMG = ("img2img and inpainting come with ROADMAP.md queue 1 item 6 "
            "(VAE encoder, img2img and inpainting)")
_RESCALE = ("guidance_rescale > 0 comes with ROADMAP.md queue 1 item 7 "
            "(DPM++/Euler samplers and guidance rescale)")


@dataclasses.dataclass
class StableDiffusion:
    unet: UNet2DCondition
    # None when the builder skipped the frozen towers (init_frozen_towers)
    vae: Optional[AutoencoderKL]
    text_encoder: Optional[CLIPTextModel]
    tokenizer: Any
    inference_scheduler: DDIMScheduler
    noise_scheduler: DDPMScheduler = dataclasses.field(
        default_factory=DDPMScheduler)
    prediction_type: str = "epsilon"
    # min-SNR loss weighting (arXiv:2303.09556); None = plain MSE
    min_snr_gamma: Optional[float] = None
    latent_scale: float = 0.18215
    precomputed_latents: bool = False
    val_seed: int = 1138
    # eval loss bins: [lo, hi) fractions of the training timesteps
    loss_bins: Tuple[Tuple[float, float], ...] = ((0, 1),)
    train_metric_names: Tuple[str, ...] = ("MeanSquaredError",)
    val_metric_names: Tuple[str, ...] = ("MeanSquaredError",)
    # recorded for the trainer, as the JAX package records it; sharding
    # comes with multi-device training (ROADMAP.md queue 1 item 9)
    fsdp: bool = True

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

    # ---------------- training ----------------
    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None,
                timesteps: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Diffusion forward pass -> (prediction, target, timesteps), the
        first two fp32 (B, H/8, W/8, 4). Timesteps, then noise, are drawn
        from `generator` unless given."""
        if not (self.precomputed_latents and _LATENTS in batch):
            raise NotImplementedError(_ENCODER)
        device = self.device
        latents = batch[_LATENTS].to(device, torch.float32)
        conditioning = batch[_CAPTIONS].to(device, torch.float32)
        bsz = latents.shape[0]
        if timesteps is None:
            timesteps = torch.randint(
                0, self.noise_scheduler.num_train_timesteps, (bsz,),
                generator=generator, device=device)
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator,
                                device=device, dtype=torch.float32)
        timesteps = timesteps.to(device)
        noise = noise.to(device, torch.float32)
        noised = self.noise_scheduler.add_noise(latents, noise, timesteps)
        # NHWC memory viewed as NCHW: channels_last, no copy
        pred = self.unet(noised.permute(0, 3, 1, 2), timesteps,
                         conditioning).permute(0, 2, 3, 1)
        if self.prediction_type == "epsilon":
            target = noise
        elif self.prediction_type == "sample":
            target = latents
        elif self.prediction_type == "v_prediction":
            target = self.noise_scheduler.get_velocity(latents, noise,
                                                       timesteps)
        else:
            raise ValueError(
                f"unknown prediction_type {self.prediction_type!r}")
        return pred, target, timesteps

    def loss(self, outputs: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        """MSE(pred, target) in fp32, optionally min-SNR weighted per
        sample: epsilon min(SNR, g)/SNR, v min(SNR, g)/(SNR+1), sample
        min(SNR, g)."""
        pred, target = outputs[0], outputs[1]
        se = torch.square(pred.float() - target.float())
        if self.min_snr_gamma is None:
            return se.mean()
        t = outputs[2]
        abar = self.noise_scheduler.alphas_cumprod.to(t.device)[t]
        snr = abar / torch.clamp(1.0 - abar, min=1e-12)
        g = float(self.min_snr_gamma)
        if self.prediction_type == "epsilon":
            w = torch.clamp(snr, max=g) / snr
        elif self.prediction_type == "v_prediction":
            w = torch.clamp(snr, max=g) / (snr + 1.0)
        elif self.prediction_type == "sample":
            w = torch.clamp(snr, max=g)
        else:
            raise ValueError(
                f"unknown prediction_type {self.prediction_type!r}")
        per_sample = se.mean(dim=tuple(range(1, se.ndim)))
        return (w * per_sample).mean()

    def loss_fn(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None,
                timesteps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Scalar training loss; the function the trainer backpropagates."""
        return self.loss(self.forward(batch, generator, noise, timesteps))

    # ---------------- generation ----------------
    def _towers(self) -> None:
        if self.vae is None or self.text_encoder is None:
            raise RuntimeError(
                "generation needs the VAE and CLIP towers, which this model "
                "was built without (init_frozen_towers resolved False: "
                "precomputed_latents=True)")

    def encode_text(self, input_ids: torch.Tensor) -> torch.Tensor:
        self._towers()
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
        self._towers()
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
