"""PixelDiffusion: diffusion in pixel space, discrete or continuous time.

Counterpart of `diffusion_tpu/models/pixel_diffusion.py`: the prediction
type (`sample`, `epsilon`, `v_prediction`) picks the target (the images,
the noise, the velocity); `continuous_time` draws t ~ U(0, t_max) in fp32
where discrete time draws integer t; `generate` runs classifier-free
guidance over DDIM or the continuous-time SDE/ODE and returns images
clipped to [0, 1] (there is no VAE); the eval generates with `val_seed`.

`forward(batch, generator, noise, timesteps)` has `StableDiffusion.
forward`'s signature, so the Trainer's draws (`noise_hook`) and `fit()`
take it as they take SD2. Every draw comes from an explicit
`torch.Generator` or is handed over: `forward(noise=, timesteps=)`,
`generate(latents=, sde_noise=)` (the SDE's per-step noise), so a test
can give both packages the same draws. Layouts are the JAX ones: images
(B, H, W, 3), prediction and target (B, H, W, 3), latents (B, H, W, 3);
inside, NCHW views of the same memory (channels_last).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from diffusion_torch.models.clip import CLIPTextModel
from diffusion_torch.models.unet import UNet2DCondition
from diffusion_torch.schedulers import ContinuousTimeScheduler

__all__ = ["PixelDiffusion"]


@dataclasses.dataclass
class PixelDiffusion:
    unet: UNet2DCondition
    text_encoder: CLIPTextModel
    tokenizer: Any
    noise_scheduler: Any            # DDPMScheduler or ContinuousTimeScheduler
    inference_scheduler: Any        # DDIMScheduler or ContinuousTimeScheduler
    prediction_type: str = "epsilon"
    continuous_time: bool = False
    image_key: str = "image"
    caption_key: str = "captions"
    val_seed: int = 1138
    val_guidance_scales: Tuple[float, ...] = ()

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    def encode_text(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.text_encoder(input_ids.to(self.device))[0]

    # ---------------- training ----------------
    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None,
                timesteps: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """-> (prediction, target, timesteps), the first two fp32 (B, H, W,
        3). Timesteps, then noise, are drawn from `generator` unless
        given."""
        device = self.device
        inputs = batch[self.image_key].to(device, torch.float32)
        with torch.no_grad():
            conditioning = self.encode_text(batch[self.caption_key])
        bsz = inputs.shape[0]
        if timesteps is None:
            if self.continuous_time:
                timesteps = torch.rand((bsz,), generator=generator,
                                       device=device) * \
                    self.noise_scheduler.t_max
            else:
                timesteps = torch.randint(
                    0, self.noise_scheduler.num_train_timesteps, (bsz,),
                    generator=generator, device=device)
        if noise is None:
            noise = torch.randn(inputs.shape, generator=generator,
                                device=device, dtype=torch.float32)
        timesteps = timesteps.to(device)
        noise = noise.to(device, torch.float32)
        noised = self.noise_scheduler.add_noise(inputs, noise, timesteps)
        # NHWC memory viewed as NCHW: channels_last, no copy
        pred = self.unet(noised.permute(0, 3, 1, 2), timesteps,
                         conditioning).permute(0, 2, 3, 1)
        if self.prediction_type == "sample":
            target = inputs
        elif self.prediction_type == "epsilon":
            target = noise
        elif self.prediction_type == "v_prediction":
            target = self.noise_scheduler.get_velocity(inputs, noise,
                                                       timesteps)
        else:
            raise ValueError(
                f"unknown prediction_type {self.prediction_type!r}")
        return pred, target, timesteps

    @staticmethod
    def loss(outputs: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        pred, target = outputs[0], outputs[1]
        return torch.square(pred.float() - target.float()).mean()

    def loss_fn(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None,
                timesteps: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.loss(self.forward(batch, generator, noise, timesteps))

    # ---------------- generation ----------------
    def embed_prompts(self, prompt_ids: torch.Tensor,
                      negative_ids: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """(uncond, cond) embeddings stacked into the 2x CFG batch; the
        unconditional row is the empty prompt (BOS, EOS, padding)."""
        if negative_ids is None:
            negative_ids = torch.full(
                prompt_ids.shape, getattr(self.tokenizer, "pad_token_id", 0),
                dtype=torch.int64, device=self.device)
            negative_ids[:, 0] = getattr(self.tokenizer, "bos_token_id", 0)
            negative_ids[:, 1] = getattr(self.tokenizer, "eos_token_id", 0)
        cond = self.encode_text(prompt_ids)
        uncond = self.encode_text(negative_ids)
        return torch.cat([uncond, cond], dim=0)

    @torch.inference_mode()
    def generate(self, prompt_ids: torch.Tensor,
                 negative_ids: Optional[torch.Tensor] = None,
                 height: int = 64, width: int = 64,
                 guidance_scale: float = 3.0, num_inference_steps: int = 50,
                 seed: Optional[int] = None,
                 latents: Optional[torch.Tensor] = None,
                 sde_noise: Optional[Sequence[torch.Tensor]] = None
                 ) -> torch.Tensor:
        """Text -> images (B, H, W, 3) in [0, 1]. The initial noise is
        `latents` (B, H, W, 3) when given, else drawn from a generator
        seeded with `seed` (`val_seed` by default); the SDE sampler's noise
        of step i is `sde_noise[i]` when given, else that generator's next
        draw."""
        device = self.device
        sched = self.inference_scheduler
        is_sde = isinstance(sched, ContinuousTimeScheduler) and \
            not sched.use_ode
        bsz = prompt_ids.shape[0]
        embeddings = self.embed_prompts(prompt_ids.to(device), negative_ids)
        shape = (bsz, height, width, self.unet.config.out_channels)
        generator = torch.Generator(device=device).manual_seed(
            self.val_seed if seed is None else seed)
        if latents is None:
            latents = torch.randn(shape, generator=generator, device=device,
                                  dtype=torch.float32)
        elif tuple(latents.shape) != shape:
            raise ValueError(f"latents {tuple(latents.shape)} != {shape}")
        lat = latents.to(device, torch.float32).permute(0, 3, 1, 2) * \
            sched.init_noise_sigma
        ts, tps = sched.timesteps(num_inference_steps)
        ts_dev = torch.as_tensor(ts, device=device)
        if not self.continuous_time:
            ts_dev = ts_dev.long()
        for i, (t, tp) in enumerate(zip(ts, tps)):
            model_in = sched.scale_model_input(torch.cat([lat, lat]), t)
            tt = ts_dev[i].expand(model_in.shape[0])
            uncond, cond = self.unet(model_in, tt, embeddings).chunk(2)
            pred = uncond + guidance_scale * (cond - uncond)
            if is_sde:
                if sde_noise is not None:
                    noise = sde_noise[i].to(device).permute(0, 3, 1, 2)
                else:
                    noise = torch.randn(shape, generator=generator,
                                        device=device).permute(0, 3, 1, 2)
                lat = sched.step(pred, t, tp, lat, noise=noise)
            elif self.continuous_time:
                lat = sched.step(pred, t, tp, lat)
            else:
                lat = sched.step(pred, int(t), int(tp), lat)
        return (lat * 0.5 + 0.5).clamp(0.0, 1.0).permute(0, 2, 3, 1)

    @torch.no_grad()
    def eval_forward(self, batch: Dict[str, torch.Tensor],
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None,
                     timesteps: Optional[torch.Tensor] = None,
                     num_inference_steps: int = 50,
                     height: int = 64, width: int = 64) -> Dict[str, Any]:
        """The eval's forward (draws from a `val_seed` generator unless
        given) and, for each of `val_guidance_scales`, a batch generated
        with `val_seed`."""
        if generator is None and (noise is None or timesteps is None):
            generator = torch.Generator(device=self.device).manual_seed(
                self.val_seed)
        pred, target, t = self.forward(batch, generator, noise, timesteps)
        generated = {
            float(g): self.generate(
                batch[self.caption_key], height=height, width=width,
                guidance_scale=float(g),
                num_inference_steps=num_inference_steps, seed=self.val_seed)
            for g in self.val_guidance_scales}
        return {"pred": pred, "target": target, "timesteps": t,
                "generated": generated}
