"""StableDiffusion: the training forward and loss (on precomputed latents,
or on raw images encoded by the frozen VAE and CLIP towers), and
generation: text-to-image, img2img (SDEdit) and inpainting (CLIP text ->
CFG loop over the UNet with the model's sampler, DDIM, DPM-Solver++(2M) or
Euler, optionally with guidance rescale -> VAE decode).

Counterpart of `diffusion_tpu/models/stable_diffusion.py`. The modules own
their weights, so no param trees are passed around; the denoise loop is a
Python loop in place of `lax.scan`; every draw (the posterior's eps, the
timesteps, the noise, img2img's noise) comes from an explicit
`torch.Generator`, or is passed in (`forward(noise=, timesteps=,
latent_noise=)`, `generate(latents=, latent_noise=)`), so a test can hand
both packages the same draws.

Public layouts match JAX: the batch's `image` is (B, H, W, 3),
`captions` (B, 77) token ids, `image_latents` (B, H/8, W/8, 4) and
`caption_latents` (B, 77, D); `forward` returns the prediction and target
in the latents' NHWC layout; `generate` takes latents and noise
(B, H/8, W/8, 4), images (B, H, W, 3) in [0, 1] and masks (B, H, W[, 1])
or (B, H/8, W/8[, 1]), and returns images (B, H, W, 3) in [0, 1]. Inside,
latents are NCHW views of the same memory (channels_last).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from diffusion_torch.models.clip import CLIPTextModel
from diffusion_torch.models.unet import UNet2DCondition
from diffusion_torch.models.vae import AutoencoderKL
from diffusion_torch.schedulers import DDPMScheduler

__all__ = ["StableDiffusion"]

# the JAX batch contract's keys: raw images and token ids, or precomputed
# VAE and CLIP latents
_IMAGE, _IDS = "image", "captions"
_LATENTS, _CAPTIONS = "image_latents", "caption_latents"


@dataclasses.dataclass
class StableDiffusion:
    unet: UNet2DCondition
    # None when the builder skipped the frozen towers (init_frozen_towers)
    vae: Optional[AutoencoderKL]
    text_encoder: Optional[CLIPTextModel]
    tokenizer: Any
    # any sampler of the schedulers' protocol: DDIM, or DPM-Solver++(2M)
    # (multistep: it has init_state / step_with_state) or Euler
    inference_scheduler: Any
    noise_scheduler: DDPMScheduler = dataclasses.field(
        default_factory=DDPMScheduler)
    prediction_type: str = "epsilon"
    # min-SNR loss weighting (arXiv:2303.09556); None = plain MSE
    min_snr_gamma: Optional[float] = None
    latent_scale: float = 0.18215
    precomputed_latents: bool = False
    val_seed: int = 1138
    # the eval's generation metrics: one image batch per scale
    val_guidance_scales: Tuple[float, ...] = ()
    # eval loss bins: [lo, hi) fractions of the training timesteps
    loss_bins: Tuple[Tuple[float, float], ...] = ((0, 1),)
    train_metric_names: Tuple[str, ...] = ("MeanSquaredError",)
    val_metric_names: Tuple[str, ...] = ("MeanSquaredError",)
    # recorded for the trainer, as the JAX package records it: its default
    # mesh shards over fsdp where this is true (`Trainer._setup_mesh`)
    fsdp: bool = True
    # the local diffusers directory the builder loaded (pretrained=True)
    pretrained_path: Optional[str] = None
    # the generation metrics' towers (.npz files of tools/port_weights.py,
    # local or s3:// gs://); random towers only when allowed
    inception_weights: Optional[str] = None
    clip_metric_weights: Optional[str] = None
    allow_random_tower_weights: bool = False
    # LoRA fine-tuning (models/lora.py): only the UNet's adapters require
    # grad, so the Trainer trains, EMAs and checkpoints them alone
    train_lora_only: bool = False

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
    @torch.no_grad()
    def encode_images(self, images: torch.Tensor,
                      latent_noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
        """Images (B, H, W, 3), in [-1, 1] by the batch contract, -> scaled
        latents (B, H/8, W/8, 4) fp32: a posterior sample times
        `latent_scale`. The sample's eps (the latents' shape) is drawn from
        `generator` unless given. No autograd graph: the towers are
        frozen, and the encoder's activations are not kept."""
        if self.vae is None:
            raise RuntimeError(
                "batch carries raw images but the frozen VAE/CLIP towers "
                "were not initialized (init_frozen_towers resolved False — "
                "precomputed_latents=True with no guidance scales). Either "
                "feed precomputed-latent batches to every dataloader "
                "(including eval) or set init_frozen_towers=True.")
        device = self.device
        posterior = self.vae.encode(
            images.to(device, non_blocking=True).permute(0, 3, 1, 2))
        b, c, h, w = posterior.mean.shape
        if latent_noise is None:
            latent_noise = torch.randn((b, h, w, c), generator=generator,
                                       device=device, dtype=torch.float32)
        eps = latent_noise.to(device, torch.float32).permute(0, 3, 1, 2)
        latents = posterior.sample(eps) * self.latent_scale
        return latents.permute(0, 2, 3, 1).contiguous()

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None,
                timesteps: Optional[torch.Tensor] = None,
                latent_noise: Optional[torch.Tensor] = None,
                examples: Optional[Tuple[int, int]] = None,
                dropout_key: Optional[Tuple[int, ...]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Diffusion forward pass -> (prediction, target, timesteps), the
        first two fp32 (B, H/8, W/8, 4). A batch of precomputed latents
        (on a `precomputed_latents` model) is used as it is; otherwise its
        `image` and `captions` are encoded by the frozen VAE and CLIP
        towers. The posterior's eps (raw batches only), then timesteps,
        then noise are drawn from `generator` unless given; with
        `examples=(offset, total)` the batch is rows offset.. of a
        `total`-example batch, whose draws are made whole and sliced (a
        rank of a process mesh). Where the UNet drops (training mode,
        dropout > 0), the masks are keyed by `dropout_key` or by an integer
        drawn after the noise. Under sequence parallelism the
        prediction and target are this rank's rows."""
        device = self.device

        def draw(shape, fn):
            if examples is None:
                return fn(tuple(shape))
            offset, total = examples
            return fn((total, *shape[1:]))[offset:offset + shape[0]]

        if self.precomputed_latents and _LATENTS in batch:
            latents = batch[_LATENTS].to(device, torch.float32)
            conditioning = batch[_CAPTIONS].to(device, torch.float32)
        else:
            if latent_noise is None and examples is not None:
                b, h, w = batch[_IMAGE].shape[:3]
                latent_noise = draw(
                    (b, h // 8, w // 8, self.unet.config.in_channels),
                    lambda shp: torch.randn(shp, generator=generator,
                                            device=device))
            latents = self.encode_images(batch[_IMAGE], latent_noise,
                                         generator)
            with torch.no_grad():
                conditioning = self.encode_text(batch[_IDS])
        bsz = latents.shape[0]
        if timesteps is None:
            timesteps = draw((bsz,), lambda shp: torch.randint(
                0, self.noise_scheduler.num_train_timesteps, shp,
                generator=generator, device=device))
        if noise is None:
            noise = draw(latents.shape, lambda shp: torch.randn(
                shp, generator=generator, device=device,
                dtype=torch.float32))
        timesteps = timesteps.to(device)
        noise = noise.to(device, torch.float32)
        if not self.unet.drops:
            dropout_key = None
        elif dropout_key is None:
            dropout_key = (int(torch.randint(
                0, 2 ** 62, (1,), generator=generator, device=device)),)
        noised = self.noise_scheduler.add_noise(latents, noise, timesteps)
        # NHWC memory viewed as NCHW: channels_last, no copy
        pred = self.unet(noised.permute(0, 3, 1, 2), timesteps,
                         conditioning, dropout_key).permute(0, 2, 3, 1)
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
        if pred.shape[1] != target.shape[1]:
            # the UNet returned this rank's rows of a split image
            from diffusion_torch.ops.attention import active_shard
            from diffusion_torch.parallel.sharding import take_rows
            target = take_rows(target, active_shard(), dim=1)
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
                timesteps: Optional[torch.Tensor] = None,
                latent_noise: Optional[torch.Tensor] = None,
                **kwargs: Any) -> torch.Tensor:
        """Scalar training loss; the function the trainer backpropagates
        (`forward`'s keywords pass through)."""
        return self.loss(self.forward(batch, generator, noise, timesteps,
                                      latent_noise, **kwargs))

    @torch.no_grad()
    def eval_forward(self, batch: Dict[str, torch.Tensor],
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None,
                     timesteps: Optional[torch.Tensor] = None,
                     latent_noise: Optional[torch.Tensor] = None,
                     **kwargs: Any) -> Dict[str, Any]:
        """The eval loop's forward: prediction, target and timesteps for
        the MSE; `generated` stays empty (the eval's images per val
        guidance scale come from `metrics.generation_metrics`'
        `GenerationMetricsHook`)."""
        pred, target, t = self.forward(batch, generator, noise, timesteps,
                                       latent_noise, **kwargs)
        return {"pred": pred, "target": target, "timesteps": t,
                "generated": {}}

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
                     num_inference_steps: int, t_start: int = 0,
                     inpaint: Optional[Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]] = None,
                     guidance_rescale: float = 0.0) -> torch.Tensor:
        """CFG loop over NCHW latents with the model's sampler (one UNet
        call on the 2x batch per step), from grid entry `t_start` on
        (img2img enters mid-way, with latents noised to that entry's
        timestep). A multistep sampler (one with `init_state`) carries its
        state from step to step.

        `guidance_rescale` > 0 rescales the CFG prediction toward the
        conditional branch's standard deviation (Lin et al. 2023,
        arXiv:2305.08891 section 3.4), with the population std (ddof 0,
        as `jnp.std`).

        `inpaint = (lat0, mask, noise)` (NCHW; mask (B, 1, h, w), 1 =
        regenerate): after every step the region where mask is 0 is
        replaced by the clean latents `lat0` noised to the step's
        destination timestep in the sampler's own space (`noise_to`), and
        by `lat0` itself after the last step."""
        sched = self.inference_scheduler
        ts, tps = sched.timesteps(num_inference_steps)
        ts, tps = ts[t_start:], tps[t_start:]
        state = (sched.init_state(latents) if hasattr(sched, "init_state")
                 else None)
        for i, (t, tp) in enumerate(zip(ts, tps)):
            model_in = sched.scale_model_input(
                torch.cat([latents, latents], dim=0), t)
            tt = torch.full((model_in.shape[0],), int(t), dtype=torch.int64,
                            device=latents.device)
            uncond, cond = self.unet(model_in, tt, text_embeddings).chunk(2)
            pred = uncond + guidance_scale * (cond - uncond)
            if guidance_rescale > 0.0:
                dims = tuple(range(1, pred.ndim))
                std_cond = cond.std(dim=dims, keepdim=True, correction=0)
                std_cfg = pred.std(dim=dims, keepdim=True,
                                   correction=0).clamp(min=1e-12)
                pred = (guidance_rescale * (pred * std_cond / std_cfg)
                        + (1.0 - guidance_rescale) * pred)
            if state is None:
                latents = sched.step(pred, int(t), int(tp), latents)
            else:
                latents, state = sched.step_with_state(
                    pred, int(t), int(tp), latents, state, i, len(ts))
            if inpaint is not None:
                lat0, mask, ip_noise = inpaint
                keep = (sched.noise_to(lat0, ip_noise, int(tp)) if tp >= 0
                        else lat0)
                latents = mask * latents + (1.0 - mask) * keep
        return latents

    def _latent_mask(self, mask: torch.Tensor, lh: int, lw: int
                     ) -> torch.Tensor:
        """A mask (B, H, W), (B, H, W, 1) or at latent resolution
        (B, h, w[, 1]) -> fp32 (B, 1, h, w); an image-resolution mask is
        8x8 average-pooled (soft edges blend)."""
        m = mask.to(self.device, torch.float32)
        if m.ndim == 3:
            m = m[..., None]
        if m.shape[1] != lh or m.shape[2] != lw:
            if m.shape[1] % lh or m.shape[2] % lw:
                raise ValueError(
                    f"mask spatial dims {tuple(m.shape[1:3])} are neither "
                    f"latent-resolution ({lh}, {lw}) nor an integer "
                    f"multiple of it")
            fh, fw = m.shape[1] // lh, m.shape[2] // lw
            m = m.reshape(m.shape[0], lh, fh, lw, fw, 1).mean(dim=(2, 4))
        return m.permute(0, 3, 1, 2)

    @torch.inference_mode()
    def generate(self, prompt_ids: torch.Tensor,
                 negative_ids: Optional[torch.Tensor] = None,
                 height: int = 256, width: int = 256,
                 guidance_scale: float = 3.0, num_inference_steps: int = 50,
                 num_images_per_prompt: int = 1,
                 seed: Optional[int] = None,
                 latents: Optional[torch.Tensor] = None,
                 image: Optional[torch.Tensor] = None,
                 strength: float = 0.8,
                 mask: Optional[torch.Tensor] = None,
                 latent_noise: Optional[torch.Tensor] = None,
                 guidance_rescale: float = 0.0) -> torch.Tensor:
        """Text -> images (B, H, W, 3) in [0, 1]. The noise is `latents`
        (B * num_images_per_prompt, H/8, W/8, 4) when given, else drawn
        from a `torch.Generator` seeded with `seed` (`val_seed` by
        default).

        img2img (SDEdit): `image` (B, H, W, 3) in [0, 1] and `strength` in
        (0, 1]. The image is encoded (the posterior's eps is `latent_noise`
        (B, H/8, W/8, 4), else the generator's first draw), noised to grid
        entry `steps - int(steps * strength)` with the noise, and only the
        rest of the loop runs; when `int(steps * strength)` is 0 the output
        is the VAE reconstruction. Inpainting: also `mask` in [0, 1] (1 =
        regenerate, 0 = keep), at image or latent resolution (see
        `denoise_loop`). `guidance_rescale` (0 = off) is Lin et al. 2023's
        CFG std rescale (about 0.7 with zero-terminal-SNR v-prediction
        models)."""
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

        sched = self.inference_scheduler
        lat_shape = (bsz, height // 8, width // 8,
                     self.vae.config.latent_channels)
        if mask is not None and image is None:
            raise ValueError("mask (inpainting) requires an init image")
        if image is not None and not 0.0 < strength <= 1.0:
            raise ValueError(f"strength must be in (0, 1], got {strength}")
        generator = None
        if latents is None or (image is not None and latent_noise is None):
            generator = torch.Generator(device=device).manual_seed(
                self.val_seed if seed is None else seed)
        lat0 = None
        if image is not None:
            img = image.to(device, torch.float32) * 2.0 - 1.0
            lat0 = self.encode_images(img, latent_noise, generator)
        if latents is None:
            latents = torch.randn(lat_shape, generator=generator,
                                  device=device, dtype=torch.float32)
        elif tuple(latents.shape) != lat_shape:
            raise ValueError(f"latents {tuple(latents.shape)} != {lat_shape}")
        # NHWC memory viewed as NCHW: channels_last, no copy
        noise = latents.to(device, torch.float32).permute(0, 3, 1, 2)
        t_start, inpaint = 0, None
        if lat0 is None:
            # sigma-space samplers (Euler) scale x_T by the inference
            # grid's top sigma, not the full grid's
            lat = noise * (sched.init_sigma(num_inference_steps)
                           if hasattr(sched, "init_sigma")
                           else sched.init_noise_sigma)
        else:
            lat0 = lat0.repeat_interleave(num_images_per_prompt,
                                          dim=0).permute(0, 3, 1, 2)
            # diffusers' Img2Img: keep the last init_timestep grid entries
            init_timestep = min(int(num_inference_steps * strength),
                                num_inference_steps)
            t_start = num_inference_steps - init_timestep
            if init_timestep == 0:
                lat = lat0     # nothing to denoise: the reconstruction
            else:
                ts, _ = sched.timesteps(num_inference_steps)
                lat = sched.noise_to(lat0, noise, int(ts[t_start]))
            if mask is not None:
                m = self._latent_mask(mask, lat_shape[1], lat_shape[2])
                inpaint = (lat0, m.repeat_interleave(num_images_per_prompt,
                                                     dim=0), noise)
        lat = self.denoise_loop(lat, embeddings, guidance_scale,
                                num_inference_steps, t_start, inpaint,
                                guidance_rescale)
        images = self.vae.decode(lat / self.latent_scale)
        return (images * 0.5 + 0.5).clamp(0.0, 1.0).permute(0, 2, 3, 1)
