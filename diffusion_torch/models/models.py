"""Model builders: full-width SD-2-base, the tiny test geometry, the
two pixel-space diffusion models, SD3-medium's MMDiT
(`stable_diffusion_3`) and FLUX.1-dev's transformer (`flux`), which have
no JAX counterpart.

Counterparts of `stable_diffusion_2`, `stable_diffusion_tiny`,
`discrete_pixel_diffusion` and `continuous_pixel_diffusion` in
`diffusion_tpu/models/models.py`, with the JAX builders' keywords, defaults
and meanings as the yamls pass them: `precomputed_latents`,
`encode_latents_in_fp16` (bf16 compute, else fp32), `fsdp` (recorded on the
model, read by the Trainer), `remat` (the full-width builder's),
`val_metrics`, `train_metrics`, `val_seed`, `loss_bins`,
`prediction_type`, `min_snr_gamma`, `rescale_betas_zero_snr`,
`timestep_spacing`, `init_frozen_towers`, `inference_scheduler` (`ddim`,
`dpm++2m` or its alias `dpm`, `euler`), and the generation eval's
`val_guidance_scales`, `inception_weights`, `clip_metric_weights` and
`allow_random_tower_weights`, and LoRA's `lora_rank`, `lora_alpha` and
`train_lora_only` (default: `lora_rank > 0`; only the adapters then
require grad, `models/lora.py`). A builder makes the modules on
`device` (CUDA unless the caller asks for the CPU; it raises where CUDA is
missing) and draws their weights as flax's defaults would
(`init_like_flax_`) from a `torch.Generator` seeded with `seed`. With
`pretrained=True`, `model_name` must be a local directory (the JAX
builders' check); the weights are then read from it over the random ones
(`models/pretrained.py`: the msgpack trio of `tools/port_weights.py` or
the diffusers/transformers safetensors subdirectories). `model_name` is
also where a CLIP tokenizer is read from, when it holds one (`vocab.json`
or a `tokenizer/` subdirectory); otherwise the byte-level tiny tokenizer
is used.

The UNet is trainable (fp32 parameters, `.train()` mode). The frozen VAE
and CLIP towers are `.eval()` without gradients, and are not built when
`init_frozen_towers` resolves False: by the JAX rule, precomputed latents
and no generation eval (a model with `val_guidance_scales` keeps them: its
eval generates images).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Optional, Sequence, Tuple

import torch

from diffusion_torch.models.clip import (CLIPTextConfig, CLIPTextModel,
                                         SD2_TEXT_CONFIG,
                                         VIT_L14_TEXT_CONFIG)
from diffusion_torch.models.flux import FluxConfig, FluxTransformer
from diffusion_torch.models.layers import init_like_flax_
from diffusion_torch.models.lora import freeze_base
from diffusion_torch.models.mmdit import MMDiT, MMDiTConfig
from diffusion_torch.models.pixel_diffusion import PixelDiffusion
from diffusion_torch.models.pretrained import load_pretrained_params
from diffusion_torch.models.stable_diffusion import StableDiffusion
from diffusion_torch.models.stable_diffusion_3 import StableDiffusion3
from diffusion_torch.models.unet import (PIXEL_UNET, SD2_BASE_UNET,
                                         UNet2DCondition, UNetConfig)
from diffusion_torch.models.vae import SD2_VAE, AutoencoderKL, VAEConfig
from diffusion_torch.schedulers import (ContinuousTimeScheduler,
                                        DDIMScheduler, DDPMScheduler,
                                        DPMSolverMultistepScheduler,
                                        EulerDiscreteScheduler)
from diffusion_torch.text.tokenizer import CLIPTokenizer, tiny_tokenizer
from diffusion_torch.utils.device import Device, resolve_device

__all__ = ["stable_diffusion_2", "stable_diffusion_tiny",
           "discrete_pixel_diffusion", "continuous_pixel_diffusion",
           "stable_diffusion_3", "flux", "canonical_scheduler_name"]

# the samplers a yaml's `model.inference_scheduler` (and a request's
# `scheduler`) may name; all share the noise schedule they are built like
_INFERENCE_SCHEDULERS = {
    "ddim": DDIMScheduler,
    "dpm++2m": DPMSolverMultistepScheduler,
    "dpm": DPMSolverMultistepScheduler,
    "euler": EulerDiscreteScheduler,
}


def canonical_scheduler_name(name_or_sched: Any) -> Optional[str]:
    """The canonical sampler name: case-folded, 'dpm' -> 'dpm++2m'. Takes a
    name (an unknown one raises ValueError) or a scheduler (None when it
    is none of the selectable ones)."""
    if not isinstance(name_or_sched, str):
        for name in ("ddim", "dpm++2m", "euler"):
            if type(name_or_sched) is _INFERENCE_SCHEDULERS[name]:
                return name
        return None
    name = name_or_sched.lower()
    if name == "dpm":
        return "dpm++2m"
    if name not in _INFERENCE_SCHEDULERS:
        raise ValueError(
            f"unknown inference_scheduler {name_or_sched!r}; choose from "
            f"{sorted(_INFERENCE_SCHEDULERS)}")
    return name


def _make_inference_scheduler(name: str, like: Any = None):
    """The named sampler; with `like` (a scheduler), built with its betas,
    prediction type, steps offset, zero-SNR flag and spacing, so a
    non-default model keeps the schedule it was trained for."""
    cls = _INFERENCE_SCHEDULERS[canonical_scheduler_name(name)]
    kwargs = {}
    if like is not None:
        for field in ("num_train_timesteps", "beta_start", "beta_end",
                      "beta_schedule", "prediction_type", "steps_offset",
                      "rescale_betas_zero_snr", "timestep_spacing"):
            value = getattr(like, field, None)
            if value is not None:
                kwargs[field] = value
    return cls(**kwargs)


def _pretrained_dir(pretrained: bool, model_name: Optional[str]
                    ) -> Optional[str]:
    """The JAX builders' check: pretrained weights come from a local
    directory (nothing is downloaded)."""
    if not pretrained:
        return None
    if not (model_name and os.path.isdir(model_name)):
        raise FileNotFoundError(
            "pretrained=True requires model_name to be a local checkpoint "
            f"directory (got {model_name!r}; nothing is downloaded)")
    return model_name


def _tokenizer(model_name: Optional[str]):
    if model_name and (
            os.path.exists(os.path.join(model_name, "vocab.json"))
            or os.path.isdir(os.path.join(model_name, "tokenizer"))):
        return CLIPTokenizer.from_pretrained(model_name)
    return tiny_tokenizer()


def _spacing(timestep_spacing: Optional[str],
             rescale_betas_zero_snr: bool) -> str:
    # the zero-terminal-SNR recipe's two halves ship together
    # (arXiv:2305.08891): rescaled schedule + trailing spacing
    if timestep_spacing is not None:
        return timestep_spacing
    return "trailing" if rescale_betas_zero_snr else "leading"


def _with_lora(unet_cfg: UNetConfig, lora_rank: int,
               lora_alpha: Optional[float],
               train_lora_only: Optional[bool]) -> Tuple[UNetConfig, bool]:
    """The UNet config with its adapters, and `train_lora_only` resolved
    (default: adapters only where there are adapters)."""
    if train_lora_only is None:
        train_lora_only = lora_rank > 0
    if lora_rank:
        unet_cfg = dataclasses.replace(unet_cfg, lora_rank=int(lora_rank),
                                       lora_alpha=lora_alpha)
    return unet_cfg, bool(train_lora_only)


def _build(unet_cfg: UNetConfig, vae_cfg: VAEConfig,
           text_cfg: CLIPTextConfig, tokenizer, dtype: torch.dtype,
           device: Device, seed: int, *, precomputed_latents: bool,
           prediction_type: str, min_snr_gamma: Optional[float],
           rescale_betas_zero_snr: bool, timestep_spacing: Optional[str],
           init_frozen_towers: Optional[bool], inference_scheduler: str,
           val_guidance_scales: Optional[Sequence[float]],
           pretrained_path: Optional[str] = None,
           train_lora_only: bool = False, remat: bool = False,
           **fields: Any) -> StableDiffusion:
    device = resolve_device(device)
    val_guidance_scales = tuple(float(g) for g in val_guidance_scales or ())
    if init_frozen_towers is None:
        # the JAX rule: a generation eval needs the VAE and CLIP
        init_frozen_towers = not (precomputed_latents
                                  and not val_guidance_scales)
    spacing = _spacing(timestep_spacing, rescale_betas_zero_snr)
    noise_scheduler = DDPMScheduler(
        prediction_type=prediction_type,
        rescale_betas_zero_snr=rescale_betas_zero_snr,
        timestep_spacing=spacing)
    inference_scheduler = _make_inference_scheduler(inference_scheduler,
                                                    like=noise_scheduler)
    with torch.device(device):
        unet = UNet2DCondition(unet_cfg, dtype=dtype, remat=remat)
        towers = ((AutoencoderKL(vae_cfg, dtype=dtype),
                   CLIPTextModel(text_cfg, dtype=dtype))
                  if init_frozen_towers else (None, None))
    if device.type != "meta":    # shapes only (a FLOP count): nothing to draw
        gen = torch.Generator(device=device).manual_seed(seed)
        for module in (unet, *towers):
            if module is not None:
                init_like_flax_(module, gen)
    unet.train()
    if train_lora_only:
        freeze_base(unet)        # raises where the UNet has no adapter
    for module in towers:
        if module is not None:
            module.eval().requires_grad_(False)
    model = StableDiffusion(unet=unet, vae=towers[0], text_encoder=towers[1],
                            tokenizer=tokenizer,
                            inference_scheduler=inference_scheduler,
                            noise_scheduler=noise_scheduler,
                            prediction_type=prediction_type,
                            min_snr_gamma=min_snr_gamma,
                            precomputed_latents=precomputed_latents,
                            val_guidance_scales=val_guidance_scales,
                            pretrained_path=pretrained_path,
                            train_lora_only=train_lora_only, **fields)
    if pretrained_path:
        load_pretrained_params(model)
    return model


def stable_diffusion_2(model_name: Optional[str] = None,
                       pretrained: bool = False,
                       train_metrics: Optional[List[str]] = None,
                       val_metrics: Optional[List[Any]] = None,
                       val_guidance_scales: Optional[List[float]] = None,
                       val_seed: int = 1138,
                       loss_bins: Optional[List] = None,
                       precomputed_latents: bool = False,
                       encode_latents_in_fp16: bool = True,
                       fsdp: bool = True,
                       remat: bool = False,
                       inception_weights: Optional[str] = None,
                       clip_metric_weights: Optional[str] = None,
                       allow_random_tower_weights: bool = False,
                       init_frozen_towers: Optional[bool] = None,
                       inference_scheduler: str = "ddim",
                       min_snr_gamma: Optional[float] = None,
                       prediction_type: str = "epsilon",
                       rescale_betas_zero_snr: bool = False,
                       timestep_spacing: Optional[str] = None,
                       lora_rank: int = 0,
                       lora_alpha: Optional[float] = None,
                       train_lora_only: Optional[bool] = None,
                       device: Device = None, seed: int = 0
                       ) -> StableDiffusion:
    """SD-2-base at full width: 866M-parameter UNet, SD2 VAE, 23-layer
    CLIP text tower, computing in bf16 (`encode_latents_in_fp16`, as the JAX
    builder maps it) or fp32. `model_name` is a local diffusers directory:
    the weights with `pretrained=True`, and the tokenizer where it holds
    one. `inception_weights` and `clip_metric_weights` are the metric
    towers' `.npz` files (`metrics/towers.py`); random towers are refused
    unless `allow_random_tower_weights`. `lora_rank > 0` adds LoRA adapters
    to every attention projection and, by default, trains only them (with
    `pretrained=True`, over the directory's base). `remat` rematerializes
    the UNet's blocks in the backward (`models/unet.py`)."""
    pretrained_path = _pretrained_dir(pretrained, model_name)
    unet_cfg, train_lora_only = _with_lora(SD2_BASE_UNET, lora_rank,
                                           lora_alpha, train_lora_only)
    return _build(unet_cfg, SD2_VAE, SD2_TEXT_CONFIG,
                  _tokenizer(model_name),
                  torch.bfloat16 if encode_latents_in_fp16 else torch.float32,
                  device, seed,
                  precomputed_latents=precomputed_latents,
                  prediction_type=prediction_type, min_snr_gamma=min_snr_gamma,
                  rescale_betas_zero_snr=rescale_betas_zero_snr,
                  timestep_spacing=timestep_spacing,
                  init_frozen_towers=init_frozen_towers,
                  inference_scheduler=inference_scheduler,
                  val_guidance_scales=val_guidance_scales,
                  pretrained_path=pretrained_path,
                  train_lora_only=train_lora_only, remat=bool(remat),
                  val_seed=int(val_seed),
                  loss_bins=tuple(tuple(b) for b in (loss_bins or [(0, 1)])),
                  train_metric_names=tuple(train_metrics
                                           or ("MeanSquaredError",)),
                  val_metric_names=tuple(val_metrics or (
                      "MeanSquaredError", "FrechetInceptionDistance")),
                  fsdp=bool(fsdp), inception_weights=inception_weights,
                  clip_metric_weights=clip_metric_weights,
                  allow_random_tower_weights=bool(allow_random_tower_weights))


def stable_diffusion_tiny(val_guidance_scales: Optional[List[float]] = None,
                          precomputed_latents: bool = False,
                          model_name: Optional[str] = None,
                          pretrained: bool = False,
                          val_metrics: Optional[List[Any]] = None,
                          allow_random_tower_weights: bool = False,
                          inference_scheduler: str = "ddim",
                          min_snr_gamma: Optional[float] = None,
                          prediction_type: str = "epsilon",
                          rescale_betas_zero_snr: bool = False,
                          timestep_spacing: Optional[str] = None,
                          init_frozen_towers: Optional[bool] = None,
                          lora_rank: int = 0,
                          lora_alpha: Optional[float] = None,
                          train_lora_only: Optional[bool] = None,
                          remat: bool = False,
                          device: Device = None, seed: int = 0,
                          **_: Any) -> StableDiffusion:
    """The JAX package's tiny geometry (fp32): real architecture, small
    channels, for tests and CPU runs. Like the JAX builder, it ignores
    keywords it does not know (a yaml's `loss_bins`, `fsdp`, ...). It takes
    the same `pretrained`/`model_name` contract as `stable_diffusion_2`
    (the tokenizer stays the tiny one). Unlike JAX's, it takes a yaml's
    `remat`, so a tiny run of `SD-2-base-1024-sp.yaml` rematerializes as
    the full-width one does."""
    pretrained_path = _pretrained_dir(pretrained, model_name)
    unet_cfg, train_lora_only = _with_lora(
        UNetConfig(in_channels=4, out_channels=4, block_out_channels=(32, 64),
                   layers_per_block=1, block_has_attention=(True, False),
                   attention_head_dim=(2, 4), cross_attention_dim=32,
                   norm_num_groups=8),
        lora_rank, lora_alpha, train_lora_only)
    return _build(
        unet_cfg,
        VAEConfig(block_out_channels=(8, 8, 8, 8), layers_per_block=1,
                  norm_num_groups=4),
        CLIPTextConfig(vocab_size=514, hidden_size=32, intermediate_size=64,
                       num_hidden_layers=2, num_attention_heads=2),
        tiny_tokenizer(), torch.float32, device, seed,
        precomputed_latents=precomputed_latents,
        prediction_type=prediction_type, min_snr_gamma=min_snr_gamma,
        rescale_betas_zero_snr=rescale_betas_zero_snr,
        timestep_spacing=timestep_spacing,
        init_frozen_towers=init_frozen_towers,
        inference_scheduler=inference_scheduler,
        val_guidance_scales=val_guidance_scales,
        pretrained_path=pretrained_path, train_lora_only=train_lora_only,
        remat=bool(remat),
        val_metric_names=tuple(val_metrics or ("MeanSquaredError",)),
        allow_random_tower_weights=bool(allow_random_tower_weights))


def _pixel_schedulers(prediction_type: str
                      ) -> Tuple[DDPMScheduler, DDIMScheduler]:
    """The JAX builder's hard-coded pixel schedulers: scaled-linear betas
    0.00085 -> 0.012 over 1000 steps, DDIM with steps offset 1, no sample
    clipping and the last step on alpha-bar[0] (the port's DDIM's fixed
    settings)."""
    return (DDPMScheduler(num_train_timesteps=1000, beta_start=0.00085,
                          beta_end=0.012, beta_schedule="scaled_linear",
                          variance_type="fixed_small",
                          prediction_type=prediction_type),
            DDIMScheduler(num_train_timesteps=1000, beta_start=0.00085,
                          beta_end=0.012, beta_schedule="scaled_linear",
                          steps_offset=1, prediction_type=prediction_type))


def _pixel(unet_cfg: UNetConfig, text_cfg: CLIPTextConfig, tokenizer,
           dtype: torch.dtype, device: Device, seed: int,
           **fields: Any) -> PixelDiffusion:
    device = resolve_device(device)
    with torch.device(device):
        unet = UNet2DCondition(unet_cfg, dtype=dtype)
        text_encoder = CLIPTextModel(text_cfg, dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    init_like_flax_(unet, gen)
    init_like_flax_(text_encoder, gen)
    unet.train()
    text_encoder.eval().requires_grad_(False)
    return PixelDiffusion(unet=unet, text_encoder=text_encoder,
                          tokenizer=tokenizer, **fields)


def discrete_pixel_diffusion(clip_model_name: Optional[str] = None,
                             prediction_type: str = "epsilon",
                             encode_in_bf16: bool = True,
                             device: Device = None, seed: int = 0
                             ) -> PixelDiffusion:
    """Pixel-space diffusion with discrete DDPM training and DDIM sampling:
    `PIXEL_UNET` (SD2's widths and heads, 3 -> 3 channels, cross-attention
    768) and the CLIP ViT-L/14 text tower, bf16 compute (`encode_in_bf16`)
    or fp32. `clip_model_name` is where a CLIP tokenizer is read from, when
    it holds one."""
    train, infer = _pixel_schedulers(prediction_type)
    return _pixel(PIXEL_UNET, VIT_L14_TEXT_CONFIG,
                  _tokenizer(clip_model_name),
                  torch.bfloat16 if encode_in_bf16 else torch.float32,
                  device, seed, noise_scheduler=train,
                  inference_scheduler=infer, prediction_type=prediction_type)


def continuous_pixel_diffusion(clip_model_name: Optional[str] = None,
                               prediction_type: str = "epsilon",
                               use_ode: bool = False,
                               train_t_max: float = 1.570795,
                               inference_t_max: float = 1.56,
                               encode_in_bf16: bool = True,
                               device: Device = None, seed: int = 0
                               ) -> PixelDiffusion:
    """Continuous-time VP diffusion in pixel space: the same UNet and text
    tower, the tangent-schedule scheduler for training (t in [0,
    `train_t_max`)) and sampling (from `inference_t_max`), by the reverse
    SDE or, with `use_ode`, the probability-flow ODE."""
    return _pixel(PIXEL_UNET, VIT_L14_TEXT_CONFIG,
                  _tokenizer(clip_model_name),
                  torch.bfloat16 if encode_in_bf16 else torch.float32,
                  device, seed,
                  noise_scheduler=ContinuousTimeScheduler(
                      t_max=train_t_max, prediction_type=prediction_type),
                  inference_scheduler=ContinuousTimeScheduler(
                      t_max=inference_t_max, prediction_type=prediction_type,
                      use_ode=use_ode),
                  prediction_type=prediction_type, continuous_time=True)


def stable_diffusion_3(transformer: Optional[dict] = None,
                       encode_latents_in_fp16: bool = True,
                       device: Device = None) -> StableDiffusion3:
    """SD3-medium's MMDiT (2,028,328,000 parameters; `models/mmdit.py`)
    trained by rectified flow (`schedulers/flow_match.py`: logit-normal t
    shifted by the published scheduler's 3.0), computing in bf16
    (`encode_latents_in_fp16`) or fp32 over fp32 parameters, its weights
    drawn as flax's defaults would from seed 0. `transformer` is a
    diffusers `SD3Transformer2DModel` config (its `_`-prefixed keys are
    ignored; the published SD3-medium's by default). It trains on
    precomputed latents and text states: the towers (CLIP-L, OpenCLIP
    bigG, T5-XXL, the 16-channel VAE) are not ported."""
    config = _net_config(MMDiTConfig, transformer, "MMDiT")
    device = resolve_device(device)
    with torch.device(device):
        net = MMDiT(config, dtype=torch.bfloat16
                    if encode_latents_in_fp16 else torch.float32)
    if device.type != "meta":    # shapes only (a FLOP count): nothing to draw
        init_like_flax_(net, torch.Generator(device=device).manual_seed(0))
    net.train()
    return StableDiffusion3(unet=net)


def _net_config(cls, given: Optional[dict], name: str):
    """`cls` from a diffusers config (its `_`-prefixed keys ignored); an
    unknown key raises."""
    known = {f.name for f in dataclasses.fields(cls)}
    kwargs = {k: v for k, v in (given or {}).items() if not k.startswith("_")}
    unknown = sorted(set(kwargs) - known)
    if unknown:
        raise ValueError(f"{name} config keys not supported: {unknown}")
    return cls(**kwargs)


def flux(transformer: Optional[dict] = None,
         encode_latents_in_fp16: bool = True, guidance: float = 3.5,
         device: Device = None) -> StableDiffusion3:
    """FLUX.1-dev's transformer (11,901,408,320 parameters; `models/flux.py`)
    trained by rectified flow (`schedulers/flow_match.py`: logit-normal t
    shifted by the published scheduler's dynamic shift at the packed image
    length, e^1.15 at 1,024px), with `guidance` (x 1000) in its guidance
    embedding for every sample, computing in bf16
    (`encode_latents_in_fp16`) or fp32 over fp32 parameters, its weights
    drawn as flax's defaults would from seed 0 (the q/k norms' scales 1).
    `transformer` is a diffusers `FluxTransformer2DModel` config (the
    published FLUX.1-dev's by default). It trains on precomputed latents
    and text states: the towers (T5-XXL, CLIP-L, the 16-channel VAE) are
    not ported."""
    config = _net_config(FluxConfig, transformer, "FLUX transformer")
    device = resolve_device(device)
    with torch.device(device):
        net = FluxTransformer(config, dtype=torch.bfloat16
                              if encode_latents_in_fp16 else torch.float32)
    if device.type != "meta":    # shapes only (a FLOP count): nothing to draw
        init_like_flax_(net, torch.Generator(device=device).manual_seed(0))
    net.train()
    return StableDiffusion3(unet=net, shift=None,
                            guidance=guidance if config.guidance_embeds
                            else None)

