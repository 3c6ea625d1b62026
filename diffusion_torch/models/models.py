"""Model builders: full-width SD-2-base and the tiny test geometry.

Counterparts of `stable_diffusion_2` and `stable_diffusion_tiny` in
`diffusion_tpu/models/models.py`, with the JAX builders' keywords, defaults
and meanings as the yamls pass them: `precomputed_latents`,
`encode_latents_in_fp16` (bf16 compute, else fp32), `fsdp` (recorded on the
model), `val_metrics`, `train_metrics`, `val_seed`, `loss_bins`,
`prediction_type`, `min_snr_gamma`, `rescale_betas_zero_snr`,
`timestep_spacing`, `init_frozen_towers`. A builder makes the modules on
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
and no generation eval.

Not ported yet, each raising NotImplementedError naming its ROADMAP.md
item: a non-empty `val_guidance_scales` (the generation metrics, item 8),
samplers other than DDIM (item 7).
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Sequence

import torch

from diffusion_torch.models.clip import (CLIPTextConfig, CLIPTextModel,
                                         SD2_TEXT_CONFIG)
from diffusion_torch.models.layers import init_like_flax_
from diffusion_torch.models.pretrained import load_pretrained_params
from diffusion_torch.models.stable_diffusion import StableDiffusion
from diffusion_torch.models.unet import SD2_BASE_UNET, UNet2DCondition, UNetConfig
from diffusion_torch.models.vae import SD2_VAE, AutoencoderKL, VAEConfig
from diffusion_torch.schedulers import DDIMScheduler, DDPMScheduler
from diffusion_torch.text.tokenizer import CLIPTokenizer, tiny_tokenizer
from diffusion_torch.utils.device import Device, resolve_device

__all__ = ["stable_diffusion_2", "stable_diffusion_tiny"]


def _check_ported(inference_scheduler: str,
                  val_guidance_scales: Optional[Sequence[float]]) -> None:
    if inference_scheduler.lower() != "ddim":
        raise NotImplementedError(
            f"sampler {inference_scheduler!r} comes with ROADMAP.md queue 1 "
            f"item 7 (DPM++/Euler samplers and guidance rescale)")
    if val_guidance_scales:
        raise NotImplementedError(
            "val_guidance_scales (generation metrics in the eval loop) come "
            "with ROADMAP.md queue 1 item 8 (metrics)")


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


def _build(unet_cfg: UNetConfig, vae_cfg: VAEConfig,
           text_cfg: CLIPTextConfig, tokenizer, dtype: torch.dtype,
           device: Device, seed: int, *, precomputed_latents: bool,
           prediction_type: str, min_snr_gamma: Optional[float],
           rescale_betas_zero_snr: bool, timestep_spacing: Optional[str],
           init_frozen_towers: Optional[bool],
           pretrained_path: Optional[str] = None, **fields: Any
           ) -> StableDiffusion:
    device = resolve_device(device)
    if init_frozen_towers is None:
        init_frozen_towers = not precomputed_latents
    spacing = _spacing(timestep_spacing, rescale_betas_zero_snr)
    noise_scheduler = DDPMScheduler(
        prediction_type=prediction_type,
        rescale_betas_zero_snr=rescale_betas_zero_snr,
        timestep_spacing=spacing)
    inference_scheduler = DDIMScheduler(
        prediction_type=prediction_type,
        rescale_betas_zero_snr=rescale_betas_zero_snr,
        timestep_spacing=spacing)
    with torch.device(device):
        unet = UNet2DCondition(unet_cfg, dtype=dtype)
        towers = ((AutoencoderKL(vae_cfg, dtype=dtype),
                   CLIPTextModel(text_cfg, dtype=dtype))
                  if init_frozen_towers else (None, None))
    gen = torch.Generator(device=device).manual_seed(seed)
    init_like_flax_(unet, gen)
    unet.train()
    for module in towers:
        if module is not None:
            init_like_flax_(module, gen)
            module.eval().requires_grad_(False)
    model = StableDiffusion(unet=unet, vae=towers[0], text_encoder=towers[1],
                            tokenizer=tokenizer,
                            inference_scheduler=inference_scheduler,
                            noise_scheduler=noise_scheduler,
                            prediction_type=prediction_type,
                            min_snr_gamma=min_snr_gamma,
                            precomputed_latents=precomputed_latents,
                            pretrained_path=pretrained_path, **fields)
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
                       init_frozen_towers: Optional[bool] = None,
                       inference_scheduler: str = "ddim",
                       min_snr_gamma: Optional[float] = None,
                       prediction_type: str = "epsilon",
                       rescale_betas_zero_snr: bool = False,
                       timestep_spacing: Optional[str] = None,
                       device: Device = None, seed: int = 0
                       ) -> StableDiffusion:
    """SD-2-base at full width: 866M-parameter UNet, SD2 VAE, 23-layer
    CLIP text tower, computing in bf16 (`encode_latents_in_fp16`, as the JAX
    builder maps it) or fp32. `model_name` is a local diffusers directory:
    the weights with `pretrained=True`, and the tokenizer where it holds
    one."""
    _check_ported(inference_scheduler, val_guidance_scales)
    pretrained_path = _pretrained_dir(pretrained, model_name)
    return _build(SD2_BASE_UNET, SD2_VAE, SD2_TEXT_CONFIG,
                  _tokenizer(model_name),
                  torch.bfloat16 if encode_latents_in_fp16 else torch.float32,
                  device, seed,
                  precomputed_latents=precomputed_latents,
                  prediction_type=prediction_type, min_snr_gamma=min_snr_gamma,
                  rescale_betas_zero_snr=rescale_betas_zero_snr,
                  timestep_spacing=timestep_spacing,
                  init_frozen_towers=init_frozen_towers,
                  pretrained_path=pretrained_path,
                  val_seed=int(val_seed),
                  loss_bins=tuple(tuple(b) for b in (loss_bins or [(0, 1)])),
                  train_metric_names=tuple(train_metrics
                                           or ("MeanSquaredError",)),
                  val_metric_names=tuple(val_metrics or (
                      "MeanSquaredError", "FrechetInceptionDistance")),
                  fsdp=bool(fsdp))


def stable_diffusion_tiny(val_guidance_scales: Optional[List[float]] = None,
                          precomputed_latents: bool = False,
                          model_name: Optional[str] = None,
                          pretrained: bool = False,
                          val_metrics: Optional[List[Any]] = None,
                          inference_scheduler: str = "ddim",
                          min_snr_gamma: Optional[float] = None,
                          prediction_type: str = "epsilon",
                          rescale_betas_zero_snr: bool = False,
                          timestep_spacing: Optional[str] = None,
                          init_frozen_towers: Optional[bool] = None,
                          device: Device = None, seed: int = 0,
                          **_: Any) -> StableDiffusion:
    """The JAX package's tiny geometry (fp32): real architecture, small
    channels, for tests and CPU runs. Like the JAX builder, it ignores
    keywords it does not know (a yaml's `loss_bins`, `fsdp`, ...). It takes
    the same `pretrained`/`model_name` contract as `stable_diffusion_2`
    (the tokenizer stays the tiny one)."""
    _check_ported(inference_scheduler, val_guidance_scales)
    pretrained_path = _pretrained_dir(pretrained, model_name)
    return _build(
        UNetConfig(in_channels=4, out_channels=4, block_out_channels=(32, 64),
                   layers_per_block=1, block_has_attention=(True, False),
                   attention_head_dim=(2, 4), cross_attention_dim=32,
                   norm_num_groups=8),
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
        pretrained_path=pretrained_path,
        val_metric_names=tuple(val_metrics or ("MeanSquaredError",)))
