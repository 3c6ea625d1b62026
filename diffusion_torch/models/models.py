"""Model builders: full-width SD-2-base and the tiny test geometry.

Counterparts of `stable_diffusion_2` and `stable_diffusion_tiny` in
`diffusion_tpu/models/models.py`. A builder makes the modules on `device`
and draws their weights as flax's defaults would (`init_like_flax_`) from a
`torch.Generator` seeded with `seed`; load real weights over them with
`load_state_dict` (see `models/port_jax.py`).

SD-2-base computes in bf16 over fp32 parameters, as the JAX package's
`encode_latents_in_fp16=True` sets it; the tiny geometry computes in fp32.
Only the DDIM sampler (epsilon prediction) is ported.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

from diffusion_torch.models.clip import (CLIPTextConfig, CLIPTextModel,
                                         SD2_TEXT_CONFIG)
from diffusion_torch.models.layers import init_like_flax_
from diffusion_torch.models.stable_diffusion import StableDiffusion
from diffusion_torch.models.unet import SD2_BASE_UNET, UNet2DCondition, UNetConfig
from diffusion_torch.models.vae import SD2_VAE, AutoencoderKL, VAEConfig
from diffusion_torch.schedulers import DDIMScheduler
from diffusion_torch.text.tokenizer import CLIPTokenizer, tiny_tokenizer

__all__ = ["stable_diffusion_2", "stable_diffusion_tiny"]

Device = Union[str, torch.device, None]


def _check_ported(inference_scheduler: str) -> None:
    if inference_scheduler.lower() != "ddim":
        raise NotImplementedError(
            f"sampler {inference_scheduler!r} comes with ROADMAP.md queue 1 "
            f"item 5 (DPM++/Euler samplers and guidance rescale)")


def _build(unet_cfg: UNetConfig, vae_cfg: VAEConfig,
           text_cfg: CLIPTextConfig, tokenizer, dtype: torch.dtype,
           device: Device, seed: int) -> StableDiffusion:
    device = torch.device(device or "cpu")
    with torch.device(device):
        unet = UNet2DCondition(unet_cfg, dtype=dtype)
        vae = AutoencoderKL(vae_cfg, dtype=dtype)
        text = CLIPTextModel(text_cfg, dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    for module in (unet, vae, text):
        init_like_flax_(module, gen)
        module.eval().requires_grad_(False)
    return StableDiffusion(unet=unet, vae=vae, text_encoder=text,
                           tokenizer=tokenizer,
                           inference_scheduler=DDIMScheduler())


def stable_diffusion_2(model_name: Optional[str] = None,
                       inference_scheduler: str = "ddim",
                       device: Device = None, seed: int = 0
                       ) -> StableDiffusion:
    """SD-2-base at full width: 866M-parameter UNet, SD2 VAE, 23-layer
    CLIP text tower. `model_name` is a local HF tokenizer directory; without
    one the byte-level tiny tokenizer is used."""
    _check_ported(inference_scheduler)
    tokenizer = (CLIPTokenizer.from_pretrained(model_name)
                 if model_name and os.path.exists(model_name)
                 else tiny_tokenizer())
    return _build(SD2_BASE_UNET, SD2_VAE, SD2_TEXT_CONFIG, tokenizer,
                  torch.bfloat16, device, seed)


def stable_diffusion_tiny(inference_scheduler: str = "ddim",
                          device: Device = None, seed: int = 0
                          ) -> StableDiffusion:
    """The JAX package's tiny geometry (fp32): real architecture, small
    channels, for tests and CPU runs."""
    _check_ported(inference_scheduler)
    return _build(
        UNetConfig(in_channels=4, out_channels=4, block_out_channels=(32, 64),
                   layers_per_block=1, block_has_attention=(True, False),
                   attention_head_dim=(2, 4), cross_attention_dim=32,
                   norm_num_groups=8),
        VAEConfig(block_out_channels=(8, 8, 8, 8), layers_per_block=1,
                  norm_num_groups=4),
        CLIPTextConfig(vocab_size=514, hidden_size=32, intermediate_size=64,
                       num_hidden_layers=2, num_attention_heads=2),
        tiny_tokenizer(), torch.float32, device, seed)
