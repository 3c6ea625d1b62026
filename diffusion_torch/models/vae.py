"""AutoencoderKL decode path: `Decoder` and `post_quant_conv`.

Counterpart of the decode half of `diffusion_tpu/models/vae.py` with
diffusers' names (`decoder.mid_block.attentions.0.to_q`, ...). NCHW in and
out, channels_last inside. The encoder (and `quant_conv`) come with
img2img and the raw-image training path.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from diffusion_torch.models.layers import (CHANNELS_LAST, Container, Conv2d, GroupNorm,
                                           Linear, ResnetBlock, Upsample)

__all__ = ["VAEConfig", "AutoencoderKL", "Decoder", "SD2_VAE"]


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """Same fields and defaults as the JAX VAEConfig (SD2)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32


SD2_VAE = VAEConfig()


class VaeAttention(nn.Module):
    """Single-head spatial self-attention of the VAE mid block: plain math,
    as the JAX `_VaeAttention` (never the flash kernel)."""

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(groups, channels, eps=1e-6)
        self.to_q = Linear(channels, channels)
        self.to_k = Linear(channels, channels)
        self.to_v = Linear(channels, channels)
        self.to_out = nn.ModuleList([Linear(channels, channels), nn.Identity()])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        hidden = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = self.to_q(hidden), self.to_k(hidden), self.to_v(hidden)
        logits = torch.bmm(q.float(), k.float().transpose(1, 2)) * c ** -0.5
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        o = self.to_out[0](torch.bmm(probs, v))
        return x + o.reshape(b, h, w, c).permute(0, 3, 1, 2)


class Decoder(nn.Module):
    def __init__(self, config: VAEConfig = SD2_VAE):
        super().__init__()
        rev = list(reversed(config.block_out_channels))
        groups = config.norm_num_groups
        self.conv_in = Conv2d(config.latent_channels, rev[0], 3, padding=1)
        self.mid_block = Container()
        self.mid_block.resnets = nn.ModuleList([
            ResnetBlock(rev[0], rev[0], None, groups, 1e-6),
            ResnetBlock(rev[0], rev[0], None, groups, 1e-6)])
        self.mid_block.attentions = nn.ModuleList([VaeAttention(rev[0], groups)])
        self.up_blocks = nn.ModuleList()
        cur = rev[0]
        for i, out_ch in enumerate(rev):
            block = Container()
            block.resnets = nn.ModuleList()
            for _ in range(config.layers_per_block + 1):
                block.resnets.append(
                    ResnetBlock(cur, out_ch, None, groups, 1e-6))
                cur = out_ch
            if i < len(rev) - 1:
                block.upsamplers = nn.ModuleList([Upsample(out_ch)])
            self.up_blocks.append(block)
        self.conv_norm_out = GroupNorm(groups, cur, 1e-6, act="silu")
        self.conv_out = Conv2d(cur, config.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(z)
        h = self.mid_block.resnets[0](h)
        h = self.mid_block.attentions[0](h)
        h = self.mid_block.resnets[1](h)
        for block in self.up_blocks:
            for resnet in block.resnets:
                h = resnet(h)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)
        return self.conv_out(self.conv_norm_out(h)).float()


class AutoencoderKL(nn.Module):
    """decode(z (B, 4, H/8, W/8)) -> fp32 image (B, 3, H, W) in about [-1, 1]."""

    def __init__(self, config: VAEConfig = SD2_VAE,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config, self.dtype = config, dtype
        self.decoder = Decoder(config)
        self.post_quant_conv = Conv2d(config.latent_channels,
                                      config.latent_channels, 1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        z = z.to(self.dtype).contiguous(memory_format=CHANNELS_LAST)
        return self.decoder(self.post_quant_conv(z))
