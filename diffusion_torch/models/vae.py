"""AutoencoderKL: `Encoder` + `quant_conv` -> `DiagonalGaussian`, and
`post_quant_conv` + `Decoder`.

Counterpart of `diffusion_tpu/models/vae.py` with diffusers' names
(`encoder.down_blocks.0.downsamplers.0.conv`,
`decoder.mid_block.attentions.0.to_q`, ...). NCHW in and out,
channels_last inside, so every GroupNorm reads a contiguous NHWC slab. The
mid blocks' single-head attention (head dim 512) is plain math on both
sides, never the flash kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from diffusion_torch.models.layers import (CHANNELS_LAST, Container, Conv2d, GroupNorm,
                                           Linear, ResnetBlock, Upsample)

__all__ = ["VAEConfig", "AutoencoderKL", "DiagonalGaussian", "Encoder",
           "Decoder", "SD2_VAE", "encoder_group_norm_shapes"]


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


def encoder_group_norm_shapes(config: VAEConfig, batch: int, height: int,
                              width: int):
    """The GroupNorm calls of one `Encoder` forward on (batch, 3, height,
    width) images, in call order: ((B, L, C), groups, act) per call, the
    (B, L, C) slab that `ops.groupnorm.group_norm` receives."""
    chans, groups = config.block_out_channels, config.norm_num_groups
    calls = []
    h, w, cur = height, width, chans[0]

    def resnet(cin, cout):
        calls.append(((batch, h * w, cin), groups, "silu"))
        calls.append(((batch, h * w, cout), groups, "silu"))

    for i, out in enumerate(chans):
        for _ in range(config.layers_per_block):
            resnet(cur, out)
            cur = out
        if i < len(chans) - 1:      # (0, 1) pad, 3x3 stride-2 conv
            h, w = (h - 2) // 2 + 1, (w - 2) // 2 + 1
    resnet(cur, cur)
    calls.append(((batch, h * w, cur), groups, None))       # attention
    resnet(cur, cur)
    calls.append(((batch, h * w, cur), groups, "silu"))     # conv_norm_out
    return calls


class DiagonalGaussian:
    """The posterior q(z|x) over NCHW moments: split into (mean, logvar)
    along the channels, logvar clipped to [-30, 20]; `sample`, `mode`,
    `kl`."""

    def __init__(self, moments: torch.Tensor):
        self.mean, logvar = moments.chunk(2, dim=1)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, eps: torch.Tensor) -> torch.Tensor:
        """mean + std * eps, `eps` a standard normal draw of the mean's
        shape (the caller draws it, so a test can hand in JAX's)."""
        return self.mean + self.std * eps.to(self.mean.device,
                                             self.mean.dtype)

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        return 0.5 * torch.sum(torch.square(self.mean) + torch.exp(self.logvar)
                               - 1.0 - self.logvar, dim=(1, 2, 3))


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


class DownsampleAsym(nn.Module):
    """Stride-2 3x3 conv after a (0, 1) right/bottom pad (diffusers'
    VAE Downsample2D with padding 0)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x.contiguous(memory_format=CHANNELS_LAST))


class Encoder(nn.Module):
    def __init__(self, config: VAEConfig = SD2_VAE):
        super().__init__()
        chans = config.block_out_channels
        groups = config.norm_num_groups
        self.conv_in = Conv2d(config.in_channels, chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        cur = chans[0]
        for i, out_ch in enumerate(chans):
            block = Container()
            block.resnets = nn.ModuleList()
            for _ in range(config.layers_per_block):
                block.resnets.append(
                    ResnetBlock(cur, out_ch, None, groups, 1e-6))
                cur = out_ch
            if i < len(chans) - 1:
                block.downsamplers = nn.ModuleList([DownsampleAsym(out_ch)])
            self.down_blocks.append(block)
        self.mid_block = Container()
        self.mid_block.resnets = nn.ModuleList([
            ResnetBlock(cur, cur, None, groups, 1e-6),
            ResnetBlock(cur, cur, None, groups, 1e-6)])
        self.mid_block.attentions = nn.ModuleList([VaeAttention(cur, groups)])
        self.conv_norm_out = GroupNorm(groups, cur, 1e-6, act="silu")
        self.conv_out = Conv2d(cur, 2 * config.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for block in self.down_blocks:
            for resnet in block.resnets:
                h = resnet(h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0](h)
        h = self.mid_block.resnets[0](h)
        h = self.mid_block.attentions[0](h)
        h = self.mid_block.resnets[1](h)
        return self.conv_out(self.conv_norm_out(h))


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
    """encode(x (B, 3, H, W) in [-1, 1]) -> DiagonalGaussian over fp32
    (B, 4, H/8, W/8); decode(z (B, 4, H/8, W/8)) -> fp32 image (B, 3, H, W)
    in about [-1, 1]."""

    def __init__(self, config: VAEConfig = SD2_VAE,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config, self.dtype = config, dtype
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = Conv2d(2 * config.latent_channels,
                                 2 * config.latent_channels, 1)
        self.post_quant_conv = Conv2d(config.latent_channels,
                                      config.latent_channels, 1)

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        x = x.to(self.dtype).contiguous(memory_format=CHANNELS_LAST)
        return DiagonalGaussian(self.quant_conv(self.encoder(x)).float())

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        z = z.to(self.dtype).contiguous(memory_format=CHANNELS_LAST)
        return self.decoder(self.post_quant_conv(z))
