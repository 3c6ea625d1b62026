"""The plain reference VAE: diffusers' AutoencoderKL in plain torch.

A frozen copy of the VAE half of `tools/torch_ref.py` (diffusers' module
and parameter names). VAE resnets and norms use eps 1e-6; the mid-block
attention is single-head with biased projections and a residual add; the
encoder's downsamplers pad (0, 1, 0, 1) and convolve stride 2 unpadded.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.unet import (Downsample2D, ResnetBlock2D,
                                      Upsample2D, _Block)

__all__ = ["AutoencoderKL", "vae_spec"]


def vae_spec(vae: dict) -> dict:
    """The construction spec of a diffusers `vae/config.json` dict."""
    return {k: vae[k] for k in ("in_channels", "out_channels",
                                "latent_channels", "block_out_channels",
                                "layers_per_block", "norm_num_groups")}


class VaeAttention(nn.Module):
    """VAE mid-block single-head attention (diffusers Attention with
    residual_connection=True, biased projections)."""

    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch), nn.Dropout(0.0)])

    def forward(self, x):
        b, c, h, w = x.shape
        hidden = self.group_norm(x).view(b, c, h * w).transpose(1, 2)
        q, k, v = self.to_q(hidden), self.to_k(hidden), self.to_v(hidden)
        attn = torch.softmax(q @ k.transpose(-1, -2) * c ** -0.5, dim=-1)
        o = self.to_out[0](attn @ v)
        return x + o.transpose(1, 2).view(b, c, h, w)


class _Encoder(nn.Module):
    def __init__(self, spec: dict):
        super().__init__()
        chans = spec["block_out_channels"]
        layers = spec["layers_per_block"]
        groups = spec["norm_num_groups"]
        self.conv_in = nn.Conv2d(spec["in_channels"], chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        cur = chans[0]
        n = len(chans)
        for i, out_ch in enumerate(chans):
            block = _Block()
            block.resnets = nn.ModuleList()
            for _ in range(layers):
                block.resnets.append(
                    ResnetBlock2D(cur, out_ch, None, groups, 1e-6))
                cur = out_ch
            if i < n - 1:
                block.downsamplers = nn.ModuleList(
                    [Downsample2D(out_ch, asymmetric_pad=True)])
            self.down_blocks.append(block)
        mid = _Block()
        mid.resnets = nn.ModuleList([
            ResnetBlock2D(cur, cur, None, groups, 1e-6),
            ResnetBlock2D(cur, cur, None, groups, 1e-6)])
        mid.attentions = nn.ModuleList([VaeAttention(cur, groups)])
        self.mid_block = mid
        self.conv_norm_out = nn.GroupNorm(groups, cur, eps=1e-6)
        self.conv_out = nn.Conv2d(cur, 2 * spec["latent_channels"], 3,
                                  padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for block in self.down_blocks:
            for resnet in block.resnets:
                h = resnet(h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0](h)
        h = self.mid_block.resnets[0](h)
        h = self.mid_block.attentions[0](h)
        h = self.mid_block.resnets[1](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class _Decoder(nn.Module):
    def __init__(self, spec: dict):
        super().__init__()
        rev = list(reversed(spec["block_out_channels"]))
        layers = spec["layers_per_block"]
        groups = spec["norm_num_groups"]
        self.conv_in = nn.Conv2d(spec["latent_channels"], rev[0], 3, padding=1)
        mid = _Block()
        mid.resnets = nn.ModuleList([
            ResnetBlock2D(rev[0], rev[0], None, groups, 1e-6),
            ResnetBlock2D(rev[0], rev[0], None, groups, 1e-6)])
        mid.attentions = nn.ModuleList([VaeAttention(rev[0], groups)])
        self.mid_block = mid
        self.up_blocks = nn.ModuleList()
        cur = rev[0]
        n = len(rev)
        for i, out_ch in enumerate(rev):
            block = _Block()
            block.resnets = nn.ModuleList()
            for _ in range(layers + 1):
                block.resnets.append(
                    ResnetBlock2D(cur, out_ch, None, groups, 1e-6))
                cur = out_ch
            if i < n - 1:
                block.upsamplers = nn.ModuleList([Upsample2D(out_ch)])
            self.up_blocks.append(block)
        self.conv_norm_out = nn.GroupNorm(groups, cur, eps=1e-6)
        self.conv_out = nn.Conv2d(cur, spec["out_channels"], 3, padding=1)

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid_block.resnets[0](h)
        h = self.mid_block.attentions[0](h)
        h = self.mid_block.resnets[1](h)
        for block in self.up_blocks:
            for resnet in block.resnets:
                h = resnet(h)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    """AutoencoderKL at the widths of `vae_spec(config)`."""

    def __init__(self, spec: dict):
        super().__init__()
        self.spec = dict(spec)
        lat = spec["latent_channels"]
        self.encoder = _Encoder(spec)
        self.decoder = _Decoder(spec)
        self.quant_conv = nn.Conv2d(2 * lat, 2 * lat, 1)
        self.post_quant_conv = nn.Conv2d(lat, lat, 1)

    def encode_moments(self, x):
        return self.quant_conv(self.encoder(x))

    def encode_mean(self, x):
        mean, _ = self.encode_moments(x).chunk(2, dim=1)
        return mean

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))
