"""UNet2DCondition, the denoising network.

Counterpart of `diffusion_tpu/models/unet.py` with diffusers' module names
(`down_blocks.i.resnets.j`, `mid_block`, `up_blocks`, ...), so a diffusers
UNet2DConditionModel state_dict loads as it is. NCHW in and out (the JAX
module is NHWC); the activations are kept in channels_last memory, whose
layout is the JAX one. Trains with autograd through the GroupNorm and flash
kernels' backward halves; `remat` and dropout > 0 raise (ROADMAP.md queue 1
item 5).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from diffusion_torch.models.layers import (CHANNELS_LAST, Container, Conv2d, Downsample,
                                           GroupNorm, ResnetBlock,
                                           TimestepEmbedding, Transformer2D,
                                           Upsample, timestep_embedding)

__all__ = ["UNetConfig", "UNet2DCondition", "SD2_BASE_UNET",
           "group_norm_shapes"]


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Same fields and defaults as the JAX UNetConfig (SD-2-base)."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    block_has_attention: Tuple[bool, ...] = (True, True, True, False)
    attention_head_dim: Tuple[int, ...] = (5, 10, 20, 20)  # = num heads
    cross_attention_dim: int = 1024
    transformer_depth: int = 1
    use_linear_projection: bool = True
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0
    norm_num_groups: int = 32
    dropout: float = 0.0


SD2_BASE_UNET = UNetConfig()


def group_norm_shapes(config: UNetConfig, batch: int, side: int):
    """The GroupNorm calls of one `UNet2DCondition` forward on (batch, C,
    side, side) latents, in call order: ((B, L, C), groups, act) per call,
    the (B, L, C) slab that `ops.groupnorm.group_norm` receives."""
    chans, groups = config.block_out_channels, config.norm_num_groups
    calls = []

    def norm(c, s, act):
        calls.append(((batch, s * s, c), groups, act))

    def resnet(cin, cout, s):
        norm(cin, s, "silu")
        norm(cout, s, "silu")

    n, s, cur = len(chans), side, chans[0]
    skips = [cur]
    for i, out in enumerate(chans):
        for _ in range(config.layers_per_block):
            resnet(cur, out, s)
            if config.block_has_attention[i]:
                norm(out, s, None)
            cur = out
            skips.append(cur)
        if i < n - 1:
            s //= 2
            skips.append(cur)
    resnet(cur, cur, s)
    norm(cur, s, None)
    resnet(cur, cur, s)
    for i, out in enumerate(reversed(chans)):
        for _ in range(config.layers_per_block + 1):
            resnet(cur + skips.pop(), out, s)
            if config.block_has_attention[n - 1 - i]:
                norm(out, s, None)
            cur = out
        if i < n - 1:
            s *= 2
    norm(chans[0], s, "silu")
    return calls


class UNet2DCondition(nn.Module):
    def __init__(self, config: UNetConfig = SD2_BASE_UNET,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        if remat:
            raise NotImplementedError(
                "UNet remat comes with ROADMAP.md queue 1 item 5 (remat and "
                "dropout)")
        super().__init__()
        self.config, self.dtype = config, dtype
        chans = config.block_out_channels
        heads = config.attention_head_dim
        groups = config.norm_num_groups
        cross = config.cross_attention_dim
        temb_dim = chans[0] * 4

        def resnet(cin, cout):
            return ResnetBlock(cin, cout, temb_dim, groups,
                               dropout=config.dropout)

        def transformer(ch, n_heads):
            return Transformer2D(ch, n_heads, cross, groups,
                                 config.transformer_depth,
                                 config.use_linear_projection)

        self.conv_in = Conv2d(config.in_channels, chans[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(chans[0], temb_dim)

        n = len(chans)
        skips = [chans[0]]
        cur = chans[0]
        self.down_blocks = nn.ModuleList()
        for i, out_ch in enumerate(chans):
            block = Container()
            block.resnets = nn.ModuleList()
            if config.block_has_attention[i]:
                block.attentions = nn.ModuleList()
            for _ in range(config.layers_per_block):
                block.resnets.append(resnet(cur, out_ch))
                if config.block_has_attention[i]:
                    block.attentions.append(transformer(out_ch, heads[i]))
                cur = out_ch
                skips.append(cur)
            if i < n - 1:
                block.downsamplers = nn.ModuleList([Downsample(out_ch)])
                skips.append(out_ch)
            self.down_blocks.append(block)

        self.mid_block = Container()
        self.mid_block.resnets = nn.ModuleList([resnet(cur, cur),
                                                resnet(cur, cur)])
        self.mid_block.attentions = nn.ModuleList([transformer(cur, heads[-1])])

        self.up_blocks = nn.ModuleList()
        for i, out_ch in enumerate(reversed(chans)):
            has_attn = config.block_has_attention[n - 1 - i]
            block = Container()
            block.resnets = nn.ModuleList()
            if has_attn:
                block.attentions = nn.ModuleList()
            for _ in range(config.layers_per_block + 1):
                block.resnets.append(resnet(cur + skips.pop(), out_ch))
                if has_attn:
                    block.attentions.append(transformer(out_ch, heads[n - 1 - i]))
                cur = out_ch
            if i < n - 1:
                block.upsamplers = nn.ModuleList([Upsample(out_ch)])
            self.up_blocks.append(block)

        self.conv_norm_out = GroupNorm(groups, chans[0], act="silu")
        self.conv_out = Conv2d(chans[0], config.out_channels, 3, padding=1)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor) -> torch.Tensor:
        """sample (B, Cin, H, W), timesteps (B,) or scalar, context
        (B, S, cross_dim) -> fp32 (B, Cout, H, W)."""
        cfg = self.config
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(sample.shape[0])
        temb = timestep_embedding(timesteps, cfg.block_out_channels[0],
                                  cfg.flip_sin_to_cos, cfg.freq_shift)
        temb = self.time_embedding(temb.to(self.dtype))
        context = encoder_hidden_states.to(self.dtype)
        h = self.conv_in(sample.to(self.dtype).contiguous(
            memory_format=CHANNELS_LAST))

        residuals = [h]
        for block in self.down_blocks:
            attns = getattr(block, "attentions", None)
            for j, resnet in enumerate(block.resnets):
                h = resnet(h, temb)
                if attns is not None:
                    h = attns[j](h, context)
                residuals.append(h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0](h)
                residuals.append(h)

        h = self.mid_block.resnets[0](h, temb)
        h = self.mid_block.attentions[0](h, context)
        h = self.mid_block.resnets[1](h, temb)

        for block in self.up_blocks:
            attns = getattr(block, "attentions", None)
            for j, resnet in enumerate(block.resnets):
                # the channel concat of NCHW tensors is not channels_last
                # any more; the next GroupNorm needs it back (a copy that
                # autograd carries: the gradient of the concat's halves is a
                # slice of a channels_last cotangent)
                h = torch.cat([h, residuals.pop()], dim=1).contiguous(
                    memory_format=CHANNELS_LAST)
                h = resnet(h, temb)
                if attns is not None:
                    h = attns[j](h, context)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)

        return self.conv_out(self.conv_norm_out(h)).float()
