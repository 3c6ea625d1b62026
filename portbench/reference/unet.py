"""The plain reference UNet: diffusers' UNet2DConditionModel in plain torch.

A frozen copy of the UNet half of `tools/torch_ref.py` (diffusers >= 0.11
semantics; module and parameter names are diffusers' own, so a diffusers
`state_dict` loads as it is). It imports nothing of the program. Attention
is a matmul, a softmax and a matmul, so a FLOP count of it counts the
model's work, not an implementation's.

Semantics (diffusers):
- ResnetBlock2D: GN -> SiLU -> conv1 -> (+time proj) -> GN -> SiLU -> conv2,
  a 1x1 conv_shortcut where the channels change, output skip + h.
- Transformer2DModel with use_linear_projection: GN(eps 1e-6) -> flatten ->
  Linear proj_in -> BasicTransformerBlock (pre-LN self-attention,
  cross-attention, GEGLU feed-forward with erf-GELU) -> Linear proj_out ->
  + residual.
- `attention_head_dim` is the NUMBER of heads (diffusers' naming quirk);
  the head size is channels // heads.
- Timestep embedding with flip_sin_to_cos=True, freq_shift=0.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["UNet2DCondition", "unet_spec"]


def unet_spec(unet: dict) -> dict:
    """The construction spec of a diffusers `unet/config.json` dict."""
    has_attn = [t.startswith("CrossAttn") for t in unet["down_block_types"]]
    heads = unet["attention_head_dim"]
    if isinstance(heads, int):
        heads = [heads] * len(unet["block_out_channels"])
    return {"in_channels": unet["in_channels"],
            "out_channels": unet["out_channels"],
            "block_out_channels": list(unet["block_out_channels"]),
            "layers_per_block": unet["layers_per_block"],
            "block_has_attention": has_attn,
            "attention_head_dim": list(heads),
            "cross_attention_dim": unet["cross_attention_dim"],
            "norm_num_groups": unet["norm_num_groups"],
            "norm_eps": unet.get("norm_eps", 1e-5),
            "use_linear_projection": unet.get("use_linear_projection", True),
            "flip_sin_to_cos": unet.get("flip_sin_to_cos", True),
            "freq_shift": unet.get("freq_shift", 0)}


def get_timestep_embedding(timesteps: torch.Tensor, dim: int,
                           flip_sin_to_cos: bool = True,
                           downscale_freq_shift: float = 0.0) -> torch.Tensor:
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock2D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temb_ch: Optional[int],
                 groups: int, eps: float):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_ch, eps=eps)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        if temb_ch:
            self.time_emb_proj = nn.Linear(temb_ch, out_ch)
        self.norm2 = nn.GroupNorm(groups, out_ch, eps=eps)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        if in_ch != out_ch:
            self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None and hasattr(self, "time_emb_proj"):
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        skip = self.conv_shortcut(x) if hasattr(self, "conv_shortcut") else x
        return skip + h


class Attention(nn.Module):
    """diffusers Attention (transformer-block flavor: no qkv biases)."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 cross_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        ctx = cross_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(ctx, inner, bias=False)
        self.to_v = nn.Linear(ctx, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim),
                                     nn.Dropout(0.0)])

    def forward(self, x, context=None):
        ctx = x if context is None else context
        b, sq, _ = x.shape
        sk = ctx.shape[1]
        q = self.to_q(x).view(b, sq, self.heads, self.dim_head).transpose(1, 2)
        k = self.to_k(ctx).view(b, sk, self.heads, self.dim_head).transpose(1, 2)
        v = self.to_v(ctx).view(b, sk, self.heads, self.dim_head).transpose(1, 2)
        attn = torch.softmax(q @ k.transpose(-1, -2) * self.dim_head ** -0.5,
                             dim=-1)
        o = (attn @ v).transpose(1, 2).reshape(b, sq, -1)
        return self.to_out[0](o)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([GEGLU(dim, inner), nn.Dropout(0.0),
                                  nn.Linear(inner, dim)])

    def forward(self, x):
        for mod in self.net:
            x = mod(x)
        return x


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, cross_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, heads, dim_head)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, heads, dim_head, cross_dim=cross_dim)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context=context)
        x = x + self.ff(self.norm3(x))
        return x


class Transformer2DModel(nn.Module):
    def __init__(self, channels: int, heads: int, cross_dim: int,
                 groups: int, depth: int, use_linear_projection: bool):
        super().__init__()
        dim_head = channels // heads
        self.use_linear_projection = use_linear_projection
        self.norm = nn.GroupNorm(groups, channels, eps=1e-6)
        if use_linear_projection:
            self.proj_in = nn.Linear(channels, channels)
            self.proj_out = nn.Linear(channels, channels)
        else:
            self.proj_in = nn.Conv2d(channels, channels, 1)
            self.proj_out = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(channels, heads, dim_head, cross_dim)
            for _ in range(depth)])

    def forward(self, x, context):
        b, c, h, w = x.shape
        residual = x
        hidden = self.norm(x)
        if self.use_linear_projection:
            hidden = hidden.permute(0, 2, 3, 1).reshape(b, h * w, c)
            hidden = self.proj_in(hidden)
        else:
            hidden = self.proj_in(hidden)
            hidden = hidden.permute(0, 2, 3, 1).reshape(b, h * w, c)
        for block in self.transformer_blocks:
            hidden = block(hidden, context)
        if self.use_linear_projection:
            hidden = self.proj_out(hidden)
            hidden = hidden.reshape(b, h, w, c).permute(0, 3, 1, 2)
        else:
            hidden = hidden.reshape(b, h, w, c).permute(0, 3, 1, 2)
            hidden = self.proj_out(hidden)
        return hidden + residual


class Downsample2D(nn.Module):
    def __init__(self, ch: int, asymmetric_pad: bool = False):
        super().__init__()
        self.asymmetric_pad = asymmetric_pad
        self.conv = nn.Conv2d(ch, ch, 3, stride=2,
                              padding=0 if asymmetric_pad else 1)

    def forward(self, x):
        if self.asymmetric_pad:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Block(nn.Module):
    """Generic down/up/mid block container matching diffusers child names."""


class UNet2DCondition(nn.Module):
    """UNet2DConditionModel at the widths of `unet_spec(config)`: NCHW
    sample (B, C, H, W), (B,) timesteps, (B, S, D) context."""

    def __init__(self, spec: dict):
        super().__init__()
        self.spec = dict(spec)
        chans: Sequence[int] = spec["block_out_channels"]
        layers = spec["layers_per_block"]
        has_attn: Sequence[bool] = spec["block_has_attention"]
        heads: Sequence[int] = spec["attention_head_dim"]  # = num heads
        cross = spec["cross_attention_dim"]
        groups = spec["norm_num_groups"]
        linear_proj = spec["use_linear_projection"]
        eps = spec["norm_eps"]
        temb_dim = chans[0] * 4

        self.conv_in = nn.Conv2d(spec["in_channels"], chans[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(chans[0], temb_dim)

        n = len(chans)
        skip_chans = [chans[0]]
        self.down_blocks = nn.ModuleList()
        cur = chans[0]
        for i, out_ch in enumerate(chans):
            block = _Block()
            block.resnets = nn.ModuleList()
            if has_attn[i]:
                block.attentions = nn.ModuleList()
            for _ in range(layers):
                block.resnets.append(
                    ResnetBlock2D(cur, out_ch, temb_dim, groups, eps))
                if has_attn[i]:
                    block.attentions.append(Transformer2DModel(
                        out_ch, heads[i], cross, groups, 1, linear_proj))
                cur = out_ch
                skip_chans.append(cur)
            if i < n - 1:
                block.downsamplers = nn.ModuleList([Downsample2D(out_ch)])
                skip_chans.append(out_ch)
            self.down_blocks.append(block)

        mid = _Block()
        mid.resnets = nn.ModuleList([
            ResnetBlock2D(cur, cur, temb_dim, groups, eps),
            ResnetBlock2D(cur, cur, temb_dim, groups, eps)])
        mid.attentions = nn.ModuleList([Transformer2DModel(
            cur, heads[-1], cross, groups, 1, linear_proj)])
        self.mid_block = mid

        self.up_blocks = nn.ModuleList()
        rev_chans = list(reversed(chans))
        rev_attn = list(reversed(has_attn))
        rev_heads = list(reversed(heads))
        for i, out_ch in enumerate(rev_chans):
            block = _Block()
            block.resnets = nn.ModuleList()
            if rev_attn[i]:
                block.attentions = nn.ModuleList()
            for _ in range(layers + 1):
                skip = skip_chans.pop()
                block.resnets.append(
                    ResnetBlock2D(cur + skip, out_ch, temb_dim, groups, eps))
                if rev_attn[i]:
                    block.attentions.append(Transformer2DModel(
                        out_ch, rev_heads[i], cross, groups, 1, linear_proj))
                cur = out_ch
            if i < n - 1:
                block.upsamplers = nn.ModuleList([Upsample2D(out_ch)])
            self.up_blocks.append(block)

        self.conv_norm_out = nn.GroupNorm(groups, chans[0], eps=eps)
        self.conv_out = nn.Conv2d(chans[0], spec["out_channels"], 3, padding=1)

    def forward(self, sample, timesteps, encoder_hidden_states):
        temb = get_timestep_embedding(
            timesteps, self.spec["block_out_channels"][0],
            flip_sin_to_cos=self.spec["flip_sin_to_cos"],
            downscale_freq_shift=self.spec["freq_shift"])
        temb = self.time_embedding(temb)
        h = self.conv_in(sample)
        residuals = [h]
        for block in self.down_blocks:
            attns = getattr(block, "attentions", None)
            for j, resnet in enumerate(block.resnets):
                h = resnet(h, temb)
                if attns is not None:
                    h = attns[j](h, encoder_hidden_states)
                residuals.append(h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0](h)
                residuals.append(h)
        h = self.mid_block.resnets[0](h, temb)
        h = self.mid_block.attentions[0](h, encoder_hidden_states)
        h = self.mid_block.resnets[1](h, temb)
        for block in self.up_blocks:
            attns = getattr(block, "attentions", None)
            for j, resnet in enumerate(block.resnets):
                h = torch.cat([h, residuals.pop()], dim=1)
                h = resnet(h, temb)
                if attns is not None:
                    h = attns[j](h, encoder_hidden_states)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))
