"""Shared building blocks for the UNet and VAE.

Counterparts of `diffusion_tpu/models/layers.py`, written as `nn.Module`s
with the diffusers parameter names, so a diffusers state_dict loads as it is
and `models/port_jax.py` is the exact inverse of `port_hf.port_unet`.

Layout: NCHW tensors in `torch.channels_last` memory format. The memory is
NHWC, the JAX package's layout, so the GroupNorm kernel reads a contiguous
(B, H*W, C) slab with no copy.

Precision, as in the JAX package: parameters are fp32 and the compute dtype
is the dtype of the activations (bf16 at full width). `Linear` and
`Conv2d` cast their weights to the input's dtype on every call (a
differentiable cast, so gradients land on the fp32 parameters); norms
compute their statistics in fp32 and return the input's dtype. LoRA and
dropout > 0 are not ported (ROADMAP.md queue 1 items 11 and 5).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from diffusion_torch.ops.attention import multi_head_attention
from diffusion_torch.ops.groupnorm import group_norm

__all__ = [
    "Linear", "Conv2d", "LayerNorm", "GroupNorm", "timestep_embedding",
    "TimestepEmbedding", "ResnetBlock", "Attention", "FeedForwardGEGLU",
    "BasicTransformerBlock", "Transformer2D", "Downsample", "Upsample",
    "Container", "init_like_flax_",
]

CHANNELS_LAST = torch.channels_last


class Container(nn.Module):
    """Holds child modules under diffusers/transformers names
    (`mid_block.resnets`, `text_model.encoder`, ...)."""


class Linear(nn.Linear):
    """nn.Linear computing in the input's dtype over fp32 parameters."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in the input's dtype over fp32 parameters."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class LayerNorm(nn.LayerNorm):
    """LayerNorm in fp32, returning the input's dtype (eps 1e-6 by default,
    flax's, which the JAX transformer blocks use)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__(dim, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


class GroupNorm(nn.Module):
    """GroupNorm over NCHW channels_last activations, optionally fused with
    SiLU; runs `ops.groupnorm.group_norm` on the NHWC view (the kernel on
    CUDA, which needs that view contiguous)."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 act: Optional[str] = None):
        super().__init__()
        self.num_groups, self.eps, self.act = num_groups, eps, act
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = group_norm(x.permute(0, 2, 3, 1), self.weight, self.bias,
                       self.num_groups, self.eps, self.act)
        return y.permute(0, 3, 1, 2)


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding, fp32 (diffusers
    get_timestep_embedding parity)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    freqs = torch.exp(exponent / (half - downscale_freq_shift))
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """2-layer SiLU MLP lifting the sinusoidal embedding."""

    def __init__(self, in_dim: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = Linear(in_dim, time_embed_dim)
        self.linear_2 = Linear(time_embed_dim, time_embed_dim)

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(emb)))


class ResnetBlock(nn.Module):
    """GroupNorm-SiLU-Conv residual block with additive time conditioning
    (`temb_channels=None` for the VAE's unconditioned blocks)."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int], groups: int = 32,
                 eps: float = 1e-5, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.norm1 = GroupNorm(groups, in_channels, eps, act="silu")
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        if temb_channels:
            self.time_emb_proj = Linear(temb_channels, out_channels)
        self.norm2 = GroupNorm(groups, out_channels, eps, act="silu")
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor,
                temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.training and self.dropout > 0:
            raise NotImplementedError(
                "ResnetBlock dropout > 0 in training comes with ROADMAP.md "
                "queue 1 item 5 (remat and dropout)")
        h = self.conv1(self.norm1(x))
        if temb is not None and hasattr(self, "time_emb_proj"):
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    """Multi-head attention over (B, S, C) tokens; cross-attention when a
    context is given. Dispatches through `ops.attention`."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 cross_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        ctx = cross_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(ctx, inner, bias=False)
        self.to_v = Linear(ctx, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, query_dim), nn.Identity()])

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        b, sq, _ = x.shape
        sk = ctx.shape[1]
        q = self.to_q(x).view(b, sq, self.heads, self.dim_head)
        k = self.to_k(ctx).view(b, sk, self.heads, self.dim_head)
        v = self.to_v(ctx).view(b, sk, self.heads, self.dim_head)
        o = multi_head_attention(q, k, v)
        return self.to_out[0](o.reshape(b, sq, -1))


class _GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # diffusers' fused value+gate projection, chunked (value, gate); the
        # JAX module keeps the halves as proj_in/proj_gate (port_jax re-fuses)
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate)


class FeedForwardGEGLU(nn.Module):
    """GEGLU feed-forward, exact erf GELU: net.0 = GEGLU, net.2 = output."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([_GEGLU(dim, inner), nn.Identity(),
                                  Linear(inner, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    """LN -> self-attn, LN -> cross-attn, LN -> GEGLU FF, all residual."""

    def __init__(self, dim: int, heads: int, dim_head: int, cross_dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads, dim_head)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, heads, dim_head, cross_dim=cross_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForwardGEGLU(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """Spatial transformer: GN -> proj_in -> blocks over H*W tokens ->
    proj_out -> + residual. Linear projections (SD2) or 1x1 convs (SD1)."""

    def __init__(self, channels: int, heads: int, cross_dim: int,
                 groups: int = 32, depth: int = 1,
                 use_linear_projection: bool = True):
        super().__init__()
        self.use_linear_projection = use_linear_projection
        self.norm = GroupNorm(groups, channels, eps=1e-6)
        proj = Linear if use_linear_projection else (
            lambda i, o: Conv2d(i, o, 1))
        self.proj_in = proj(channels, channels)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(channels, heads, channels // heads, cross_dim)
            for _ in range(depth)])
        self.proj_out = proj(channels, channels)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        hidden = self.norm(x)
        if not self.use_linear_projection:
            hidden = self.proj_in(hidden)
        # channels_last: the (B, H*W, C) token view is free
        hidden = hidden.permute(0, 2, 3, 1).reshape(b, h * w, c)
        if self.use_linear_projection:
            hidden = self.proj_in(hidden)
        for block in self.transformer_blocks:
            hidden = block(hidden, context)
        if self.use_linear_projection:
            hidden = self.proj_out(hidden)
        hidden = hidden.reshape(b, h, w, c).permute(0, 3, 1, 2)
        if not self.use_linear_projection:
            hidden = self.proj_out(hidden.contiguous(memory_format=CHANNELS_LAST))
        return hidden + x


class Downsample(nn.Module):
    """Stride-2 3x3 conv (diffusers Downsample2D)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample(nn.Module):
    """Nearest 2x upsample + 3x3 conv (diffusers Upsample2D)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.interpolate(x, scale_factor=2.0, mode="nearest")
        return self.conv(x.contiguous(memory_format=CHANNELS_LAST))


@torch.no_grad()
def init_like_flax_(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights as flax's defaults draw them, so random-weight serving
    behaves like the JAX package's `init_params`: lecun-normal (truncated)
    kernels, zero biases, unit/zero norms, 1/sqrt(dim) embeddings (or the
    module's `flax_init_std`)."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            # flax truncates at 2 standard units and rescales so the
            # truncated distribution has variance 1/fan_in
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            std = getattr(m, "flax_init_std", m.embedding_dim ** -0.5)
            nn.init.normal_(m.weight, 0.0, std, generator=generator)
        elif isinstance(m, (nn.LayerNorm, GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
