"""SD3's MMDiT: the multimodal diffusion transformer of Stable Diffusion 3
(Esser et al. 2024, "Scaling Rectified Flow Transformers for
High-Resolution Image Synthesis", arXiv:2403.03206).

Module and parameter names are diffusers' `SD3Transformer2DModel`'s, so its
state_dict loads as it is (`pos_embed.pos_embed`, the fixed position table,
is a buffer there too). SD3-medium (`SD3_MEDIUM`, the published
`transformer/config.json`): 24 blocks of width 1,536 (24 heads of 64),
16-channel latents in 2x2 patches, text states of width 4,096 and pooled
text of width 2,048; 2,028,328,000 parameters.

A block holds two token streams, image and text, each with its own
weights, joined only by one attention over their concatenation
[image; text]. Each stream's two sublayers (attention, GELU MLP) are
adaLN-Zero: a LayerNorm with no affine, modulated by a shift and a scale,
and a gated residual, the shift, scale and gate computed from the
conditioning vector c (timestep embedding + pooled text projection). The
last block (`context_pre_only`) modulates the text stream by scale and
shift only, and its text stream stops after the attention's inputs: as in
diffusers, its text queries are computed and attend, and what they attend
to is dropped (no `to_add_out`), so `add_q_proj` there gets a zero
gradient. Every joint attention is thus 4,250 queries over 4,250 keys at
1,024px.

Precision, as the port's other networks: fp32 parameters, the compute
dtype is the module's `dtype` (bf16 at full width). `Linear` and
`Conv2d` (`models/layers.py`) read the training step's bf16 copy of their
weights inside the Trainer's scope and cast them per call elsewhere
(`ops/working_copy.py`); LayerNorm
computes its statistics in fp32 and returns the compute dtype, and the
modulation and the gated residuals run in the compute dtype. The joint
attention goes through `ops.attention.multi_head_attention`: on the card,
in bf16, it runs the flash kernels, which mask the ragged tail of
4,250 = 66 x 64 + 26 tokens. The output is fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from diffusion_torch.models.layers import (Conv2d, Linear, TimestepEmbedding,
                                           timestep_embedding)
from diffusion_torch.ops.attention import multi_head_attention

__all__ = ["MMDiTConfig", "SD3_MEDIUM", "MMDiT", "sincos_pos_embed"]


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    """diffusers' `SD3Transformer2DModel` config keys."""

    sample_size: int = 128
    patch_size: int = 2
    in_channels: int = 16
    out_channels: int = 16
    num_layers: int = 24
    attention_head_dim: int = 64
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096
    caption_projection_dim: int = 1536
    pooled_projection_dim: int = 2048
    pos_embed_max_size: int = 192

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim


SD3_MEDIUM = MMDiTConfig()


def sincos_pos_embed(dim: int, grid: int, base_size: int) -> torch.Tensor:
    """diffusers' `get_2d_sincos_pos_embed(dim, grid, base_size=base_size)`
    (float32, (grid * grid, dim)): positions arange(grid) / (grid /
    base_size) on each axis, token i * grid + j at row i, column j; the
    first half of the channels encodes the column, the second the row,
    each as [sin, cos] at frequencies 10000^(-k / (dim / 4))."""
    pos = np.arange(grid, dtype=np.float32) / (grid / base_size)
    cols, rows = np.meshgrid(pos, pos)      # cols[i, j] = pos[j]
    omega = 1.0 / 10000 ** (np.arange(dim // 4, dtype=np.float64)
                            / (dim / 4.0))

    def one_axis(p):
        out = np.einsum("m,d->md", p.reshape(-1).astype(np.float64), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)
    table = np.concatenate([one_axis(cols), one_axis(rows)], axis=1)
    return torch.from_numpy(table.astype(np.float32))


def _modulate(x: torch.Tensor, shift: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """LayerNorm without affine (eps 1e-6, fp32 statistics) of (B, S, D)
    tokens, then x (1 + scale) + shift per sample."""
    h = F.layer_norm(x, x.shape[-1:], eps=1e-6)
    return torch.addcmul(shift[:, None], h, 1.0 + scale[:, None])


class PatchEmbed(nn.Module):
    """2x2 patches of the latents (`proj`, a stride-2 convolution) as
    tokens, row by row, plus the fixed 2-D sin-cos table, built on the
    `pos_embed_max_size` grid and centre-cropped to the patch grid."""

    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        self.max_size = cfg.pos_embed_max_size
        self.proj = Conv2d(cfg.in_channels, cfg.inner_dim, cfg.patch_size,
                           stride=cfg.patch_size)
        table = sincos_pos_embed(cfg.inner_dim, cfg.pos_embed_max_size,
                                 cfg.sample_size // cfg.patch_size)
        self.register_buffer("pos_embed", table[None].to(
            self.proj.weight.device))

    def cropped(self, height: int, width: int) -> torch.Tensor:
        """The table's centre (1, height * width, D)."""
        top, left = (self.max_size - height) // 2, (self.max_size - width) // 2
        grid = self.pos_embed.reshape(1, self.max_size, self.max_size, -1)
        return grid[:, top:top + height, left:left + width].reshape(
            1, height * width, -1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.proj(x)
        b, d, rows, cols = h.shape
        tokens = h.flatten(2).transpose(1, 2)
        return tokens + self.cropped(rows, cols).to(tokens.dtype)


class TimeTextEmbed(nn.Module):
    """c = MLP(sinusoid(t)) + MLP(pooled text), each MLP linear_1, SiLU,
    linear_2 (diffusers' TimestepEmbedding and PixArtAlphaTextProjection):
    the 256-channel sinusoid (cos first, shift 0) of the timesteps as
    given (SD3 passes t x 1000)."""

    def __init__(self, dim: int, pooled_dim: int):
        super().__init__()
        self.timestep_embedder = TimestepEmbedding(256, dim)
        self.text_embedder = TimestepEmbedding(pooled_dim, dim)

    def forward(self, timesteps: torch.Tensor,
                pooled: torch.Tensor) -> torch.Tensor:
        emb = timestep_embedding(timesteps, 256, flip_sin_to_cos=True,
                                 downscale_freq_shift=0.0)
        return (self.timestep_embedder(emb.to(pooled.dtype))
                + self.text_embedder(pooled))


class AdaLayerNormZero(nn.Module):
    """linear(SiLU(c)) -> shift, scale, gate of the attention, then of the
    MLP; applies the attention's shift and scale."""

    def __init__(self, dim: int):
        super().__init__()
        self.linear = Linear(dim, 6 * dim)

    def forward(self, x: torch.Tensor, c: torch.Tensor):
        shift, scale, gate, shift_mlp, scale_mlp, gate_mlp = self.linear(
            F.silu(c)).chunk(6, dim=1)
        return _modulate(x, shift, scale), gate, shift_mlp, scale_mlp, \
            gate_mlp


class AdaLayerNormContinuous(nn.Module):
    """linear(SiLU(c)) -> scale, then shift (in that order), applied."""

    def __init__(self, dim: int):
        super().__init__()
        self.linear = Linear(dim, 2 * dim)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        scale, shift = self.linear(F.silu(c)).chunk(2, dim=1)
        return _modulate(x, shift, scale)


class JointAttention(nn.Module):
    """One attention over [image; text] tokens, each stream with its own
    q, k, v and output projections (all with bias). `context_pre_only`:
    the text's share of the output is dropped."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 context_pre_only: bool):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.context_pre_only = context_pre_only
        self.to_q, self.to_k, self.to_v = (Linear(dim, inner)
                                           for _ in range(3))
        self.add_q_proj, self.add_k_proj, self.add_v_proj = (
            Linear(dim, inner) for _ in range(3))
        self.to_out = nn.ModuleList([Linear(inner, dim), nn.Identity()])
        if not context_pre_only:
            self.to_add_out = Linear(inner, dim)

    def forward(self, x: torch.Tensor, ctx: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        b, n, _ = x.shape
        joint = n + ctx.shape[1]
        q, k, v = (torch.cat([own(x), added(ctx)], dim=1).view(
            b, joint, self.heads, self.dim_head) for own, added in (
                (self.to_q, self.add_q_proj), (self.to_k, self.add_k_proj),
                (self.to_v, self.add_v_proj)))
        o = multi_head_attention(q, k, v).reshape(b, joint, -1)
        if self.context_pre_only:
            return self.to_out[0](o[:, :n]), None
        return self.to_out[0](o[:, :n]), self.to_add_out(o[:, n:])


class _GELUProj(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, inner)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.proj(x), approximate="tanh")


class FeedForward(nn.Module):
    """net.0 = Linear(D, 4D) + GELU (tanh), net.2 = Linear(4D, D)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([_GELUProj(dim, dim * mult), nn.Identity(),
                                  Linear(dim * mult, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class JointTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int,
                 context_pre_only: bool):
        super().__init__()
        self.context_pre_only = context_pre_only
        self.norm1 = AdaLayerNormZero(dim)
        self.norm1_context = (AdaLayerNormContinuous(dim) if context_pre_only
                              else AdaLayerNormZero(dim))
        self.attn = JointAttention(dim, heads, dim_head, context_pre_only)
        self.ff = FeedForward(dim)
        if not context_pre_only:
            self.ff_context = FeedForward(dim)

    def forward(self, x: torch.Tensor, ctx: torch.Tensor, c: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        h, gate, shift_mlp, scale_mlp, gate_mlp = self.norm1(x, c)
        if self.context_pre_only:
            attn, _ = self.attn(h, self.norm1_context(ctx, c))
        else:
            hc, c_gate, c_shift_mlp, c_scale_mlp, c_gate_mlp = \
                self.norm1_context(ctx, c)
            attn, attn_ctx = self.attn(h, hc)
        x = torch.addcmul(x, gate[:, None], attn)
        x = torch.addcmul(x, gate_mlp[:, None],
                          self.ff(_modulate(x, shift_mlp, scale_mlp)))
        if self.context_pre_only:
            return x, None
        ctx = torch.addcmul(ctx, c_gate[:, None], attn_ctx)
        ctx = torch.addcmul(ctx, c_gate_mlp[:, None], self.ff_context(
            _modulate(ctx, c_shift_mlp, c_scale_mlp)))
        return x, ctx


class MMDiT(nn.Module):
    """(B, C, H, W) latents, timesteps (B,) as the model sees them (t x
    1000), text states (B, T, joint_attention_dim) and pooled text
    (B, pooled_projection_dim) -> the velocity (B, C, H, W), fp32."""

    # read by the Trainer and its step graph as they read the UNet's: this
    # network has no dropout
    drops = False

    def __init__(self, config: MMDiTConfig = SD3_MEDIUM,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config, self.dtype = config, dtype
        dim = config.inner_dim
        self.pos_embed = PatchEmbed(config)
        self.time_text_embed = TimeTextEmbed(dim,
                                             config.pooled_projection_dim)
        self.context_embedder = Linear(config.joint_attention_dim,
                                       config.caption_projection_dim)
        last = config.num_layers - 1
        self.transformer_blocks = nn.ModuleList([
            JointTransformerBlock(dim, config.num_attention_heads,
                                  config.attention_head_dim, i == last)
            for i in range(config.num_layers)])
        self.norm_out = AdaLayerNormContinuous(dim)
        p = config.patch_size
        self.proj_out = Linear(dim, p * p * config.out_channels)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                pooled_projections: torch.Tensor) -> torch.Tensor:
        dtype, p = self.dtype, self.config.patch_size
        b, _, height, width = sample.shape
        x = self.pos_embed(sample.to(dtype))
        c = self.time_text_embed(timesteps, pooled_projections.to(dtype))
        ctx = self.context_embedder(encoder_hidden_states.to(dtype))
        for block in self.transformer_blocks:
            x, ctx = block(x, ctx, c)
        x = self.proj_out(self.norm_out(x, c))
        rows, cols = height // p, width // p
        x = x.float().reshape(b, rows, cols, p, p, self.config.out_channels)
        return torch.einsum("nhwpqc->nchpwq", x).reshape(
            b, self.config.out_channels, height, width)
