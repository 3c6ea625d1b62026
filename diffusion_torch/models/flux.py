"""FLUX.1's transformer: the rectified-flow diffusion transformer of Black
Forest Labs' FLUX.1 (`github.com/black-forest-labs/flux`,
`src/flux/model.py` and `src/flux/modules/layers.py`).

Module and parameter names are diffusers' `FluxTransformer2DModel`'s, so
its state_dict loads as it is. FLUX.1-dev (`FLUX_DEV`, the published
`transformer/config.json`): 19 double-stream and 38 single-stream blocks of
width 3,072 (24 heads of 128), 16-channel latents packed 2x2 into 64
channels, T5 states of width 4,096, pooled CLIP text of width 768, a
guidance embedding; 11,901,408,320 parameters.

Where it differs from SD3's MMDiT (`models/mmdit.py`, whose adaLN pieces,
feed-forward and timestep embedding it reuses):

- tokens are the latents packed 2x2 (`pack`: (B, 16, H, W) ->
  (B, H/2 * W/2, 64), row by row), then `x_embedder`; text goes through
  `context_embedder`. The joint sequence is [text; image].
- positions are rotary, in 2-D: image token (r, c) has ids (0, r, c),
  text tokens (0, 0, 0). Axis i of width d_i in `axes_dims_rope`
  (16, 56, 56) turns d_i / 2 channel pairs by pos * theta^(-2j / d_i),
  theta = 10^4: 64 angles a token, pair (2j, 2j + 1) of q and k rotated
  as (x0 cos - x1 sin, x0 sin + x1 cos). The table is computed in fp64,
  kept as fp32 cos and sin, and built once per sequence shape.
- q and k take an RMSNorm per head (eps 1e-6, fp32 statistics, a learned
  scale of 128) before the rotation. The norm, the scale and the rotation
  run in fp32 in one chain and round to the compute dtype once.
- a double-stream block (`transformer_blocks`) is SD3's block with those
  q/k norms and the rotation, text first; a single-stream block
  (`single_transformer_blocks`) runs over the joint sequence with one set
  of weights: one modulated input h feeds the attention (no output
  projection) and an MLP (`proj_mlp`, GELU tanh) side by side, and
  x <- x + gate * proj_out([attention, mlp]).
- c = timestep + guidance + pooled-text embeddings; after the last single
  block the text tokens are dropped before `norm_out` and `proj_out`.

Precision, as `mmdit.py`: fp32 parameters, the compute dtype is the
module's `dtype` (bf16 at full width); `Linear` and the q/k norms' scales
read the training step's bf16 working copy (`ops/working_copy.py`). The
joint attention goes through `ops.attention.multi_head_attention`: on the
card, in bf16, the flash kernels at head dim 128. The output is fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from diffusion_torch.models.layers import (Linear, TimestepEmbedding,
                                           timestep_embedding)
from diffusion_torch.models.mmdit import (AdaLayerNormContinuous,
                                          AdaLayerNormZero, FeedForward,
                                          _modulate)
from diffusion_torch.ops.attention import multi_head_attention
from diffusion_torch.ops.working_copy import operands

__all__ = ["FluxConfig", "FLUX_DEV", "FluxTransformer", "RMSNorm", "pack",
           "unpack", "image_ids", "rope_table", "rotate"]


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    """diffusers' `FluxTransformer2DModel` config keys."""

    patch_size: int = 1
    in_channels: int = 64
    out_channels: Optional[int] = None
    num_layers: int = 19
    num_single_layers: int = 38
    attention_head_dim: int = 128
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096
    pooled_projection_dim: int = 768
    guidance_embeds: bool = True
    axes_dims_rope: Tuple[int, ...] = (16, 56, 56)

    def __post_init__(self):
        if self.patch_size != 1:
            raise ValueError("FLUX packs latents 2x2 itself; patch_size "
                             f"must be 1, not {self.patch_size}")
        if sum(self.axes_dims_rope) != self.attention_head_dim:
            raise ValueError(f"axes_dims_rope {self.axes_dims_rope} must sum "
                             f"to the head dim {self.attention_head_dim}")
        object.__setattr__(self, "axes_dims_rope",
                           tuple(self.axes_dims_rope))

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim


FLUX_DEV = FluxConfig()
THETA = 10000.0


def pack(latents: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H/2 * W/2, 4C): 2x2 patches row by row, channel
    c of patch offset (dy, dx) at 4c + 2dy + dx."""
    b, c, h, w = latents.shape
    return latents.reshape(b, c, h // 2, 2, w // 2, 2).permute(
        0, 2, 4, 1, 3, 5).reshape(b, (h // 2) * (w // 2), c * 4)


def unpack(tokens: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """The inverse of `pack` for (height, width) latents."""
    b, _, d = tokens.shape
    c = d // 4
    return tokens.reshape(b, height // 2, width // 2, c, 2, 2).permute(
        0, 3, 1, 4, 2, 5).reshape(b, c, height, width)


def image_ids(rows: int, cols: int, text: int) -> torch.Tensor:
    """(text + rows * cols, 3) position ids, fp64: (0, 0, 0) for each text
    token, then (0, r, c) for image token (r, c), row by row."""
    r = torch.arange(rows, dtype=torch.float64).repeat_interleave(cols)
    c = torch.arange(cols, dtype=torch.float64).repeat(rows)
    img = torch.stack([torch.zeros_like(r), r, c], dim=1)
    return torch.cat([torch.zeros(text, 3, dtype=torch.float64), img])


def rope_table(ids: torch.Tensor, axes: Tuple[int, ...],
               theta: float = THETA) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (cos, sin) of shape (S, sum(axes) / 2): the angles pos * omega
    of each axis in fp64, concatenated over the axes."""
    angles = []
    for i, d in enumerate(axes):
        omega = theta ** (-torch.arange(0, d, 2, dtype=torch.float64) / d)
        angles.append(ids[:, i, None].double() * omega[None])
    a = torch.cat(angles, dim=1)
    return torch.cos(a).float(), torch.sin(a).float()


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """Turn channel pair (2j, 2j + 1) of (B, S, H, D) x by the angle of
    (cos, sin) (S, 1, D / 2): (x0 cos - x1 sin, x0 sin + x1 cos)."""
    x0, x1 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos],
                       dim=-1).flatten(-2)


class RMSNorm(nn.Module):
    """RMSNorm over the last dim with a learned scale (`weight`), eps 1e-6;
    its scale comes from `operands` as a `Linear`'s weight does, so the
    step's working copy covers it."""

    casts_weights = True

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.register_parameter("bias", None)

    def scaled(self, x: torch.Tensor) -> torch.Tensor:
        """x normalized and scaled, in fp32."""
        w = operands(self.weight, None, x.dtype)[0]
        xf = x.float()
        return xf * torch.rsqrt(xf.square().mean(-1, keepdim=True)
                                + self.eps) * w.float()


def _qk(x: torch.Tensor, norm: RMSNorm, rope) -> torch.Tensor:
    """RMSNorm of (B, S, H, D) queries or keys, then the rotation, in fp32;
    rounded once to x's dtype."""
    return rotate(norm.scaled(x), *rope).to(x.dtype)


class FluxAttention(nn.Module):
    """q, k, v (with bias) and their per-head RMSNorms; with `context`, the
    text stream's own projections and norms (`add_*_proj`,
    `norm_added_*`) and both output projections (`to_out.0`,
    `to_add_out`); without, the single block's pre-only attention."""

    def __init__(self, dim: int, heads: int, dim_head: int, context: bool):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.context = heads, dim_head, context
        self.to_q, self.to_k, self.to_v = (Linear(dim, inner)
                                           for _ in range(3))
        self.norm_q, self.norm_k = RMSNorm(dim_head), RMSNorm(dim_head)
        if context:
            self.add_q_proj, self.add_k_proj, self.add_v_proj = (
                Linear(dim, inner) for _ in range(3))
            self.norm_added_q = RMSNorm(dim_head)
            self.norm_added_k = RMSNorm(dim_head)
            self.to_out = nn.ModuleList([Linear(inner, dim), nn.Identity()])
            self.to_add_out = Linear(inner, dim)

    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        return t.view(*t.shape[:2], self.heads, self.dim_head)

    def _qkv(self, x, q, k, v, nq, nk, rope):
        return (_qk(self._heads(q(x)), nq, rope),
                _qk(self._heads(k(x)), nk, rope), self._heads(v(x)))

    def forward(self, x: torch.Tensor, rope, ctx=None):
        """x (B, S, D) and, with `context`, the text ctx (B, T, D): the
        attention over [ctx; x], as (image, text) outputs with `context`,
        else as one (B, S, inner) tensor."""
        cos, sin = rope
        if ctx is None:
            q, k, v = self._qkv(x, self.to_q, self.to_k, self.to_v,
                                self.norm_q, self.norm_k, rope)
            return multi_head_attention(q, k, v).flatten(2)
        t = ctx.shape[1]
        qc, kc, vc = self._qkv(ctx, self.add_q_proj, self.add_k_proj,
                               self.add_v_proj, self.norm_added_q,
                               self.norm_added_k, (cos[:t], sin[:t]))
        qx, kx, vx = self._qkv(x, self.to_q, self.to_k, self.to_v,
                               self.norm_q, self.norm_k,
                               (cos[t:], sin[t:]))
        o = multi_head_attention(torch.cat([qc, qx], dim=1),
                                 torch.cat([kc, kx], dim=1),
                                 torch.cat([vc, vx], dim=1)).flatten(2)
        return self.to_out[0](o[:, t:]), self.to_add_out(o[:, :t])


class FluxTransformerBlock(nn.Module):
    """A double-stream block: SD3's adaLN-Zero block over image and text
    with the q/k norms and the rotation, text first."""

    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.norm1 = AdaLayerNormZero(dim)
        self.norm1_context = AdaLayerNormZero(dim)
        self.attn = FluxAttention(dim, heads, dim_head, context=True)
        self.ff = FeedForward(dim)
        self.ff_context = FeedForward(dim)

    def forward(self, x, ctx, c, rope):
        h, gate, shift_mlp, scale_mlp, gate_mlp = self.norm1(x, c)
        hc, c_gate, c_shift_mlp, c_scale_mlp, c_gate_mlp = \
            self.norm1_context(ctx, c)
        attn, attn_ctx = self.attn(h, rope, hc)
        x = torch.addcmul(x, gate[:, None], attn)
        x = torch.addcmul(x, gate_mlp[:, None],
                          self.ff(_modulate(x, shift_mlp, scale_mlp)))
        ctx = torch.addcmul(ctx, c_gate[:, None], attn_ctx)
        ctx = torch.addcmul(ctx, c_gate_mlp[:, None], self.ff_context(
            _modulate(ctx, c_shift_mlp, c_scale_mlp)))
        return x, ctx


class AdaLayerNormZeroSingle(nn.Module):
    """linear(SiLU(c)) -> shift, scale, gate; applies shift and scale."""

    def __init__(self, dim: int):
        super().__init__()
        self.linear = Linear(dim, 3 * dim)

    def forward(self, x: torch.Tensor, c: torch.Tensor):
        shift, scale, gate = self.linear(F.silu(c)).chunk(3, dim=1)
        return _modulate(x, shift, scale), gate


class FluxSingleTransformerBlock(nn.Module):
    """A single-stream block over the joint [text; image] sequence."""

    def __init__(self, dim: int, heads: int, dim_head: int, mlp: int = 4):
        super().__init__()
        self.norm = AdaLayerNormZeroSingle(dim)
        self.proj_mlp = Linear(dim, mlp * dim)
        self.attn = FluxAttention(dim, heads, dim_head, context=False)
        self.proj_out = Linear(dim + mlp * dim, dim)

    def forward(self, x, c, rope):
        h, gate = self.norm(x, c)
        mlp = F.gelu(self.proj_mlp(h), approximate="tanh")
        out = self.proj_out(torch.cat([self.attn(h, rope), mlp], dim=2))
        return torch.addcmul(x, gate[:, None], out)


class TimeGuidanceTextEmbed(nn.Module):
    """c = (MLP(sinusoid(t)) + MLP(sinusoid(g))) + MLP(pooled text), each
    MLP linear_1, SiLU, linear_2; 256-channel sinusoids, cos first, shift
    0, of t and the guidance g as given (x 1000)."""

    def __init__(self, dim: int, pooled_dim: int, guidance: bool):
        super().__init__()
        self.timestep_embedder = TimestepEmbedding(256, dim)
        if guidance:
            self.guidance_embedder = TimestepEmbedding(256, dim)
        self.text_embedder = TimestepEmbedding(pooled_dim, dim)

    def forward(self, timesteps, pooled, guidance=None):
        def embed(mlp, t):
            return mlp(timestep_embedding(t, 256, flip_sin_to_cos=True,
                                          downscale_freq_shift=0.0
                                          ).to(pooled.dtype))
        c = embed(self.timestep_embedder, timesteps)
        if guidance is not None:
            c = c + embed(self.guidance_embedder, guidance)
        return c + self.text_embedder(pooled)


class FluxTransformer(nn.Module):
    """(B, C, H, W) latents, timesteps (B,) as the model sees them (t x
    1000), T5 states (B, T, joint_attention_dim), pooled text
    (B, pooled_projection_dim) and guidance (B,) x 1000 -> the velocity
    (B, C, H, W), fp32."""

    # read by the Trainer and its step graph as they read the UNet's: this
    # network has no dropout
    drops = False

    def __init__(self, config: FluxConfig = FLUX_DEV,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config, self.dtype = config, dtype
        dim, heads = config.inner_dim, config.num_attention_heads
        d = config.attention_head_dim
        out = config.out_channels or config.in_channels
        self.x_embedder = Linear(config.in_channels, dim)
        self.context_embedder = Linear(config.joint_attention_dim, dim)
        self.time_text_embed = TimeGuidanceTextEmbed(
            dim, config.pooled_projection_dim, config.guidance_embeds)
        self.transformer_blocks = nn.ModuleList([
            FluxTransformerBlock(dim, heads, d)
            for _ in range(config.num_layers)])
        self.single_transformer_blocks = nn.ModuleList([
            FluxSingleTransformerBlock(dim, heads, d)
            for _ in range(config.num_single_layers)])
        self.norm_out = AdaLayerNormContinuous(dim)
        self.proj_out = Linear(dim, out)
        self._ropes: Dict[tuple, tuple] = {}

    @property
    def latent_channels(self) -> int:
        """The latents' channels, before the 2x2 packing."""
        return self.config.in_channels // 4

    def rope(self, text: int, rows: int, cols: int, device) -> tuple:
        """(cos, sin) (text + rows * cols, 1, head dim / 2) of the joint
        sequence, fp32, built once per shape and device."""
        key = (text, rows, cols, str(device))
        if key not in self._ropes:
            cos, sin = rope_table(image_ids(rows, cols, text),
                                  self.config.axes_dims_rope)
            self._ropes[key] = (cos[:, None].to(device),
                                sin[:, None].to(device))
        return self._ropes[key]

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                pooled_projections: torch.Tensor,
                guidance: Optional[torch.Tensor] = None) -> torch.Tensor:
        dtype = self.dtype
        _, _, height, width = sample.shape
        x = self.x_embedder(pack(sample.to(dtype)))
        c = self.time_text_embed(timesteps, pooled_projections.to(dtype),
                                 guidance)
        ctx = self.context_embedder(encoder_hidden_states.to(dtype))
        text = ctx.shape[1]
        rope = self.rope(text, height // 2, width // 2, x.device)
        for block in self.transformer_blocks:
            x, ctx = block(x, ctx, c, rope)
        x = torch.cat([ctx, x], dim=1)
        for block in self.single_transformer_blocks:
            x = block(x, c, rope)
        x = self.proj_out(self.norm_out(x[:, text:], c))
        return unpack(x.float(), height, width)
