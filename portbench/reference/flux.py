"""The plain reference FLUX.1 transformer: diffusers' FluxTransformer2DModel
in plain torch, float32, trained by `reference/mmdit.py`'s rectified-flow
loss and steps.

Written from the layer list of Black Forest Labs' reference code
(`github.com/black-forest-labs/flux`, `src/flux/model.py`,
`src/flux/modules/layers.py`) and diffusers' `transformer_flux.py`; module
and parameter names are diffusers' own, so a diffusers `state_dict` loads
as it is. It imports nothing of the program. Attention is a matmul, a
softmax and a matmul, so a FLOP count of it counts the model's work.

Semantics:
- latents (B, C, H, W) packed 2x2 into (B, H/2 * W/2, 4C), channel c of
  patch offset (dy, dx) at 4c + 2dy + dx, row by row; `x_embedder`;
  `context_embedder` on the T5 states; the joint sequence is
  [text; image]; unpacked at the end.
- positions (BFL's `EmbedND`): ids (0, 0, 0) for text, (0, r, c) for image
  token (r, c); axis i of width d_i in `axes_dims_rope` gives angles
  pos * theta^(-2j / d_i), j < d_i / 2, theta = 10^4, in float64;
  channel pair (2j, 2j + 1) of q and k is one complex number multiplied by
  e^(i angle).
- c = timestep_embedder(sinusoid(t x 1000)) + guidance_embedder(
  sinusoid(g x 1000)) + text_embedder(pooled); 256-channel sinusoids, cos
  first; each embedder linear_1 -> SiLU -> linear_2.
- double block: adaLN-Zero (6 vectors a stream), q/k/v with bias, RMSNorm
  per head on q and k (eps 1e-6, learned scale), the rotation, one
  attention over [text; image], `to_out.0` / `to_add_out`, gated
  residuals; LayerNorm, modulate, GELU(tanh) MLP, gated residual.
- single block: linear(SiLU(c)) -> shift, scale, gate; h = LN(x)(1 +
  scale) + shift; attention (no output projection) and GELU(tanh)
  `proj_mlp` on the same h; x + gate * proj_out([attention, mlp]).
- the text tokens dropped, `norm_out` (scale, then shift), `proj_out`.

Departures, none of which changes the function: the guidance g is the
module's `guidance` for every sample (so that `reference/mmdit.py`'s
`flow_loss` and `train_steps` call it as they call the MMDiT); attention
runs by query blocks (`attn_rows`); `checkpoint_blocks=True` recomputes
each block in the backward under the torch-function modes its forward ran
under, as `reference/mmdit.py` does. Everything is float32; the harness
turns TF32 off.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.mmdit import (_FeedForward, _MLP2, _ln,
                                       _recompute_as_forward,
                                       timestep_sinusoid)

__all__ = ["Flux", "flux_spec", "freqs_cis"]

_KEYS = ("in_channels", "num_layers", "num_single_layers",
         "attention_head_dim", "num_attention_heads", "joint_attention_dim",
         "pooled_projection_dim", "guidance_embeds", "axes_dims_rope")


def flux_spec(transformer: dict) -> dict:
    """The construction spec of a diffusers `transformer/config.json`."""
    spec = {k: transformer[k] for k in _KEYS}
    spec["axes_dims_rope"] = list(spec["axes_dims_rope"])
    return spec


def freqs_cis(spec: dict, text: int, rows: int, cols: int,
              device) -> torch.Tensor:
    """e^(i angle) (text + rows * cols, head dim / 2), complex64."""
    ids = torch.zeros(text + rows * cols, 3, dtype=torch.float64,
                      device=device)
    grid = torch.stack(torch.meshgrid(
        torch.arange(rows, dtype=torch.float64, device=device),
        torch.arange(cols, dtype=torch.float64, device=device),
        indexing="ij"), dim=-1).reshape(-1, 2)
    ids[text:, 1:] = grid
    parts = []
    for i, d in enumerate(spec["axes_dims_rope"]):
        omega = 1.0 / 10000.0 ** (torch.arange(
            0, d, 2, dtype=torch.float64, device=device) / d)
        parts.append(torch.outer(ids[:, i], omega))
    angles = torch.cat(parts, dim=1)
    return torch.polar(torch.ones_like(angles), angles).to(torch.complex64)


def _rope(x, cis):
    """x (B, H, S, D) with pair (2j, 2j + 1) as one complex number, times
    cis (S, D / 2)."""
    z = torch.view_as_complex(x.reshape(*x.shape[:-1], -1, 2).contiguous())
    return torch.view_as_real(z * cis).flatten(-2)


class _RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6) \
            * self.weight


class _Embed(nn.Module):
    def __init__(self, dim: int, pooled: int, guidance: bool):
        super().__init__()
        self.timestep_embedder = _MLP2(256, dim)
        if guidance:
            self.guidance_embedder = _MLP2(256, dim)
        self.text_embedder = _MLP2(pooled, dim)


class _Ada(nn.Module):
    def __init__(self, dim: int, n: int):
        super().__init__()
        self.linear = nn.Linear(dim, n * dim)


class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, joint: bool):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.joint = heads, dim_head, joint
        self.to_q = nn.Linear(dim, inner)
        self.to_k = nn.Linear(dim, inner)
        self.to_v = nn.Linear(dim, inner)
        self.norm_q = _RMSNorm(dim_head)
        self.norm_k = _RMSNorm(dim_head)
        if joint:
            self.add_q_proj = nn.Linear(dim, inner)
            self.add_k_proj = nn.Linear(dim, inner)
            self.add_v_proj = nn.Linear(dim, inner)
            self.norm_added_q = _RMSNorm(dim_head)
            self.norm_added_k = _RMSNorm(dim_head)
            self.to_out = nn.ModuleList([nn.Linear(inner, dim),
                                         nn.Dropout(0.0)])
            self.to_add_out = nn.Linear(inner, dim)

    def _split(self, t):
        b, s, _ = t.shape
        return t.view(b, s, self.heads, self.dim_head).transpose(1, 2)

    def forward(self, x, cis, attn_rows, ctx=None):
        q = self.norm_q(self._split(self.to_q(x)))
        k = self.norm_k(self._split(self.to_k(x)))
        v = self._split(self.to_v(x))
        if ctx is not None:
            q = torch.cat([self.norm_added_q(self._split(
                self.add_q_proj(ctx))), q], dim=2)
            k = torch.cat([self.norm_added_k(self._split(
                self.add_k_proj(ctx))), k], dim=2)
            v = torch.cat([self._split(self.add_v_proj(ctx)), v], dim=2)
        q, k = _rope(q, cis), _rope(k, cis)
        rows = attn_rows or q.shape[2]
        o = torch.cat([torch.softmax(
            q[:, :, r:r + rows] @ k.transpose(-1, -2)
            * self.dim_head ** -0.5, dim=-1) @ v
            for r in range(0, q.shape[2], rows)], dim=2)
        o = o.transpose(1, 2).reshape(x.shape[0], q.shape[2], -1)
        if ctx is None:
            return o
        t = ctx.shape[1]
        return self.to_out[0](o[:, t:]), self.to_add_out(o[:, :t])


class _DoubleBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.norm1 = _Ada(dim, 6)
        self.norm1_context = _Ada(dim, 6)
        self.attn = _Attention(dim, heads, dim_head, joint=True)
        self.ff = _FeedForward(dim)
        self.ff_context = _FeedForward(dim)

    def forward(self, x, ctx, c, cis, attn_rows=None):
        sh, sc, g, sh2, sc2, g2 = self.norm1.linear(F.silu(c)).chunk(6, 1)
        csh, csc, cg, csh2, csc2, cg2 = self.norm1_context.linear(
            F.silu(c)).chunk(6, 1)
        a, ac = self.attn(_ln(x) * (1 + sc[:, None]) + sh[:, None], cis,
                          attn_rows,
                          _ln(ctx) * (1 + csc[:, None]) + csh[:, None])
        x = x + g[:, None] * a
        x = x + g2[:, None] * self.ff(_ln(x) * (1 + sc2[:, None])
                                      + sh2[:, None])
        ctx = ctx + cg[:, None] * ac
        ctx = ctx + cg2[:, None] * self.ff_context(
            _ln(ctx) * (1 + csc2[:, None]) + csh2[:, None])
        return x, ctx


class _SingleBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.norm = _Ada(dim, 3)
        self.proj_mlp = nn.Linear(dim, 4 * dim)
        self.attn = _Attention(dim, heads, dim_head, joint=False)
        self.proj_out = nn.Linear(5 * dim, dim)

    def forward(self, x, c, cis, attn_rows=None):
        sh, sc, g = self.norm.linear(F.silu(c)).chunk(3, 1)
        h = _ln(x) * (1 + sc[:, None]) + sh[:, None]
        mlp = F.gelu(self.proj_mlp(h), approximate="tanh")
        return x + g[:, None] * self.proj_out(torch.cat(
            [self.attn(h, cis, attn_rows), mlp], dim=2))


class _AdaContinuous(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.linear = nn.Linear(dim, 2 * dim)


class Flux(nn.Module):
    """(B, C, H, W) latents, t x 1000 (B,), T5 states (B, T, joint dim),
    pooled (B, pooled dim) -> velocity (B, C, H, W), with the guidance
    `guidance` (x 1000) for every sample."""

    def __init__(self, spec: dict, attn_rows: Optional[int] = None,
                 checkpoint_blocks: bool = False, guidance: float = 3.5):
        super().__init__()
        self.spec, self.attn_rows = spec, attn_rows
        self.checkpoint_blocks, self.guidance = checkpoint_blocks, guidance
        heads, d = spec["num_attention_heads"], spec["attention_head_dim"]
        dim = heads * d
        self.x_embedder = nn.Linear(spec["in_channels"], dim)
        self.context_embedder = nn.Linear(spec["joint_attention_dim"], dim)
        self.time_text_embed = _Embed(dim, spec["pooled_projection_dim"],
                                      spec["guidance_embeds"])
        self.transformer_blocks = nn.ModuleList([
            _DoubleBlock(dim, heads, d) for _ in range(spec["num_layers"])])
        self.single_transformer_blocks = nn.ModuleList([
            _SingleBlock(dim, heads, d)
            for _ in range(spec["num_single_layers"])])
        self.norm_out = _AdaContinuous(dim)
        self.proj_out = nn.Linear(dim, spec["in_channels"])

    def _run(self, block, *args):
        if self.checkpoint_blocks and torch.is_grad_enabled():
            return checkpoint(block, *args, self.attn_rows,
                              use_reentrant=False,
                              context_fn=_recompute_as_forward)
        return block(*args, self.attn_rows)

    def forward(self, sample, timesteps, text, pooled):
        b, ch, height, width = sample.shape
        rows, cols = height // 2, width // 2
        x = self.x_embedder(sample.reshape(b, ch, rows, 2, cols, 2).permute(
            0, 2, 4, 1, 3, 5).reshape(b, rows * cols, ch * 4))
        emb = self.time_text_embed
        c = emb.timestep_embedder(timestep_sinusoid(timesteps))
        if self.spec["guidance_embeds"]:
            g = torch.full_like(timesteps, self.guidance * 1000.0)
            c = c + emb.guidance_embedder(timestep_sinusoid(g))
        c = c + emb.text_embedder(pooled)
        ctx = self.context_embedder(text)
        t = ctx.shape[1]
        cis = freqs_cis(self.spec, t, rows, cols, sample.device)
        for block in self.transformer_blocks:
            x, ctx = self._run(block, x, ctx, c, cis)
        x = torch.cat([ctx, x], dim=1)
        for block in self.single_transformer_blocks:
            x = self._run(block, x, c, cis)
        scale, shift = self.norm_out.linear(F.silu(c)).chunk(2, dim=1)
        x = self.proj_out(_ln(x[:, t:]) * (1 + scale[:, None])
                          + shift[:, None])
        return x.reshape(b, rows, cols, ch, 2, 2).permute(
            0, 3, 1, 4, 2, 5).reshape(b, ch, height, width)
