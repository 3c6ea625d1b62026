"""The plain reference MMDiT: diffusers' SD3Transformer2DModel in plain torch,
float32, and SD3's rectified-flow loss.

Written from the layer list of Esser et al. 2024 (arXiv:2403.03206) and
diffusers' `SD3Transformer2DModel` (module and parameter names are
diffusers' own, so a diffusers `state_dict` loads as it is, with the
position table `pos_embed.pos_embed` as a buffer). It imports nothing of
the program. Attention is a matmul, a softmax and a matmul, so a FLOP
count of it counts the model's work, not an implementation's.

Semantics (diffusers):
- PatchEmbed: Conv2d(C, D, p, stride p), flattened row by row, plus the
  2-D sin-cos table of the `pos_embed_max_size` grid (positions
  arange / (grid / (sample_size / p)), the first half of the channels from
  the column, the second from the row, [sin, cos] each), centre-cropped.
- c = timestep_embedder(sinusoid(t), 256 channels, cos first, shift 0) +
  text_embedder(pooled); both are linear_1 -> SiLU -> linear_2.
- Block: AdaLayerNormZero on each stream (linear(SiLU(c)) -> shift, scale,
  gate for the attention, then for the MLP; LayerNorm without affine,
  eps 1e-6; x (1 + scale) + shift); one attention over [image; text]
  (q/k/v with bias, `add_*_proj` for text); to_out / to_add_out; gated
  residuals; LayerNorm, modulate, GELU(tanh) MLP, gated residual.
- Last block (`context_pre_only`): the text's norm is AdaLayerNormContinuous
  (scale, then shift), its queries attend and their output is dropped; no
  to_add_out, no text MLP.
- norm_out: AdaLayerNormContinuous; proj_out; unpatchify
  ("nhwpqc->nchpwq").

Departures, none of which changes the function: the attention runs by
query blocks (`attn_rows`) so that 4,250 x 4,250 scores of 24 heads need not
be held at once; `checkpoint_blocks=True` recomputes each block in the
backward (torch.utils.checkpoint), to hold a 2B-parameter model's fp32
activations on one card. A block is recomputed under the torch-function
modes its forward ran under (the fp8 control's `lowp.Fp8Products`), which
the backward's thread on a card does not hold. Everything is float32; the
harness turns TF32 off.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.overrides import _get_current_function_mode_stack
from torch.utils.checkpoint import checkpoint

__all__ = ["MMDiT", "mmdit_spec", "sincos_table", "flow_loss",
           "flow_targets"]

_KEYS = ("sample_size", "patch_size", "in_channels", "out_channels",
         "num_layers", "attention_head_dim", "num_attention_heads",
         "joint_attention_dim", "caption_projection_dim",
         "pooled_projection_dim", "pos_embed_max_size")


def mmdit_spec(transformer: dict) -> dict:
    """The construction spec of a diffusers `transformer/config.json`."""
    return {k: transformer[k] for k in _KEYS}


def sincos_table(dim: int, grid: int, base_size: int) -> torch.Tensor:
    """diffusers' get_2d_sincos_pos_embed(dim, grid, base_size=base_size)."""
    pos = np.arange(grid, dtype=np.float32) / (grid / base_size)
    grid_w, grid_h = np.meshgrid(pos, pos)
    omega = np.arange(dim // 4, dtype=np.float64) / (dim / 4.0)
    omega = 1.0 / 10000 ** omega

    def emb_1d(p):
        out = np.einsum("m,d->md", p.reshape(-1).astype(np.float64), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)
    return torch.from_numpy(np.concatenate(
        [emb_1d(grid_w), emb_1d(grid_h)], axis=1).astype(np.float32))


def timestep_sinusoid(t: torch.Tensor, dim: int = 256) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


@contextlib.contextmanager
def _modes(modes):
    """Enter those of `modes` this thread does not hold already."""
    with contextlib.ExitStack() as stack:
        held = _get_current_function_mode_stack()
        for mode in modes:
            if not any(mode is h for h in held):
                stack.enter_context(mode)
        yield


def _recompute_as_forward():
    """checkpoint's `context_fn`: the recompute enters the forward's
    torch-function modes."""
    return contextlib.nullcontext(), _modes(
        _get_current_function_mode_stack())


def _ln(x):
    return F.layer_norm(x, x.shape[-1:], eps=1e-6)


class _MLP2(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class _Embed(nn.Module):
    def __init__(self, dim: int, pooled: int):
        super().__init__()
        self.timestep_embedder = _MLP2(256, dim)
        self.text_embedder = _MLP2(pooled, dim)


class _PatchEmbed(nn.Module):
    def __init__(self, s: dict):
        super().__init__()
        dim = s["num_attention_heads"] * s["attention_head_dim"]
        p, grid = s["patch_size"], s["pos_embed_max_size"]
        self.proj = nn.Conv2d(s["in_channels"], dim, p, stride=p)
        self.register_buffer("pos_embed", sincos_table(
            dim, grid, s["sample_size"] // p)[None].to(self.proj.weight.device))


class _AdaZero(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.linear = nn.Linear(dim, 6 * dim)


class _AdaContinuous(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.linear = nn.Linear(dim, 2 * dim)

    def forward(self, x, c):
        scale, shift = self.linear(F.silu(c)).chunk(2, dim=1)
        return _ln(x) * (1 + scale[:, None]) + shift[:, None]


class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, pre_only: bool):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.pre_only = heads, dim_head, pre_only
        self.to_q = nn.Linear(dim, inner)
        self.to_k = nn.Linear(dim, inner)
        self.to_v = nn.Linear(dim, inner)
        self.add_k_proj = nn.Linear(dim, inner)
        self.add_v_proj = nn.Linear(dim, inner)
        self.add_q_proj = nn.Linear(dim, inner)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim), nn.Dropout(0.0)])
        if not pre_only:
            self.to_add_out = nn.Linear(inner, dim)

    def forward(self, x, ctx, attn_rows: Optional[int]):
        b, n, _ = x.shape

        def heads(t):
            return t.view(b, t.shape[1], self.heads,
                          self.dim_head).transpose(1, 2)
        q = heads(torch.cat([self.to_q(x), self.add_q_proj(ctx)], dim=1))
        k = heads(torch.cat([self.to_k(x), self.add_k_proj(ctx)], dim=1))
        v = heads(torch.cat([self.to_v(x), self.add_v_proj(ctx)], dim=1))
        rows = attn_rows or q.shape[2]
        o = torch.cat([torch.softmax(
            q[:, :, r:r + rows] @ k.transpose(-1, -2)
            * self.dim_head ** -0.5, dim=-1) @ v
            for r in range(0, q.shape[2], rows)], dim=2)
        o = o.transpose(1, 2).reshape(b, q.shape[2], -1)
        out = self.to_out[0](o[:, :n])
        return out, (None if self.pre_only else self.to_add_out(o[:, n:]))


class _FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([nn.Module(), nn.Dropout(0.0),
                                  nn.Linear(4 * dim, dim)])
        self.net[0].proj = nn.Linear(dim, 4 * dim)

    def forward(self, x):
        return self.net[2](F.gelu(self.net[0].proj(x), approximate="tanh"))


class _Block(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, pre_only: bool):
        super().__init__()
        self.pre_only = pre_only
        self.norm1 = _AdaZero(dim)
        self.norm1_context = (_AdaContinuous(dim) if pre_only
                              else _AdaZero(dim))
        self.attn = _Attention(dim, heads, dim_head, pre_only)
        self.ff = _FeedForward(dim)
        if not pre_only:
            self.ff_context = _FeedForward(dim)

    def forward(self, x, ctx, c, attn_rows: Optional[int] = None):
        sh, sc, g, sh2, sc2, g2 = self.norm1.linear(F.silu(c)).chunk(6, dim=1)
        h = _ln(x) * (1 + sc[:, None]) + sh[:, None]
        if self.pre_only:
            hc = self.norm1_context(ctx, c)
        else:
            csh, csc, cg, csh2, csc2, cg2 = self.norm1_context.linear(
                F.silu(c)).chunk(6, dim=1)
            hc = _ln(ctx) * (1 + csc[:, None]) + csh[:, None]
        a, ac = self.attn(h, hc, attn_rows)
        x = x + g[:, None] * a
        x = x + g2[:, None] * self.ff(_ln(x) * (1 + sc2[:, None])
                                      + sh2[:, None])
        if self.pre_only:
            return x, ctx
        ctx = ctx + cg[:, None] * ac
        ctx = ctx + cg2[:, None] * self.ff_context(
            _ln(ctx) * (1 + csc2[:, None]) + csh2[:, None])
        return x, ctx


class MMDiT(nn.Module):
    """(B, C, H, W) latents, t x 1000 (B,), text (B, T, joint dim), pooled
    (B, pooled dim) -> velocity (B, C, H, W)."""

    def __init__(self, spec: dict, attn_rows: Optional[int] = None,
                 checkpoint_blocks: bool = False):
        super().__init__()
        self.spec, self.attn_rows = spec, attn_rows
        self.checkpoint_blocks = checkpoint_blocks
        dim = spec["num_attention_heads"] * spec["attention_head_dim"]
        self.pos_embed = _PatchEmbed(spec)
        self.time_text_embed = _Embed(dim, spec["pooled_projection_dim"])
        self.context_embedder = nn.Linear(spec["joint_attention_dim"],
                                          spec["caption_projection_dim"])
        n = spec["num_layers"]
        self.transformer_blocks = nn.ModuleList([
            _Block(dim, spec["num_attention_heads"],
                   spec["attention_head_dim"], i == n - 1)
            for i in range(n)])
        self.norm_out = _AdaContinuous(dim)
        p = spec["patch_size"]
        self.proj_out = nn.Linear(dim, p * p * spec["out_channels"])

    def forward(self, sample, timesteps, text, pooled):
        s, p = self.spec, self.spec["patch_size"]
        b, _, height, width = sample.shape
        rows, cols = height // p, width // p
        x = self.pos_embed.proj(sample).flatten(2).transpose(1, 2)
        grid = s["pos_embed_max_size"]
        top, left = (grid - rows) // 2, (grid - cols) // 2
        table = self.pos_embed.pos_embed.reshape(1, grid, grid, -1)
        x = x + table[:, top:top + rows, left:left + cols].reshape(
            1, rows * cols, -1)
        emb = self.time_text_embed
        c = (emb.timestep_embedder(timestep_sinusoid(timesteps))
             + emb.text_embedder(pooled))
        ctx = self.context_embedder(text)
        for block in self.transformer_blocks:
            if self.checkpoint_blocks and torch.is_grad_enabled():
                x, ctx = checkpoint(block, x, ctx, c, self.attn_rows,
                                    use_reentrant=False,
                                    context_fn=_recompute_as_forward)
            else:
                x, ctx = block(x, ctx, c, self.attn_rows)
        x = self.proj_out(self.norm_out(x, c))
        x = x.reshape(b, rows, cols, p, p, s["out_channels"])
        return torch.einsum("nhwpqc->nchpwq", x).reshape(
            b, s["out_channels"], height, width)


def flow_targets(latents: torch.Tensor, noise: torch.Tensor,
                 t: torch.Tensor):
    """x_t = (1 - t) x0 + t eps and v = eps - x0 for NHWC latents."""
    tt = t.view(-1, 1, 1, 1)
    return (1.0 - tt) * latents + tt * noise, noise - latents


def flow_loss(model: MMDiT, batch: Dict[str, torch.Tensor], noise, t,
              num_train_timesteps: int = 1000,
              weight: float = 1.0) -> torch.Tensor:
    """weight x mean((model(x_t) - (eps - x0))^2), NHWC latents."""
    noised, target = flow_targets(batch["image_latents"], noise, t)
    pred = model(noised.permute(0, 3, 1, 2), t * num_train_timesteps,
                 batch["caption_latents"], batch["pooled_caption_latents"])
    return torch.square(pred.permute(0, 2, 3, 1) - target).mean() * weight


def train_steps(model: MMDiT, batches: List[Dict[str, torch.Tensor]],
                draws: List[List[tuple]], recipe: dict, block_rows: int,
                keep: float = 1.0, num_train_timesteps: int = 1000) -> dict:
    """`reference/train.py::train_steps` for the MMDiT: len(batches) steps
    from the module's present weights, `draws[s]` the (noise, t) of each
    microbatch of step s; its AdamW and leaf norms. Returns each step's
    loss, the leaf norms of the first step's gradient and of the
    parameters' change. `keep` < 1: each microbatch's first `keep` share
    of rows alone (the planted fault)."""
    from portbench.reference.train import AdamW, leaf_norms
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    start = [p.detach().clone() for p in params]
    warm = int(recipe["warmup_batches"])
    base = float(recipe["lr"])
    opt = AdamW(params, lambda c: base * min(c / warm, 1.0) if warm else base,
                recipe["betas"][0], recipe["betas"][1], recipe["eps"],
                recipe["weight_decay"])
    losses, first = [], None
    for batch, step_draws in zip(batches, draws):
        rows = batch["image_latents"].shape[0]
        micro = rows // len(step_draws)
        noise = torch.cat([d[0] for d in step_draws])
        t = torch.cat([d[1] for d in step_draws])
        for p in params:
            p.grad = None
        total = 0.0
        used = max(1, int(micro * keep))
        blocks = [(m0 + lo, min(m0 + lo + block_rows, m0 + used))
                  for m0 in range(0, rows, micro)
                  for lo in range(0, used, block_rows)]
        for lo, hi in blocks:
            part = {k: v[lo:hi] for k, v in batch.items()}
            loss = flow_loss(model, part, noise[lo:hi], t[lo:hi],
                             num_train_timesteps,
                             (hi - lo) / (used * (rows // micro)))
            loss.backward()
            total += float(loss.detach())
        grads = [p.grad for p in params]
        if first is None:
            first = leaf_norms(grads)
        opt.step(grads)
        losses.append(total)
    with torch.no_grad():
        change = leaf_norms([p - s for p, s in zip(params, start)])
    return {"names": names, "losses": losses, "grad_norms": first,
            "change_norms": change}
