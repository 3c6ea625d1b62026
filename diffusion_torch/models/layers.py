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
compute their statistics in fp32 and return the input's dtype.

Dropout (`ResnetBlock(dropout=p)`, after norm2 as in the JAX block) drops
only when the forward is given a `dropout_key`: the mask is drawn from a
generator seeded with the key and the block's `block_index`, so a
rematerialized block (`models/unet.py`) draws the same mask again when its
forward is recomputed.

Sequence parallelism: the blocks take `shard` (a
`parallel/sharding.py::RowShard`) where their (B, C, H, W) input is this
rank's rows of the image. Norms then merge their statistics over the sp
group, 3x3 convolutions take a row from each neighbour
(`halo_rows`), and self-attention attends over the group's tokens
(`ops/attention.py`).

Tensor parallelism: `parallel/sharding.py::shard_tensor_parallel` leaves
an `Attention` or `FeedForwardGEGLU` holding one tp rank's slices and sets
its `tp` to the group's size. Its forward then needs
`ops.attention.tensor_parallel`: it reads its input through `tp_copy`,
computes its own heads (or hidden features), sums its row-parallel
product over the tp group with `tp_reduce`, and adds the bias after the
sum (JAX: the layers' `tp_dim` anchors and the allreduce XLA inserts).

LoRA (`Attention(lora_rank=r)`): bias-free `Linear` siblings
`to_q_lora_a`/`to_q_lora_b` (and the same for `to_k`, `to_v`, `to_out`)
beside each projection, so the base names, and a diffusers checkpoint,
stay as they are. `init_like_flax_` draws A ~ N(0, 0.02) and B = 0, as
flax's `kernel_init` does, so a fresh adapter is the base model exactly.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from diffusion_torch.ops.attention import multi_head_attention
from diffusion_torch.ops.groupnorm import group_norm

__all__ = [
    "Linear", "Conv2d", "LayerNorm", "GroupNorm", "timestep_embedding",
    "TimestepEmbedding", "ResnetBlock", "LoRALinear", "Attention",
    "FeedForwardGEGLU",
    "BasicTransformerBlock", "Transformer2D", "Downsample", "Upsample",
    "Container", "init_like_flax_", "dropout",
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
    """nn.Conv2d computing in the input's dtype over fp32 parameters. With
    `shard`, `x` holds this rank's rows: the rows the kernel reaches beyond
    them come from the neighbouring shards (zeros at the image's edges)."""

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        weight = self.weight.to(x.dtype)
        k, pad, stride = self.kernel_size[0], self.padding[0], self.stride[0]
        if shard is None or k == 1:
            return self._conv_forward(x, weight, bias)
        from diffusion_torch.parallel.sharding import halo_rows
        if x.shape[2] % stride:
            raise ValueError(f"a row shard of {x.shape[2]} rows does not "
                             f"split under stride {stride}")
        x = halo_rows(x, shard, pad, k - stride - pad)
        return F.conv2d(x, weight, bias, self.stride, (0, self.padding[1]),
                        self.dilation, self.groups)


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

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        args = (x.permute(0, 2, 3, 1), self.weight, self.bias,
                self.num_groups, self.eps, self.act)
        y = group_norm(*args) if shard is None else group_norm(*args,
                                                               shard=shard)
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


def dropout(h: torch.Tensor, p: float, key: Sequence[int],
            shard=None) -> torch.Tensor:
    """Inverted dropout of a (B, C, H, W) channels_last activation: keep
    each element with probability 1 - p (then scaled by 1 / (1 - p)), as
    flax's Dropout. The mask is a function of `key` alone, drawn in NHWC
    order over the whole image's rows (this shard's taken)."""
    b, c, rows, w = h.shape
    if shard is not None:
        rows *= shard.size
    seed = np.random.SeedSequence([int(k) for k in key]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator(device=h.device).manual_seed(
        int(seed) & (2 ** 63 - 1))
    keep = (torch.rand((b, rows, w, c), generator=gen, device=h.device)
            >= p).permute(0, 3, 1, 2)
    if shard is not None:
        keep = keep.narrow(2, shard.index * h.shape[2], h.shape[2])
    return torch.where(keep, h / (1.0 - p), torch.zeros((), dtype=h.dtype,
                                                        device=h.device))


class ResnetBlock(nn.Module):
    """GroupNorm-SiLU-Conv residual block with additive time conditioning
    (`temb_channels=None` for the VAE's unconditioned blocks). `dropout`
    drops after norm2 where the forward gets a `dropout_key`; the UNet
    numbers its blocks (`block_index`) so that each draws its own mask."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int], groups: int = 32,
                 eps: float = 1e-5, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.block_index = 0
        self.norm1 = GroupNorm(groups, in_channels, eps, act="silu")
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        if temb_channels:
            self.time_emb_proj = Linear(temb_channels, out_channels)
        self.norm2 = GroupNorm(groups, out_channels, eps, act="silu")
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor,
                temb: Optional[torch.Tensor] = None,
                dropout_key: Optional[Sequence[int]] = None,
                shard=None) -> torch.Tensor:
        h = self.conv1(self.norm1(x, shard), shard)
        if temb is not None and hasattr(self, "time_emb_proj"):
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.norm2(h, shard)
        if dropout_key is not None and self.dropout > 0:
            h = dropout(h, self.dropout, (*dropout_key, self.block_index),
                        shard)
        h = self.conv2(h, shard)
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class LoRALinear(Linear):
    """A bias-free LoRA factor: `*_lora_a` (in -> rank, A ~ N(0, 0.02)) or
    `*_lora_b` (rank -> out, zeros), as `init_like_flax_` draws them."""

    def __init__(self, in_features: int, out_features: int, zero: bool):
        super().__init__(in_features, out_features, bias=False)
        self.zero_init = zero


def _tp_shard(layer: nn.Module):
    """The tp group a sliced layer runs over (None for a whole layer)."""
    if layer.tp == 1:
        return None
    from diffusion_torch.ops.attention import active_tp
    shard = active_tp()
    if shard is None or shard.size != layer.tp:
        raise RuntimeError(f"a layer holding its slice of {layer.tp} tp "
                           f"ranks runs under ops.attention.tensor_parallel "
                           f"over {layer.tp} ranks")
    return shard


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


class Attention(nn.Module):
    """Multi-head attention over (B, S, C) tokens; cross-attention when a
    context is given. Dispatches through `ops.attention`.

    `lora_rank > 0` adds y = W x + (alpha / r) B(A(x)) to each projection,
    after its base product and at its compute dtype (the JAX module's
    order): q's branch reads x, k's and v's the context, to_out's the
    attention output. `lora_alpha=None` means scale 1.0.

    Sliced for tp ranks (`tp` > 1): `heads // tp` local heads. A LoRA
    branch of q/k/v takes its (whole) A's output through `tp_copy` into its
    B's rows; to_out's branch sums its A's partial product over the group
    before its (whole) B, so every whole factor gets the whole gradient."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 cross_dim: Optional[int] = None, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None):
        super().__init__()
        inner = heads * dim_head
        ctx = cross_dim or query_dim
        self.heads, self.dim_head, self.tp = heads, dim_head, 1
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(ctx, inner, bias=False)
        self.to_v = Linear(ctx, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, query_dim), nn.Identity()])
        self.lora_rank = int(lora_rank)
        if self.lora_rank > 0:
            self.lora_scale = (float(lora_alpha) if lora_alpha is not None
                               else float(lora_rank)) / float(lora_rank)
            for name, fan_in, fan_out in (("to_q", query_dim, inner),
                                          ("to_k", ctx, inner),
                                          ("to_v", ctx, inner),
                                          ("to_out", inner, query_dim)):
                setattr(self, f"{name}_lora_a",
                        LoRALinear(fan_in, self.lora_rank, zero=False))
                setattr(self, f"{name}_lora_b",
                        LoRALinear(self.lora_rank, fan_out, zero=True))

    def _lora(self, name: str, y: torch.Tensor, inp: torch.Tensor,
              copy=_same) -> torch.Tensor:
        if self.lora_rank == 0:
            return y
        a = copy(getattr(self, f"{name}_lora_a")(inp))
        return y + getattr(self, f"{name}_lora_b")(a) * self.lora_scale

    def _attend(self, x: torch.Tensor, context: Optional[torch.Tensor],
                shard, copy=_same) -> torch.Tensor:
        """(B, Sq, local inner): this rank's heads' attention output, the
        inputs taken through `copy` (tp_copy under tp)."""
        ctx = x if context is None else context
        xc = copy(x)
        cc = xc if context is None else copy(context)
        b, sq, _ = x.shape
        sk = ctx.shape[1]
        heads = self.heads // self.tp
        q = self._lora("to_q", self.to_q(xc), x, copy)
        k = self._lora("to_k", self.to_k(cc), ctx, copy)
        v = self._lora("to_v", self.to_v(cc), ctx, copy)
        o = multi_head_attention(q.view(b, sq, heads, self.dim_head),
                                 k.view(b, sk, heads, self.dim_head),
                                 v.view(b, sk, heads, self.dim_head),
                                 shard=shard if context is None else None)
        return o.reshape(b, sq, -1)

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None,
                shard=None) -> torch.Tensor:
        """`shard`: self-attention over tokens the sp group splits."""
        tp = _tp_shard(self)
        if tp is None:
            o = self._attend(x, context, shard)
            return self._lora("to_out", self.to_out[0](o), o)
        from diffusion_torch.parallel.sharding import tp_copy, tp_reduce
        o = self._attend(x, context, shard, lambda t: tp_copy(t, tp))
        # the row-parallel product summed over the group, then the bias
        out = tp_reduce(F.linear(o, self.to_out[0].weight.to(o.dtype)), tp)
        out = out + self.to_out[0].bias.to(out.dtype)
        if self.lora_rank == 0:
            return out
        a = tp_reduce(self.to_out_lora_a(o), tp)
        return out + self.to_out_lora_b(a) * self.lora_scale


class _GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # diffusers' fused value+gate projection, chunked (value, gate); the
        # JAX module keeps the halves as proj_in/proj_gate (port_jax re-fuses;
        # a tp slice holds its value rows, then its gate rows)
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate)


class FeedForwardGEGLU(nn.Module):
    """GEGLU feed-forward, exact erf GELU: net.0 = GEGLU, net.2 = output.
    Sliced for tp ranks (`tp` > 1): net.0 column-parallel, net.2
    row-parallel."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.tp = 1
        self.net = nn.ModuleList([_GEGLU(dim, inner), nn.Identity(),
                                  Linear(inner, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tp = _tp_shard(self)
        if tp is None:
            return self.net[2](self.net[0](x))
        from diffusion_torch.parallel.sharding import tp_copy, tp_reduce
        h = self.net[0](tp_copy(x, tp))
        out = tp_reduce(F.linear(h, self.net[2].weight.to(h.dtype)), tp)
        return out + self.net[2].bias.to(out.dtype)


class BasicTransformerBlock(nn.Module):
    """LN -> self-attn, LN -> cross-attn, LN -> GEGLU FF, all residual."""

    def __init__(self, dim: int, heads: int, dim_head: int, cross_dim: int,
                 lora_rank: int = 0, lora_alpha: Optional[float] = None):
        super().__init__()
        lora = {"lora_rank": lora_rank, "lora_alpha": lora_alpha}
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads, dim_head, **lora)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, heads, dim_head, cross_dim=cross_dim,
                               **lora)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForwardGEGLU(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                shard=None) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x), shard=shard)
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """Spatial transformer: GN -> proj_in -> blocks over H*W tokens ->
    proj_out -> + residual. Linear projections (SD2) or 1x1 convs (SD1)."""

    def __init__(self, channels: int, heads: int, cross_dim: int,
                 groups: int = 32, depth: int = 1,
                 use_linear_projection: bool = True, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None):
        super().__init__()
        self.use_linear_projection = use_linear_projection
        self.norm = GroupNorm(groups, channels, eps=1e-6)
        proj = Linear if use_linear_projection else (
            lambda i, o: Conv2d(i, o, 1))
        self.proj_in = proj(channels, channels)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(channels, heads, channels // heads,
                                  cross_dim, lora_rank, lora_alpha)
            for _ in range(depth)])
        self.proj_out = proj(channels, channels)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                shard=None) -> torch.Tensor:
        b, c, h, w = x.shape
        hidden = self.norm(x, shard)
        if not self.use_linear_projection:
            hidden = self.proj_in(hidden)
        # channels_last: the (B, H*W, C) token view is free
        hidden = hidden.permute(0, 2, 3, 1).reshape(b, h * w, c)
        if self.use_linear_projection:
            hidden = self.proj_in(hidden)
        for block in self.transformer_blocks:
            hidden = block(hidden, context, shard)
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

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        return self.conv(x, shard)


class Upsample(nn.Module):
    """Nearest 2x upsample + 3x3 conv (diffusers Upsample2D)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        x = F.interpolate(x, scale_factor=2.0, mode="nearest")
        return self.conv(x.contiguous(memory_format=CHANNELS_LAST), shard)


@torch.no_grad()
def init_like_flax_(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights as flax's defaults draw them, so random-weight serving
    behaves like the JAX package's `init_params`: lecun-normal (truncated)
    kernels, zero biases, unit/zero norms, 1/sqrt(dim) embeddings (or the
    module's `flax_init_std`); LoRA factors as the JAX Attention's
    `kernel_init`: A ~ N(0, 0.02), B zeros."""
    for m in module.modules():
        if isinstance(m, LoRALinear):
            if m.zero_init:
                m.weight.zero_()
            else:
                nn.init.normal_(m.weight, 0.0, 0.02, generator=generator)
        elif isinstance(m, (nn.Linear, nn.Conv2d)):
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
        # bare parameters flax draws from normal(std), e.g. CLIP's class
        # token
        for name, std in getattr(m, "flax_normal_params", {}).items():
            nn.init.normal_(getattr(m, name), 0.0, std, generator=generator)
