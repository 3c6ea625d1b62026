"""UNet2DCondition, the denoising network.

Counterpart of `diffusion_tpu/models/unet.py` with diffusers' module names
(`down_blocks.i.resnets.j`, `mid_block`, `up_blocks`, ...), so a diffusers
UNet2DConditionModel state_dict loads as it is. NCHW in and out (the JAX
module is NHWC); the activations are kept in channels_last memory, whose
layout is the JAX one. Trains with autograd through the GroupNorm and flash
kernels' backward halves. `UNetConfig.lora_rank > 0` adds LoRA adapters to
every attention projection (`layers.Attention`, `models/lora.py`).

`remat=True` rematerializes each ResnetBlock and Transformer2D in the
backward (`torch.utils.checkpoint`, non-reentrant) under JAX's "dots"
policy: the outputs of matrix products without batch dimensions (`mm`,
`addmm`: every Linear), of convolutions (JAX saves the ResnetBlock convs'
`conv_out` by default, `DIFFUSION_TPU_SAVE_CONVS=1`; here every conv of
the block, its 1x1 shortcut too), of the flash and ring attention ops
(JAX's `flash_out`/`flash_lse`) and of the tensor-parallel sums
(`tp_reduce`, whose all-reduce then runs once) are kept; norms,
activations, attention's batched products and the dropout masks are
recomputed. The attention
kernels are dispatcher ops (`torch.library.custom_op`) so that the policy
sees them: the O(S^2) forward never runs again in the backward.

`forward(..., dropout_key=)` turns on ResnetBlock dropout
(`config.dropout`), each block's mask drawn from the key and its index,
so a recomputed block draws it again (JAX: `deterministic=False` with a
`dropout` rng).

Under `ops.attention.sequence_parallel` the body splits its rows over the
sp group wherever each shard keeps >= 2 rows (JAX's `constrain_batch`
rule); the deeper stages run whole on every rank, joined by a gather on
the way down and a slice on the way up. The output is then this rank's
rows.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from diffusion_torch.models.layers import (CHANNELS_LAST, Container, Conv2d, Downsample,
                                           GroupNorm, ResnetBlock,
                                           TimestepEmbedding, Transformer2D,
                                           Upsample, timestep_embedding)

__all__ = ["UNetConfig", "UNet2DCondition", "SD2_BASE_UNET", "PIXEL_UNET",
           "group_norm_shapes", "remat_saved_ops"]


def remat_saved_ops() -> frozenset:
    """The ops whose outputs a rematerialized block keeps (JAX's "dots"
    policy with the conv and flash names)."""
    from diffusion_torch.ops.flash_attention import flash_attention_op
    from diffusion_torch.ops.ring_attention import ring_attention_op
    from diffusion_torch.parallel.sharding import tp_reduce_op
    aten = torch.ops.aten
    return frozenset({aten.mm.default, aten.addmm.default,
                      aten.convolution.default, flash_attention_op,
                      ring_attention_op, tp_reduce_op})


def _dots_policy(saved, ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in saved
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_context():
    return create_selective_checkpoint_contexts(
        functools.partial(_dots_policy, remat_saved_ops()))


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
    # LoRA adapters on every attention projection: 0 = none
    lora_rank: int = 0
    lora_alpha: Optional[float] = None


SD2_BASE_UNET = UNetConfig()
# the pixel-space UNet: SD2's widths and heads, 3 channels, cross-attention
# over ViT-L/14's 768-wide text states
PIXEL_UNET = UNetConfig(in_channels=3, out_channels=3, cross_attention_dim=768)


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
        super().__init__()
        self.config, self.dtype, self.remat = config, dtype, bool(remat)
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
                                 config.use_linear_projection,
                                 config.lora_rank, config.lora_alpha)

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
        for i, m in enumerate(m for m in self.modules()
                              if isinstance(m, ResnetBlock)):
            m.block_index = i

    @property
    def drops(self) -> bool:
        """Whether the forward drops: training mode and a ResnetBlock with
        dropout > 0."""
        return self.training and any(
            m.dropout > 0 for m in self.modules()
            if isinstance(m, ResnetBlock))

    def _block(self, module: nn.Module, *args):
        """Run a ResnetBlock or Transformer2D, rematerialized under
        `remat` where autograd records."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(module, *args, use_reentrant=False,
                              context_fn=_remat_context)
        return module(*args)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                dropout_key: Optional[Sequence[int]] = None) -> torch.Tensor:
        """sample (B, Cin, H, W), timesteps (B,) or scalar, context
        (B, S, cross_dim) -> fp32 (B, Cout, H, W), or this rank's rows of
        it under sequence parallelism. `dropout_key` (ints) turns on
        dropout."""
        from diffusion_torch.ops.attention import active_shard
        from diffusion_torch.parallel.sharding import gather_rows, take_rows
        cfg = self.config
        group = active_shard()

        def split(rows):
            """The shard for activations of `rows` rows (whole image)."""
            return group if group is not None and group.holds(rows) else None

        if timesteps.ndim == 0:
            timesteps = timesteps.expand(sample.shape[0])
        temb = timestep_embedding(timesteps, cfg.block_out_channels[0],
                                  cfg.flip_sin_to_cos, cfg.freq_shift)
        temb = self.time_embedding(temb.to(self.dtype))
        context = encoder_hidden_states.to(self.dtype)
        rows = sample.shape[2]
        shard = split(rows)
        x = sample.to(self.dtype).contiguous(memory_format=CHANNELS_LAST)
        if shard is not None:
            x = take_rows(x, shard)
        h = self.conv_in(x, shard)
        key = None if dropout_key is None else tuple(dropout_key)

        residuals = [h]
        for block in self.down_blocks:
            attns = getattr(block, "attentions", None)
            for j, resnet in enumerate(block.resnets):
                h = self._block(resnet, h, temb, key, shard)
                if attns is not None:
                    h = self._block(attns[j], h, context, shard)
                residuals.append(h)
            if hasattr(block, "downsamplers"):
                if shard is not None and h.shape[2] % 2:
                    h, shard = gather_rows(h, shard), None
                h = block.downsamplers[0](h, shard)
                rows //= 2
                if shard is not None and split(rows) is None:
                    h, shard = gather_rows(h, shard), None
                residuals.append(h)

        h = self._block(self.mid_block.resnets[0], h, temb, key, shard)
        h = self._block(self.mid_block.attentions[0], h, context, shard)
        h = self._block(self.mid_block.resnets[1], h, temb, key, shard)

        for block in self.up_blocks:
            attns = getattr(block, "attentions", None)
            for j, resnet in enumerate(block.resnets):
                # the channel concat of NCHW tensors is not channels_last
                # any more; the next GroupNorm needs it back (a copy that
                # autograd carries: the gradient of the concat's halves is a
                # slice of a channels_last cotangent)
                h = torch.cat([h, residuals.pop()], dim=1).contiguous(
                    memory_format=CHANNELS_LAST)
                h = self._block(resnet, h, temb, key, shard)
                if attns is not None:
                    h = self._block(attns[j], h, context, shard)
            if hasattr(block, "upsamplers"):
                rows *= 2
                h = block.upsamplers[0](h, shard)
                if shard is None and split(rows) is not None:
                    # whole -> split: every rank ran the whole stage
                    shard = split(rows)
                    h = take_rows(h, shard)

        return self.conv_out(self.conv_norm_out(h, shard), shard).float()
