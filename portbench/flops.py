"""The yardstick's arithmetic: the card's peaks, a kernel's least time, the
model's FLOPs, and the calls a UNet pass makes.

FLOPs are counted once per configuration and shape on the plain reference
(`torch.utils.flop_counter.FlopCounterMode` on the meta device, attention
as plain matmuls), so a faster or fused kernel of the program never changes
the count, and recomputation is never counted.
"""

from __future__ import annotations

import functools
import json
from typing import Dict, List, Tuple

import torch
import torch.nn as nn

from portbench.reference.unet import Attention, UNet2DCondition, unet_spec

__all__ = ["PEAK_FLOPS", "PEAK_BYTES_PER_S", "bound_s", "train_flops",
           "unet_calls", "flash_bound_s", "group_norm_bound_s"]

# NVIDIA H100 SXM data sheet: dense bf16 tensor cores, HBM3 (at 700 W)
PEAK_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time: the larger of the work over the bf16 peak and the
    bytes (each input read once, each output written once) over the memory
    rate."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S)


def _inputs(spec: dict, batch: int, side: int, tokens: int, device):
    sample = torch.zeros(batch, spec["in_channels"], side, side,
                         device=device)
    t = torch.zeros(batch, dtype=torch.long, device=device)
    ctx = torch.zeros(batch, tokens, spec["cross_attention_dim"],
                      device=device)
    return sample, t, ctx


@functools.lru_cache(maxsize=None)
def _train_flops(unet_json: str, batch: int, side: int, tokens: int) -> int:
    from torch.utils.flop_counter import FlopCounterMode
    spec = unet_spec(json.loads(unet_json))
    with torch.device("meta"):
        unet = UNet2DCondition(spec)
    sample, t, ctx = _inputs(spec, batch, side, tokens, "meta")
    with FlopCounterMode(display=False) as counter:
        unet(sample, t, ctx).float().square().mean().backward()
    return int(counter.get_total_flops())


def train_flops(unet: dict, batch: int, side: int, tokens: int) -> int:
    """FLOPs of the loss's forward and backward over `batch` latents of
    `side` x `side` (the parameters' gradients; none for the inputs)."""
    return _train_flops(json.dumps(unet, sort_keys=True), batch, side, tokens)


def unet_calls(unet: dict, batch: int, side: int, tokens: int
               ) -> Tuple[List[tuple], List[tuple]]:
    """The GroupNorm calls ((B, C, H, W)) and the attention calls ((B, H,
    Sq, Skv, D, self?)) of one UNet forward, in call order."""
    spec = unet_spec(unet)
    with torch.device("meta"):
        model = UNet2DCondition(spec)
    norms, attns, hooks = [], [], []
    for m in model.modules():
        if isinstance(m, nn.GroupNorm):
            hooks.append(m.register_forward_hook(
                lambda mod, inp, out: norms.append(tuple(inp[0].shape))))
        elif isinstance(m, Attention):
            def hook(mod, args, kwargs, out):
                x = args[0]
                ctx = kwargs.get("context", args[1] if len(args) > 1
                                 else None)
                skv = x.shape[1] if ctx is None else ctx.shape[1]
                attns.append((x.shape[0], mod.heads, x.shape[1], skv,
                              mod.dim_head, ctx is None))
            hooks.append(m.register_forward_hook(hook, with_kwargs=True))
    sample, t, ctx = _inputs(spec, batch, side, tokens, "meta")
    with torch.no_grad():
        model(sample, t, ctx)
    for h in hooks:
        h.remove()
    return norms, attns


def flash_bound_s(call: tuple, backward: bool) -> float:
    """A flash call's least time in bf16: 2 units forward (QK^T, PV) and 4
    backward (dV, dP, dQ, dK), a unit 2 B H Sq Skv D; forward reads q, k, v
    and writes o and the fp32 log-sum-exp, backward reads q, k, v, o, do
    and the log-sum-exp and writes dq, dk, dv."""
    b, h, sq, skv, d, _ = call
    unit = 2.0 * b * h * sq * skv * d
    q, kv, lse = b * sq * h * d * 2, b * skv * h * d * 2, b * h * sq * 4
    if backward:
        return bound_s(4 * unit, 3 * q + 2 * kv + lse + q + 2 * kv)
    return bound_s(2 * unit, q + 2 * kv + q + lse)


def group_norm_bound_s(shape: tuple, backward: bool) -> float:
    """A GroupNorm(+SiLU) call's least time over bf16 activations and fp32
    scale and bias: forward reads x and writes y; backward reads x and dy
    (and the per-group statistics) and writes dx, dscale and dbias."""
    b, c, h, w = shape
    x, params = b * c * h * w * 2, c * 4 * 2
    if backward:
        return bound_s(0.0, 3 * x + params + params)
    return bound_s(0.0, 2 * x + params)


def flash_calls(unet: dict, batch: int, side: int, tokens: int) -> List[tuple]:
    """The attention calls of one UNet pass that go to the flash kernels:
    self-attention with at least 1,024 queries and 256 keys at head size 64
    (the program's rule for bf16 on the card)."""
    _, attns = unet_calls(unet, batch, side, tokens)
    return [a for a in attns
            if a[5] and a[2] >= 1024 and a[3] >= 256 and a[4] == 64]


def traced_share(run, kernels: Tuple[str, ...], bound: float,
                 launches: Dict[str, int] = None):
    """100 x the least time of the traced window's calls over the device
    time of the kernels named; None where the window ran none of them, or
    where a kernel's launches are not the count the calls give."""
    tr = run.trace
    if tr is None:
        return None
    seconds = tr.device_s(kernels)
    if seconds <= 0:
        return None
    for name, n in (launches or {}).items():
        if tr.count(name) != n:
            return None
    return 100.0 * bound / seconds


@functools.lru_cache(maxsize=None)
def _serve_flops(config_json: str, size: int, steps: int) -> int:
    from torch.utils.flop_counter import FlopCounterMode
    from portbench.reference.clip import CLIPTextModel
    from portbench.reference.vae import AutoencoderKL, vae_spec
    config = json.loads(config_json)
    spec = unet_spec(config["unet"])
    with torch.device("meta"):
        unet = UNet2DCondition(spec)
        vae = AutoencoderKL(vae_spec(config["vae"]))
        text = CLIPTextModel(config["text_encoder"])
    tokens = config["text_encoder"]["max_position_embeddings"]
    side = size // 8
    ids = torch.zeros(2, tokens, dtype=torch.long, device="meta")
    sample, t, ctx = _inputs(spec, 2, side, tokens, "meta")
    z = torch.zeros(1, config["vae"]["latent_channels"], side, side,
                    device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        text(ids)
        for _ in range(steps):
            unet(sample, t, ctx)
        vae.decode(z)
    return int(counter.get_total_flops())


def serve_flops_per_image(config: dict, size: int, steps: int) -> int:
    """FLOPs of one text-to-image request: CLIP text over the prompt and
    the empty prompt, `steps` CFG UNet forwards (batch 2), one VAE
    decode."""
    return _serve_flops(json.dumps(config, sort_keys=True), size, steps)


def decode_norms(config: dict, batch: int, side: int) -> List[tuple]:
    """The GroupNorm calls ((B, C, H, W)) of one VAE decode of `side` x
    `side` latents."""
    from portbench.reference.vae import AutoencoderKL, vae_spec
    with torch.device("meta"):
        vae = AutoencoderKL(vae_spec(config["vae"]))
    norms = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: norms.append(tuple(inp[0].shape)))
        for m in vae.decoder.modules() if isinstance(m, nn.GroupNorm)]
    z = torch.zeros(batch, config["vae"]["latent_channels"], side, side,
                    device="meta")
    with torch.no_grad():
        vae.decode(z)
    for h in hooks:
        h.remove()
    return norms
