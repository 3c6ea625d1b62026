"""The yardstick's arithmetic for FLUX: the model's FLOPs, counted once per
configuration and shape on the plain reference (`FlopCounterMode` on the
meta device, attention as plain matmuls at the true joint length), and the
joint attention calls a training pass sends to the flash kernels at head
dim 128. Kept beside `flops.py` and `flops_mmdit.py`, and not in them.
"""

from __future__ import annotations

import functools
import json
from typing import List

import torch

from portbench.reference.flux import Flux, flux_spec
from portbench.reference.mmdit import flow_loss

__all__ = ["flux_train_flops", "joint_calls"]


@functools.lru_cache(maxsize=None)
def _flux_flops(transformer_json: str, batch: int, side: int,
                tokens: int) -> int:
    from torch.utils.flop_counter import FlopCounterMode
    spec = flux_spec(json.loads(transformer_json))
    channels = spec["in_channels"] // 4
    with torch.device("meta"):
        model = Flux(spec)
        data = {"image_latents": torch.zeros(batch, side, side, channels),
                "caption_latents": torch.zeros(batch, tokens,
                                               spec["joint_attention_dim"]),
                "pooled_caption_latents": torch.zeros(
                    batch, spec["pooled_projection_dim"])}
        noise = torch.zeros(batch, side, side, channels)
        t = torch.zeros(batch)
    with FlopCounterMode(display=False) as counter:
        flow_loss(model, data, noise, t).backward()
    return int(counter.get_total_flops())


def flux_train_flops(transformer: dict, batch: int, side: int,
                     tokens: int) -> int:
    """FLOPs of the rectified-flow loss's forward and backward over `batch`
    latents of `side` x `side` and `tokens` T5 tokens (the parameters'
    gradients; none for the inputs)."""
    return _flux_flops(json.dumps(transformer, sort_keys=True), batch, side,
                       tokens)


def joint_calls(transformer: dict, batch: int, side: int,
                tokens: int) -> List[tuple]:
    """The joint attention calls of one FLUX pass ((B, H, Sq, Skv, D,
    self?), as `flops.flash_bound_s` takes them): one a double-stream and
    one a single-stream block, each over all text and image tokens."""
    s = flux_spec(transformer)
    joint = (side // 2) ** 2 + tokens
    return [(batch, s["num_attention_heads"], joint, joint,
             s["attention_head_dim"], True)] * (
                 s["num_layers"] + s["num_single_layers"])
