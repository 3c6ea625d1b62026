"""The yardstick's arithmetic for the MMDiT and for the raw-image cell: the
model's FLOPs, counted once per configuration and shape on the plain
reference (`FlopCounterMode` on the meta device, attention as plain
matmuls at its true lengths), and the joint attention calls a training
pass sends to the flash kernels. Kept beside `flops.py`, whose UNet
helpers it uses, and not in it.
"""

from __future__ import annotations

import functools
import json
from typing import List

import torch

from portbench.reference.mmdit import MMDiT, flow_loss, mmdit_spec

__all__ = ["mmdit_train_flops", "joint_calls", "wds_train_flops",
           "encoder_norms"]


@functools.lru_cache(maxsize=None)
def _mmdit_flops(transformer_json: str, batch: int, side: int,
                 tokens: int) -> int:
    from torch.utils.flop_counter import FlopCounterMode
    spec = mmdit_spec(json.loads(transformer_json))
    with torch.device("meta"):
        model = MMDiT(spec)
        data = {"image_latents": torch.zeros(batch, side, side,
                                             spec["in_channels"]),
                "caption_latents": torch.zeros(batch, tokens,
                                               spec["joint_attention_dim"]),
                "pooled_caption_latents": torch.zeros(
                    batch, spec["pooled_projection_dim"])}
        noise = torch.zeros(batch, side, side, spec["in_channels"])
        t = torch.zeros(batch)
    with FlopCounterMode(display=False) as counter:
        flow_loss(model, data, noise, t).backward()
    return int(counter.get_total_flops())


def mmdit_train_flops(transformer: dict, batch: int, side: int,
                      tokens: int) -> int:
    """FLOPs of the rectified-flow loss's forward and backward over `batch`
    latents of `side` x `side` and `tokens` text tokens (the parameters'
    gradients; none for the inputs)."""
    return _mmdit_flops(json.dumps(transformer, sort_keys=True), batch, side,
                        tokens)


def joint_calls(transformer: dict, batch: int, side: int,
                tokens: int) -> List[tuple]:
    """The joint attention calls of one MMDiT pass ((B, H, Sq, Skv, D,
    self?), as `flops.flash_bound_s` takes them): one a block, every block
    over all image and text tokens (the last block's text queries attend
    too, as in diffusers)."""
    s = mmdit_spec(transformer)
    joint = (side // s["patch_size"]) ** 2 + tokens
    return [(batch, s["num_attention_heads"], joint, joint,
             s["attention_head_dim"], True)] * s["num_layers"]


@functools.lru_cache(maxsize=None)
def _wds_flops(config_json: str, batch: int, size: int, tokens: int) -> int:
    from torch.utils.flop_counter import FlopCounterMode
    from portbench.reference.clip import CLIPTextModel
    from portbench.reference.vae import AutoencoderKL, vae_spec
    config = json.loads(config_json)
    with torch.device("meta"):
        vae = AutoencoderKL(vae_spec(config["vae"]))
        text = CLIPTextModel(config["text_encoder"])
        images = torch.zeros(batch, 3, size, size)
        ids = torch.zeros(batch, tokens, dtype=torch.long)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        vae.encode_moments(images)
        text(ids)
    return int(counter.get_total_flops())


def wds_train_flops(config: dict, batch: int, size: int, tokens: int) -> int:
    """FLOPs of a raw-image training microbatch: the UNet's loss forward and
    backward (`flops.train_flops`) plus the frozen towers' forward, the VAE
    encoder over `size` px images and CLIP over `tokens` token ids."""
    from portbench.flops import train_flops
    towers = _wds_flops(json.dumps(config, sort_keys=True), batch, size,
                        tokens)
    return train_flops(config["unet"], batch, size // 8, tokens) + towers


def encoder_norms(config: dict, batch: int, size: int) -> List[tuple]:
    """The GroupNorm calls ((B, C, H, W)) of one VAE encode of `batch`
    images of `size` x `size` px."""
    import torch.nn as nn
    from portbench.reference.vae import AutoencoderKL, vae_spec
    with torch.device("meta"):
        vae = AutoencoderKL(vae_spec(config["vae"]))
    norms = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: norms.append(tuple(inp[0].shape)))
        for m in vae.encoder.modules() if isinstance(m, nn.GroupNorm)]
    with torch.no_grad():
        vae.encode_moments(torch.zeros(batch, 3, size, size, device="meta"))
    for h in hooks:
        h.remove()
    return norms
