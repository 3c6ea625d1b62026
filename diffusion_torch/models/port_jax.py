"""JAX param trees -> the port's state_dicts.

The port's modules carry the diffusers/transformers parameter names, so
these functions are the exact inverses of `diffusion_tpu/models/port_hf.py`'s
`port_unet`, `port_vae` and `port_clip_text`: HWIO -> OIHW for conv
kernels, (in, out) -> (out, in) for dense kernels, flax `scale` ->
`weight`, and the GEGLU's `ff/proj_in` + `ff/proj_gate` re-fused into
diffusers' `ff.net.0.proj` (value rows first, then gate rows).

Input: a flax param tree ({"params": {...}} or the inner dict) whose leaves
are numpy arrays (anything `np.asarray` takes). Output: a state_dict of fp32
torch tensors for `load_state_dict`.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Mapping

import numpy as np
import torch

__all__ = ["unet_from_jax", "vae_from_jax", "clip_text_from_jax"]

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "embedding": "weight"}


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    if "params" in tree and not prefix:
        tree = tree["params"]
    flat: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            flat.update(_flatten(v, path))
        else:
            flat[path] = np.asarray(v)
    return flat


def _value(leaf: str, w: np.ndarray) -> np.ndarray:
    if leaf == "kernel" and w.ndim == 4:
        return w.transpose(3, 2, 0, 1)                   # HWIO -> OIHW
    if leaf == "kernel" and w.ndim == 2:
        return w.T                                       # (in, out) -> (out, in)
    return w


def _block_name(part: str) -> str:
    """UNet/VAE scope names -> diffusers module paths."""
    m = re.fullmatch(r"(down|up)_(\d+)_(res|attn)_(\d+)", part)
    if m:
        kind = "resnets" if m[3] == "res" else "attentions"
        return f"{m[1]}_blocks.{m[2]}.{kind}.{m[4]}"
    m = re.fullmatch(r"(down|up)_(\d+)_(downsample|upsample)", part)
    if m:
        return f"{m[1]}_blocks.{m[2]}.{m[3]}rs.0"
    m = re.fullmatch(r"mid_res_(\d+)", part)
    if m:
        return f"mid_block.resnets.{m[1]}"
    if part == "mid_attn":
        return "mid_block.attentions.0"
    m = re.fullmatch(r"blocks_(\d+)", part)
    if m:
        return f"transformer_blocks.{m[1]}"
    if part == "to_out":
        return "to_out.0"
    return part


def _convert(flat: Dict[str, np.ndarray],
             name: Callable[[list], str]) -> Dict[str, torch.Tensor]:
    out: Dict[str, np.ndarray] = {}
    geglu: Dict[str, Dict[str, np.ndarray]] = {}
    for path, w in flat.items():
        parts = path.split("/")
        leaf = parts[-1]
        if leaf == "position_embedding":                  # a bare param
            out[name(parts[:-1]) + ".position_embedding.weight"] = w
            continue
        if len(parts) >= 3 and parts[-3] == "ff" and parts[-2] in (
                "proj_in", "proj_gate"):
            base = name(parts[:-3]) + ".ff.net.0.proj." + _LEAF[leaf]
            geglu.setdefault(base, {})[parts[-2]] = _value(leaf, w)
            continue
        if len(parts) >= 3 and parts[-3] == "ff" and parts[-2] == "proj_out":
            out[name(parts[:-3]) + ".ff.net.2." + _LEAF[leaf]] = _value(leaf, w)
            continue
        out[name(parts[:-1]) + "." + _LEAF[leaf]] = _value(leaf, w)
    for key, halves in geglu.items():
        out[key] = np.concatenate([halves["proj_in"], halves["proj_gate"]],
                                  axis=0)
    # np.array copies: leaves may be read-only views of device buffers
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
            for k, v in out.items()}


def unet_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """`UNet2DCondition` params -> the port's UNet state_dict."""
    return _convert(_flatten(tree),
                    lambda parts: ".".join(_block_name(p) for p in parts))


def vae_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """`AutoencoderKL` params -> the port's VAE state_dict (`encoder.*`,
    `quant_conv.*`, `decoder.*`, `post_quant_conv.*`)."""
    return _convert(_flatten(tree),
                    lambda parts: ".".join(_block_name(p) for p in parts))


def _clip_name(parts: list) -> str:
    if not parts:
        return "text_model.embeddings"                    # position_embedding
    top = parts[0]
    if top == "token_embedding":
        return "text_model.embeddings.token_embedding"
    if top == "final_layer_norm":
        return "text_model.final_layer_norm"
    m = re.fullmatch(r"layers_(\d+)", top)
    if not m:
        raise KeyError(f"unmapped CLIP text param {'/'.join(parts)}")
    sub = parts[1]
    group = ("self_attn." if sub.endswith("_proj")
             else "mlp." if sub.startswith("fc") else "")
    return f"text_model.encoder.layers.{m[1]}.{group}{sub}"


def clip_text_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """`CLIPTextModel` params -> the port's CLIP text state_dict."""
    return _convert(_flatten(tree), _clip_name)
