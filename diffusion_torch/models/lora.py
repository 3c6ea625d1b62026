"""LoRA adapters of the UNet: which parameters they are, freezing the
base, and folding an adapter into its base weights.

Counterpart of `diffusion_tpu/models/lora.py`, in PyTorch idiom. The
adapters are submodules of the UNet's attentions (`models/layers.py`
`Attention`: `to_q_lora_a`/`to_q_lora_b` beside `to_q`, and the same for
`to_k`, `to_v`, `to_out`), so the whole UNet is always one module:

- `freeze_base` takes the place of `split_lora`: every parameter that is
  not an adapter's stops requiring grad, so a Trainer (which trains the
  UNet parameters that require grad) keeps optimizer moments, EMA and
  checkpoints of the adapters alone;
- `merge_lora` has no counterpart: nothing is ever split;
- `fold_lora` returns the state_dict of a rank-0 UNet of the same geometry
  with W' = W + (alpha / r) (A @ B)^T baked in (fp32, cast back).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Union

import torch
from torch import nn

__all__ = ["is_lora_key", "freeze_base", "lora_parameters", "fold_lora"]

# the base parameter of each adapted projection, by the adapter's scope
_BASE = {"to_q": "to_q", "to_k": "to_k", "to_v": "to_v", "to_out": "to_out.0"}


def is_lora_key(name: str) -> bool:
    """True if a parameter name (dotted) belongs to a LoRA adapter."""
    return any(seg.endswith(("_lora_a", "_lora_b"))
               for seg in name.split("."))


def lora_parameters(unet: nn.Module) -> Dict[str, nn.Parameter]:
    """The UNet's adapter parameters by name."""
    return {n: p for n, p in unet.named_parameters() if is_lora_key(n)}


def freeze_base(unet: nn.Module) -> List[str]:
    """Freeze every parameter of `unet` that is not an adapter's, and return
    the adapters' names. Raises ValueError when the UNet has no adapter: a
    silently empty trainable set would train nothing."""
    names = list(lora_parameters(unet))
    if not names:
        raise ValueError(
            "no LoRA params in the UNet — build the model with lora_rank > 0 "
            "(UNetConfig.lora_rank / the builder's lora_rank knob) before "
            "train_lora_only")
    for n, p in unet.named_parameters():
        p.requires_grad_(is_lora_key(n))
    return names


@torch.no_grad()
def fold_lora(unet: Union[nn.Module, Mapping[str, torch.Tensor]],
              alpha: Optional[float] = None,
              config: Any = None) -> Dict[str, torch.Tensor]:
    """The state_dict of a rank-0 UNet with every adapter baked into its
    base weight: W' = W + (alpha / r) (A @ B)^T in fp32, cast back to W's
    dtype. `unet` is the adapter UNet or its state_dict.

    The scale must be the one the model trained with. `config` (the UNet's
    `UNetConfig`) gives the authoritative `lora_alpha`; a bare `alpha` of
    None means scale 1.0; an `alpha` that conflicts with `config` raises
    ValueError, as does an adapter without its other factor or base."""
    if config is not None:
        cfg_alpha = getattr(config, "lora_alpha", None)
        if alpha is not None and cfg_alpha is not None \
                and float(alpha) != float(cfg_alpha):
            raise ValueError(
                f"alpha={alpha} conflicts with config.lora_alpha={cfg_alpha}")
        alpha = cfg_alpha if alpha is None else alpha
    state = dict(unet.state_dict() if isinstance(unet, nn.Module) else unet)
    folded = dict(state)
    suffix = "_lora_a.weight"
    for key in state:
        if not key.endswith(suffix):
            continue
        prefix, scope = key[:-len(suffix)].rsplit(".", 1)
        b_key = f"{prefix}.{scope}_lora_b.weight"
        base_key = f"{prefix}.{_BASE.get(scope, scope)}.weight"
        if b_key not in state or base_key not in state:
            raise ValueError(f"incomplete LoRA triplet around {key}")
        a, b, w = state[key], state[b_key], state[base_key]
        rank = a.shape[0]
        scale = (float(alpha) if alpha is not None else float(rank)) / rank
        # JAX's (in, r) @ (r, out) product, transposed to (out, in)
        delta = (a.t().float() @ b.t().float()) * scale
        folded[base_key] = (w.float() + delta.t()).to(w.dtype)
        del folded[key], folded[b_key]
    return folded
