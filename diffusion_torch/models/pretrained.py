"""Load published (diffusers/transformers-layout) weights into the port's
modules, in place.

Counterpart of `diffusion_tpu/models/pretrained.py` (`_validate`,
`_cast_like`, `load_component`, `load_pretrained_params`). A pretrained
directory holds, for each of `unet`, `vae` and `text_encoder`, either the
`<name>.msgpack` file that `tools/port_weights.py` writes (read first, as
the JAX loader does, and moved over by `models/port_jax.py`) or the
`<name>/` subdirectory of `*.safetensors` files that diffusers and
transformers publish. The port's modules carry the diffusers and
transformers parameter names, so such a `state_dict` loads as it is.

Each component is checked against the module's own `state_dict()`: every
missing key, unexpected key and shape mismatch is reported in one
ValueError. Keys the port has no place for are set aside by a named rule
(`SET_ASIDE`), never by a catch-all. The values are cast to the module's
dtype (an fp16 checkpoint becomes fp32 master weights) and copied into
the existing tensors, so the `Parameter` objects stay the same.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from diffusion_torch.models.port_jax import (clip_text_from_jax,
                                             unet_from_jax, vae_from_jax)
from diffusion_torch.utils import flax_msgpack, safetensors

__all__ = ["load_component", "load_pretrained_params", "load_state_into",
           "copy_into", "validate", "SET_ASIDE"]

_PORTERS: Dict[str, Callable] = {"unet": unet_from_jax, "vae": vae_from_jax,
                                 "text_encoder": clip_text_from_jax}

# component -> (key prefixes the port sets aside, why)
SET_ASIDE: Dict[str, Tuple[Tuple[str, ...], str]] = {
    "text_encoder": (("text_model.embeddings.position_ids",),
                     "transformers' buffer of position indices; the port "
                     "computes the positions"),
}


def _set_aside(name: str, state: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
    prefixes = SET_ASIDE.get(name, ((), ""))[0]
    return {k: v for k, v in state.items() if not k.startswith(prefixes)}


def validate(what: str, got: Mapping[str, torch.Tensor],
             want: Mapping[str, torch.Tensor]) -> None:
    """Raise one ValueError listing every missing key, unexpected key and
    shape mismatch of `got` against the module's `want` state_dict;
    `what` names the weights (e.g. "pretrained unet weights")."""
    problems = []
    for k in sorted(want.keys() - got.keys()):
        problems.append(f"missing {k} (want shape {tuple(want[k].shape)})")
    for k in sorted(got.keys() - want.keys()):
        problems.append(f"unexpected {k} (shape {tuple(got[k].shape)})")
    for k in sorted(want.keys() & got.keys()):
        if tuple(want[k].shape) != tuple(got[k].shape):
            problems.append(f"shape mismatch {k}: checkpoint "
                            f"{tuple(got[k].shape)} vs model "
                            f"{tuple(want[k].shape)}")
    if problems:
        shown = "\n  ".join(problems[:10])
        more = (f"\n  ... and {len(problems) - 10} more"
                if len(problems) > 10 else "")
        raise ValueError(
            f"{what} do not match the model geometry "
            f"({len(problems)} problems):\n  {shown}{more}")


@torch.no_grad()
def copy_into(what: str, own: Mapping[str, torch.Tensor],
              got: Mapping[str, torch.Tensor]) -> None:
    """Validate `got` against `own` and copy it into `own`'s tensors in
    place, cast to each one's dtype and moved to its device."""
    validate(what, got, own)
    for k, v in got.items():
        own[k].copy_(v)


def load_state_into(name: str, module: torch.nn.Module,
                    state: Mapping[str, torch.Tensor]) -> None:
    """Load one component's `state` into `module` in place."""
    copy_into(f"pretrained {name} weights", module.state_dict(keep_vars=True),
              state)


def load_component(path: str, name: str) -> Dict[str, torch.Tensor]:
    """One component's state_dict: `<path>/<name>.msgpack`, else the
    `<path>/<name>/` safetensors, with the keys of `SET_ASIDE` left out."""
    msgpack_path = os.path.join(path, f"{name}.msgpack")
    if os.path.exists(msgpack_path):
        return _PORTERS[name](flax_msgpack.load(msgpack_path))
    subdir = os.path.join(path, name)
    if os.path.isdir(subdir):
        return _set_aside(name, safetensors.load_dir(subdir))
    raise FileNotFoundError(
        f"no pretrained weights for {name!r} under {path}: expected "
        f"{name}.msgpack (from tools/port_weights.py) or a {name}/ "
        f"safetensors subdirectory")


def load_pretrained_params(model, path: Optional[str] = None,
                           want_frozen: Optional[bool] = None) -> None:
    """Load the UNet and, when `want_frozen`, the VAE and text towers of
    `model` from `path` (default: the model's `pretrained_path`).

    `want_frozen=None` loads the towers where the builder built them,
    which it does by the JAX rule: not on the precomputed-latent path
    without a generation eval."""
    path = path or getattr(model, "pretrained_path", None)
    if not path:
        raise ValueError("model has no pretrained_path (build it with "
                         "pretrained=True, model_name=<checkpoint dir>)")
    if want_frozen is None:
        want_frozen = model.text_encoder is not None
    if want_frozen and (model.vae is None or model.text_encoder is None):
        raise ValueError("want_frozen=True but the model was built without "
                         "its frozen VAE and text towers")
    load_state_into("unet", model.unet, load_component(path, "unet"))
    if want_frozen:
        load_state_into("vae", model.vae, load_component(path, "vae"))
        load_state_into("text_encoder", model.text_encoder,
                        load_component(path, "text_encoder"))
