"""The generation metrics' towers: InceptionV3 (FID features, IS logits)
and CLIP ViT-L/14 (CLIPScore embeddings), as fp32 forwards.

Counterpart of `diffusion_tpu/metrics/towers.py`. The weights are the
`.npz` files `tools/port_weights.py` writes (`port_inception`,
`port_clip_metric`), moved over by `models/port_jax.py`: a local path or an
`s3://`/`gs://` URL (fetched once into a cache under the temporary
directory), from the argument or from the variables the JAX package and
`yamls/eval.yaml` read, `DIFFUSION_TPU_INCEPTION_WEIGHTS` and
`DIFFUSION_TPU_CLIP_WEIGHTS`, so one job spec drives either package.

A tower without weights refuses to run: FID, IS and CLIPScore over random
towers are noise. `allow_random_weights=True` (or
`DIFFUSION_TPU_ALLOW_RANDOM_TOWERS=1`) opts in, for runs that exercise the
shapes and the path, not the values; the random weights are drawn as
flax's defaults would, from seed 0.

No tower is cached for the process: `inception_tower` and `clip_tower`
build one each call, and it lives as long as something holds it, as in
the JAX package. The generation-metric hook loads each tower once and
hands it to every function that needs it (the features and the logits of
one InceptionV3 through `tower=`; every guidance scale), and dropping the
hook frees them. Each function keeps its tower as `fn.tower`. The functions
run under
`torch.inference_mode()` on the tower's device (CUDA unless the caller
asks for the CPU; it raises where CUDA is missing) and return host numpy
float32 arrays: the metrics accumulate on the host in float64. Each forward
runs with TF32 off for cuDNN's convolutions and cuBLAS's matmuls, whatever
the caller set, and restores the caller's flags after: the features are
full fp32 on the card as on the CPU.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Callable, Optional

import numpy as np
import torch

from diffusion_torch.models.clip import (CLIPModel, VIT_L14_TEXT_CONFIG,
                                         VIT_L14_VISION_CONFIG)
from diffusion_torch.models.inception import (InceptionV3,
                                              load_inception_params,
                                              preprocess_images,
                                              resize_bilinear)
from diffusion_torch.models.layers import init_like_flax_
from diffusion_torch.models.port_jax import (clip_model_from_jax,
                                             inception_from_jax)
from diffusion_torch.utils.device import Device, resolve_device

__all__ = ["inception_feature_fn", "inception_logits_fn", "clip_embed_fn",
           "resolve_weights_path", "inception_tower", "clip_tower"]

_ENV_ALLOW_RANDOM = "DIFFUSION_TPU_ALLOW_RANDOM_TOWERS"
_ENV_INCEPTION = "DIFFUSION_TPU_INCEPTION_WEIGHTS"
_ENV_CLIP = "DIFFUSION_TPU_CLIP_WEIGHTS"
# OpenAI CLIP's image normalization
_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def resolve_weights_path(path: Optional[str], env_var: str) -> Optional[str]:
    """A weights location as a local file, downloading an object-store URL
    (s3://, gs://) into a cache directory. None only when nothing is
    configured; a configured path that does not exist raises (a silent
    fallback to random towers would hide a mistyped path)."""
    path = path or os.environ.get(env_var)
    if not path:
        return None
    if "://" in path:
        from diffusion_torch.data.object_store import ObjectStore
        cache = os.path.join(tempfile.gettempdir(), "diffusion_torch_towers")
        os.makedirs(cache, exist_ok=True)
        local = os.path.join(cache, os.path.basename(path))
        if not os.path.exists(local):
            ObjectStore().download(path, local)
        return local
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"metric tower weights path {path!r} (from arg or {env_var}) "
            f"does not exist")
    return path


def _random_allowed(allow_random_weights: bool) -> bool:
    return allow_random_weights or os.environ.get(_ENV_ALLOW_RANDOM) == "1"


def _refuse(tower: str, env_var: str):
    raise RuntimeError(
        f"No pretrained weights for the {tower} metric tower: set {env_var} "
        f"(or the explicit weights arg) to an .npz produced by "
        f"tools/port_weights.py — a local path or s3://gs:// URL. Metric "
        f"values from randomly initialized towers are noise; pass "
        f"allow_random_weights=True (or {_ENV_ALLOW_RANDOM}=1) only in "
        f"tests that exercise shapes, not values.")


def _tower(kind: str, path: Optional[str], device: torch.device):
    """A new tower, fp32, in eval mode, without gradients: from `path`, or
    random (seed 0) when `path` is None."""
    with torch.device(device):
        model = InceptionV3() if kind == "inception" else CLIPModel(
            VIT_L14_TEXT_CONFIG, VIT_L14_VISION_CONFIG)
    if path is None:
        with torch.no_grad():
            init_like_flax_(model, torch.Generator(device=device)
                            .manual_seed(0))
    else:
        porter = inception_from_jax if kind == "inception" \
            else clip_model_from_jax
        model.load_state_dict(porter(load_inception_params(path)))
    return model.eval().requires_grad_(False)


def _build(kind: str, env_var: str, name: str,
           weights_path: Optional[str], allow_random_weights: bool,
           device: Device):
    path = resolve_weights_path(weights_path, env_var)
    if path is None and not _random_allowed(allow_random_weights):
        _refuse(name, env_var)
    return _tower(kind, path, resolve_device(device))


def inception_tower(weights_path: Optional[str] = None,
                    allow_random_weights: bool = False,
                    device: Device = None) -> InceptionV3:
    """The FID InceptionV3 (see the module docstring for the weights)."""
    return _build("inception", _ENV_INCEPTION, "InceptionV3", weights_path,
                  allow_random_weights, device)


def clip_tower(weights_path: Optional[str] = None,
               allow_random_weights: bool = False,
               device: Device = None) -> CLIPModel:
    """The CLIPScore model, ViT-L/14's two towers and projections."""
    return _build("clip", _ENV_CLIP, "CLIP", weights_path,
                  allow_random_weights, device)


@contextlib.contextmanager
def fp32_forward():
    """TF32 off for cuDNN and cuBLAS while a tower runs; the caller's
    flags come back after."""
    backends = (torch.backends.cudnn, torch.backends.cuda.matmul)
    saved = [b.allow_tf32 for b in backends]
    try:
        for b in backends:
            b.allow_tf32 = False
        yield
    finally:
        for b, flag in zip(backends, saved):
            b.allow_tf32 = flag


def _images(images, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(images).to(device, torch.float32)


def inception_feature_fn(weights_path: Optional[str] = None,
                         allow_random_weights: bool = False,
                         device: Device = None,
                         tower: Optional[torch.nn.Module] = None
                         ) -> Callable:
    """[0, 1] NHWC images of any size -> (B, 2048) features, from `tower`
    where given, else from an InceptionV3 loaded here."""
    model = tower if tower is not None else inception_tower(
        weights_path, allow_random_weights, device)
    dev = model.fc.weight.device

    @torch.inference_mode()
    @fp32_forward()
    def fn(images) -> np.ndarray:
        return model(preprocess_images(_images(images, dev))).cpu().numpy()

    fn.tower = model
    return fn


def inception_logits_fn(weights_path: Optional[str] = None,
                        allow_random_weights: bool = False,
                        device: Device = None,
                        tower: Optional[torch.nn.Module] = None
                        ) -> Callable:
    """[0, 1] NHWC images of any size -> (B, 1008) logits, from `tower`
    where given, else from an InceptionV3 loaded here."""
    model = tower if tower is not None else inception_tower(
        weights_path, allow_random_weights, device)
    dev = model.fc.weight.device

    @torch.inference_mode()
    @fp32_forward()
    def fn(images) -> np.ndarray:
        return model(preprocess_images(_images(images, dev)),
                     return_logits=True).cpu().numpy()

    fn.tower = model
    return fn


def clip_pixels(images: torch.Tensor, size: int) -> torch.Tensor:
    """[0, 1] NHWC images -> bilinear (antialiased) to size x size -> CLIP's
    mean/std normalization."""
    if tuple(images.shape[1:3]) != (size, size):
        images = resize_bilinear(images, (size, size))
    mean = torch.tensor(_CLIP_MEAN, device=images.device)
    std = torch.tensor(_CLIP_STD, device=images.device)
    return (images - mean) / std


def clip_embed_fn(weights_path: Optional[str] = None,
                  allow_random_weights: bool = False,
                  device: Device = None) -> Callable:
    """([0, 1] NHWC images, token ids (B, 77)) -> (image embeddings, text
    embeddings), each (B, 768)."""
    model = clip_tower(weights_path, allow_random_weights, device)
    dev = model.text_projection.weight.device
    size = model.vision_config.image_size

    @torch.inference_mode()
    @fp32_forward()
    def fn(images, input_ids):
        pixels = clip_pixels(_images(images, dev), size)
        txt, img = model(torch.as_tensor(input_ids).to(dev, torch.int64),
                         pixels)
        return img.cpu().numpy(), txt.cpu().numpy()

    fn.tower = model
    return fn
