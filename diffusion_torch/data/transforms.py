"""Host-side image transforms (PIL/numpy; no torch).

A copy of `diffusion_tpu/data/transforms.py`, which imports no jax, with its
imports pointed at the port's modules: the port imports nothing of
the JAX package.

The equivalents of the reference's torchvision transforms (reference:
diffusion/datasets/laion/transforms.py:9-21 LargestCenterSquare — aspect-
preserving resize of the short side then center crop, x3 identical copies
across dataset dirs; datasets/wds/transforms.py:26-49 CenterCropSDTransform —
numpy crop + bicubic resize + /127.5-1). Output is float32 NHWC-per-sample
(H, W, 3), the JAX package's layout, instead of CHW tensors.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from PIL import Image

__all__ = ["LargestCenterSquare", "CenterCropSDTransform", "to_tensor",
           "normalize", "sd_normalize", "RandomCropSquare",
           "SDSquareNormalize"]


def to_tensor(img: Image.Image) -> np.ndarray:
    """PIL -> float32 (H, W, 3) in [0, 1]."""
    arr = np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0
    return arr


def normalize(arr: np.ndarray, mean: float = 0.5, std: float = 0.5) -> np.ndarray:
    return (arr - mean) / std


def sd_normalize(img: Image.Image) -> np.ndarray:
    """[0,255] -> [-1,1] float32 HWC (the SD training input contract,
    reference datasets/image_caption.py:160-166 Normalize(0.5, 0.5))."""
    return normalize(to_tensor(img))


class LargestCenterSquare:
    """Resize short side to `size`, then center-crop to (size, size)."""

    def __init__(self, size: int):
        self.size = int(size)

    def __call__(self, img: Image.Image) -> Image.Image:
        w, h = img.size
        scale = self.size / min(w, h)
        nw, nh = max(round(w * scale), self.size), max(round(h * scale), self.size)
        img = img.resize((nw, nh), Image.BICUBIC)
        left = (nw - self.size) // 2
        top = (nh - self.size) // 2
        return img.crop((left, top, left + self.size, top + self.size))


class RandomCropSquare:
    """Resize short side then random square crop (data-augmented variant)."""

    def __init__(self, size: int, rng: Optional[np.random.Generator] = None):
        self.size = int(size)
        self.rng = rng or np.random.default_rng()

    def __call__(self, img: Image.Image) -> Image.Image:
        w, h = img.size
        scale = self.size / min(w, h)
        nw, nh = max(round(w * scale), self.size), max(round(h * scale), self.size)
        img = img.resize((nw, nh), Image.BICUBIC)
        left = int(self.rng.integers(0, nw - self.size + 1))
        top = int(self.rng.integers(0, nh - self.size + 1))
        return img.crop((left, top, left + self.size, top + self.size))


class CenterCropSDTransform:
    """Center-crop to square then bicubic resize to `size`, scaled to [-1,1]
    (reference wds/transforms.py:26-49)."""

    def __init__(self, center_crop: bool = True, size: int = 256):
        self.center_crop = center_crop
        self.size = int(size)

    def __call__(self, img: Image.Image) -> np.ndarray:
        img = img.convert("RGB")
        arr = np.asarray(img)
        if self.center_crop:
            h, w = arr.shape[:2]
            side = min(h, w)
            top = (h - side) // 2
            left = (w - side) // 2
            arr = arr[top:top + side, left:left + side]
        out = Image.fromarray(arr).resize((self.size, self.size), Image.BICUBIC)
        return np.asarray(out, dtype=np.float32) / 127.5 - 1.0


class SDSquareNormalize:
    """LargestCenterSquare resize/crop followed by sd_normalize — the default
    train transform (reference image_caption.py:160-166's
    LargestCenterSquare->ToTensor->Normalize(0.5,0.5) compose) as a picklable
    callable so datasets can cross into process-pool decode workers."""

    def __init__(self, size: int):
        self.size = size  # decode paths read this for JPEG draft scaling
        self.crop = LargestCenterSquare(size)

    def __call__(self, img: Image.Image) -> np.ndarray:
        return sd_normalize(self.crop(img))
