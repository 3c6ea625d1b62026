"""InceptionV3, the FID variant: the feature tower of FID and the class
logits of the Inception Score.

Counterpart of `diffusion_tpu/models/inception.py` ("pt_inception-2015-12-
05"): stem convolutions -> 3x InceptionA -> InceptionB -> 4x InceptionC ->
InceptionD -> 2x InceptionE (the second max-pools in its pool branch, the
FID variant) -> global average pool -> 2048 features -> the 1008-way `fc`.
Every convolution has no bias and is followed by BatchNorm with running
statistics (eps 1e-3) and ReLU; the pool branches average over 3x3 with
`count_include_pad=False` (the FID variant's patch to torchvision). The
modules carry torchvision's names (`Mixed_5b.branch1x1.conv.weight`,
`...bn.running_mean`), so `tools/port_weights.py`'s `port_inception` and
`models/port_jax.py`'s `inception_from_jax` are exact inverses.

fp32 throughout. Input: (B, 299, 299, 3) in [-1, 1], NHWC as in the JAX
package (viewed as NCHW channels_last inside); `preprocess_images` makes
it from [0, 1] images of any size. `load_inception_params` reads the `.npz`
(`"/"`-joined flax keys) or `.msgpack` that `tools/port_weights.py` writes.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["InceptionV3", "preprocess_images", "load_inception_params",
           "resize_bilinear"]

# a kernel size or padding: one int, or (height, width)
_Pad = Union[int, Tuple[int, int]]


class BatchNorm(nn.Module):
    """Inference BatchNorm over running statistics: `weight`, `bias`,
    `running_mean`, `running_var` (torchvision's names, without
    `num_batches_tracked`). Fresh statistics are flax's: mean 0, var 1."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class BasicConv(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: _Pad, stride: int = 1,
                 padding: _Pad = 0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride,
                              padding=padding, bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _maxpool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=2)


def _avgpool3(x: torch.Tensor) -> torch.Tensor:
    # count_include_pad=False: a border pixel divides by its real window
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv(cin, 64, 1)
        self.branch5x5_1 = BasicConv(cin, 48, 1)
        self.branch5x5_2 = BasicConv(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, padding=1)
        self.branch_pool = BasicConv(cin, pool_features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(_avgpool3(x))], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _maxpool(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv(cin, 192, 1)
        self.branch7x7_1 = BasicConv(cin, c7, 1)
        self.branch7x7_2 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv(cin, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avgpool3(x))], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv(cin, 192, 1)
        self.branch3x3_2 = BasicConv(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv(192, 192, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _maxpool(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, pool_mode: str):
        super().__init__()
        self.pool_mode = pool_mode       # "max" in the FID variant's second
        self.branch1x1 = BasicConv(cin, 320, 1)
        self.branch3x3_1 = BasicConv(cin, 384, 1)
        self.branch3x3_2a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv(cin, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       dim=1)
        pooled = (_avgpool3(x) if self.pool_mode == "avg"
                  else F.max_pool2d(x, 3, stride=1, padding=1))
        return torch.cat([self.branch1x1(x), b3, bd,
                          self.branch_pool(pooled)], dim=1)


class InceptionV3(nn.Module):
    def __init__(self, num_classes: int = 1008):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")
        self.fc = nn.Linear(2048, num_classes)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 299, 299, 3) NHWC in [-1, 1] -> (B, 2048) pooled features."""
        x = x.float().permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _maxpool(x)
        x = _maxpool(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)))
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))

    def forward(self, x: torch.Tensor,
                return_logits: bool = False) -> torch.Tensor:
        """Features (B, 2048), or the 1008-way logits."""
        feats = self.features(x)
        return self.fc(feats) if return_logits else feats


def resize_bilinear(images: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """NHWC -> NHWC at `size` (H, W), bilinear with antialiasing when it
    shrinks: `jax.image.resize(..., "bilinear")`'s function (without
    `antialias=True`, a shrink differs from it by up to 0.55)."""
    x = images.permute(0, 3, 1, 2)
    x = F.interpolate(x, size=tuple(size), mode="bilinear",
                      align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1)


def preprocess_images(images: torch.Tensor, size: int = 299) -> torch.Tensor:
    """[0, 1] NHWC images -> bilinear to size x size -> [-1, 1] (the
    torchmetrics `normalize=True` path)."""
    images = images.float()
    if tuple(images.shape[1:3]) != (size, size):
        images = resize_bilinear(images, (size, size))
    return images * 2.0 - 1.0


def load_inception_params(path: str) -> Dict[str, Any]:
    """A flax variables tree (nested dicts of numpy arrays) from the
    `.npz` (`"/"`-joined keys) or `.msgpack` file `tools/port_weights.py`
    writes; `models/port_jax.py` turns it into a state_dict."""
    if path.endswith(".npz"):
        tree: Dict[str, Any] = {}
        with np.load(path, allow_pickle=False) as flat:
            for key in flat.files:
                node = tree
                parts = key.split("/")
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = flat[key]
        return tree
    from diffusion_torch.utils import flax_msgpack
    return flax_msgpack.load(path)
