"""CLIPScore: cosine similarity between CLIP image and text embeddings.

A copy of `diffusion_tpu/metrics/clip_score.py` (numpy only) over the
port's `metrics/base.py`: torchmetrics' CLIPScore as the reference computes
it per guidance scale. Score = 100 * max(0, mean cos(text, image)): the
mean is clamped, not each sample. The embeddings come from the port's
CLIPModel (`metrics/towers.py`).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np

from diffusion_torch.metrics.base import Metric, all_hosts_sum

__all__ = ["CLIPScore"]


class CLIPScore(Metric):
    """update(images, input_ids): images [0,1] NHWC; ids (B, 77).

    `embed_fn(images, input_ids) -> (img_emb, txt_emb)` typically wraps a
    CLIPModel forward (metrics/towers.py); injectable for tests.
    """

    def __init__(self, embed_fn: Optional[Callable] = None):
        self.embed_fn = embed_fn
        self.reset()

    def reset(self) -> None:
        self._sum = 0.0
        self._n = 0.0

    def update(self, images: Any = None, input_ids: Any = None,
               embeddings: Any = None) -> None:
        if embeddings is None:
            if self.embed_fn is None:
                raise ValueError("need embed_fn or precomputed embeddings")
            embeddings = self.embed_fn(images, input_ids)
        img, txt = (np.asarray(e, np.float64) for e in embeddings)
        img = img / np.linalg.norm(img, axis=-1, keepdims=True)
        txt = txt / np.linalg.norm(txt, axis=-1, keepdims=True)
        # accumulate UNclamped; torchmetrics clamps the mean at compute()
        # (torchmetrics.multimodal.CLIPScore semantics), not per sample
        score = 100.0 * (img * txt).sum(axis=-1)
        self._sum += float(score.sum())
        self._n += score.shape[0]

    def compute(self) -> float:
        total = all_hosts_sum(np.asarray([self._sum, self._n]))
        return float(max(total[0] / total[1], 0.0)) if total[1] \
            else float("nan")
