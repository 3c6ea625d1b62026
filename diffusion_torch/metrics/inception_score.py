"""Inception Score from class logits.

A copy of `diffusion_tpu/metrics/inception_score.py` (numpy only) over the
port's `metrics/base.py`: torchmetrics' InceptionScore as the reference
uses it per guidance scale. IS = exp(E_x KL(p(y|x) || p(y))), averaged over
`splits` chunks. The logits come from the InceptionV3's 1008-way head
(`metrics/towers.py`); the probabilities accumulate on the host.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import numpy as np

from diffusion_torch.metrics.base import Metric

__all__ = ["InceptionScore"]


def _softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


class InceptionScore(Metric):
    def __init__(self, logits_fn: Optional[Callable] = None, splits: int = 10,
                 normalize: bool = True):
        self.logits_fn = logits_fn
        self.splits = splits
        self.normalize = normalize
        self.reset()

    def reset(self) -> None:
        self._probs: List[np.ndarray] = []

    def update(self, images: Any = None, logits: Any = None) -> None:
        if logits is None:
            if self.logits_fn is None:
                raise ValueError("need logits_fn or precomputed logits")
            logits = self.logits_fn(images)
        self._probs.append(_softmax(np.asarray(logits, np.float64)))

    def compute(self) -> float:
        if not self._probs:
            return float("nan")
        probs = np.concatenate(self._probs, axis=0)
        n = probs.shape[0]
        scores = []
        for chunk in np.array_split(probs, min(self.splits, n)):
            marginal = chunk.mean(axis=0, keepdims=True)
            kl = (chunk * (np.log(chunk + 1e-12) - np.log(marginal + 1e-12))
                  ).sum(axis=1)
            scores.append(np.exp(kl.mean()))
        return float(np.mean(scores))
