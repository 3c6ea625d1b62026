"""Frechet Inception Distance with streaming mean/cov accumulation.

A copy of `diffusion_tpu/metrics/fid.py` (numpy only) over the port's
`metrics/base.py`: torchmetrics' FrechetInceptionDistance (normalize=True)
as the reference uses it (update(real=...), then update(fake=...)). The
features come from the port's InceptionV3 (`metrics/towers.py`); the
(2048,) and (2048, 2048) float64 sums live on the host and are summed
across processes at compute().

FID = |mu_r - mu_f|^2 + tr(C_r + C_f - 2 (C_r C_f)^{1/2}); the matrix square
root is an `eigh` of the symmetrized product (no scipy).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np

from diffusion_torch.metrics.base import Metric, all_hosts_sum

__all__ = ["FrechetInceptionDistance", "frechet_distance"]


def _sqrtm_psd(mat: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    """Symmetric PSD matrix square root via eigendecomposition."""
    mat = (mat + mat.T) / 2.0
    vals, vecs = np.linalg.eigh(mat)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray,
                     mu2: np.ndarray, sigma2: np.ndarray) -> float:
    """Closed-form Frechet distance between two Gaussians.

    tr((C1 C2)^{1/2}) computed as tr of sqrtm(S1^{1/2} C2 S1^{1/2}) — the
    symmetric-form trick keeps everything PSD so eigh is enough."""
    diff = mu1 - mu2
    s1_half = _sqrtm_psd(sigma1)
    covmean = _sqrtm_psd(s1_half @ sigma2 @ s1_half)
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(covmean))


class FrechetInceptionDistance(Metric):
    """update(images, real=True/False) with [0,1] NHWC images.

    `feature_fn(images) -> (B, D) features` is typically an InceptionV3
    apply (see metrics/towers.py); injectable for tests.
    """

    def __init__(self, feature_fn: Optional[Callable] = None,
                 feature_dim: int = 2048, normalize: bool = True):
        self.feature_fn = feature_fn
        self.feature_dim = feature_dim
        self.normalize = normalize
        self.reset()

    def reset(self) -> None:
        d = self.feature_dim
        self._sum = {True: np.zeros(d), False: np.zeros(d)}
        self._outer = {True: np.zeros((d, d)), False: np.zeros((d, d))}
        self._n = {True: 0.0, False: 0.0}

    def update(self, images: Any = None, real: bool = True,
               features: Any = None) -> None:
        if features is None:
            if self.feature_fn is None:
                raise ValueError("need feature_fn or precomputed features")
            features = self.feature_fn(images)
        f = np.asarray(features, np.float64)
        self._sum[real] += f.sum(axis=0)
        self._outer[real] += f.T @ f
        self._n[real] += f.shape[0]

    def _stats(self, real: bool):
        n = all_hosts_sum(np.asarray([self._n[real]]))[0]
        s = all_hosts_sum(self._sum[real])
        o = all_hosts_sum(self._outer[real])
        mu = s / n
        # unbiased covariance from streaming sums
        cov = (o - n * np.outer(mu, mu)) / max(n - 1.0, 1.0)
        return mu, cov, n

    def compute(self) -> float:
        mu_r, cov_r, n_r = self._stats(True)
        mu_f, cov_f, n_f = self._stats(False)
        if n_r < 2 or n_f < 2:
            return float("nan")
        return frechet_distance(mu_r, cov_r, mu_f, cov_f)
