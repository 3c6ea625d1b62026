"""Mean squared error metric (torchmetrics.MeanSquaredError parity,
reference: diffusion/models/models.py:62, stable_diffusion.py:231-240 with
per-loss-bin timestep masking).

A copy of `diffusion_tpu/metrics/mse.py` over the port's `metrics/base.py`.
"""

from __future__ import annotations

import numpy as np

from diffusion_torch.metrics.base import Metric, all_hosts_sum

__all__ = ["MeanSquaredError"]


class MeanSquaredError(Metric):
    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._sum = 0.0
        self._count = 0.0

    def update(self, preds, target, mask=None) -> None:
        preds = np.asarray(preds, np.float64)
        target = np.asarray(target, np.float64)
        err = (preds - target) ** 2
        if mask is not None:
            mask = np.asarray(mask, bool)
            err = err[mask]
        self._sum += float(err.sum())
        self._count += float(err.size)

    def update_sums(self, sq_sum: float, count: float) -> None:
        """Direct accumulation from device-side reductions."""
        self._sum += float(sq_sum)
        self._count += float(count)

    def compute(self) -> float:
        total = all_hosts_sum(np.asarray([self._sum, self._count]))
        return float(total[0] / total[1]) if total[1] else float("nan")
