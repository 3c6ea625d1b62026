"""Metric protocol: update/compute/reset with a cross-process reduction.

Counterpart of `diffusion_tpu/metrics/base.py` (the torchmetrics surface the
reference consumes: MeanSquaredError from yaml, names like
'FrechetInceptionDistance-scale-3p0' per guidance scale). Accumulators are
plain float sums; `all_hosts_sum` folds per-process partial sums with
`torch.distributed.all_reduce` when torch.distributed is initialised, and
is the identity otherwise.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Metric", "all_hosts_sum", "scale_suffix"]


def all_hosts_sum(x: np.ndarray) -> np.ndarray:
    """Sum a small host-local accumulator across processes."""
    if not (dist.is_available() and dist.is_initialized()):
        return np.asarray(x)
    t = torch.as_tensor(np.asarray(x, np.float64))
    if dist.get_backend() == "nccl":
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    dist.all_reduce(t)
    return t.cpu().numpy()


def scale_suffix(metric_name: str, guidance_scale: float) -> str:
    """'FrechetInceptionDistance', 3.0 -> 'FrechetInceptionDistance-scale-3p0'
    (reference stable_diffusion.py:118-123 name mangling)."""
    return f"{metric_name}-scale-{str(float(guidance_scale)).replace('.', 'p')}"


class Metric:
    def update(self, *args: Any, **kwargs: Any) -> None:
        raise NotImplementedError

    def compute(self) -> float:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError
