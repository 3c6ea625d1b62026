"""AdamW and LR schedules, as the JAX package's optax chain computes them.

Counterpart of `diffusion_tpu/train/optim.py`. `adamw` is the same spec
dict; `build_optimizer` returns an `AdamW` over the given parameters that
performs optax's `chain(clip_by_global_norm(c), adamw(lr=schedule))` update
step for step:

- clipping multiplies the gradients by min(1, c / ||g||) (optax's
  `clip_by_global_norm`, not `clip_grad_norm_`'s c / (||g|| + 1e-6));
- the moments are ``mu = (1 - b1) g + b1 mu`` and ``nu = (1 - b2) g^2 +
  b2 nu``, bias-corrected by the update count, and the update is
  ``mu_hat / (sqrt(nu_hat) + eps) + weight_decay * p`` (eps outside the
  square root; decoupled weight decay on every parameter);
- the learning rate is ``lr * schedule(count)`` at optax's own update
  count, which starts at 0 and advances only when an update is applied (a
  skipped non-finite step leaves it where it was);
- ``mu_dtype="bfloat16"`` keeps the first moment in bf16, computing in
  fp32 and casting after the update, as optax does.

The schedules are the JAX module's numpy versions, copied (they import no
jax); 'Time' strings resolve against `max_duration`/`batches_per_epoch`.
"""

from __future__ import annotations

import logging
from typing import Callable, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch

from diffusion_torch.utils.time import time_to_batches

__all__ = ["AdamW", "adamw", "build_optimizer", "global_norm",
           "multi_step_with_warmup", "cosine_annealing_with_warmup",
           "linear_with_warmup", "constant_with_warmup", "constant_scheduler"]

Schedule = Callable[[int], float]

_MU_DTYPES = {None: None, "float32": torch.float32,
              "bfloat16": torch.bfloat16}


def adamw(lr: float = 1e-4, betas: Sequence[float] = (0.9, 0.999),
          eps: float = 1e-8, weight_decay: float = 0.01,
          mu_dtype: Optional[str] = None) -> dict:
    """AdamW config node (the JAX spec dict; torch.optim.AdamW's names)."""
    return {"name": "adamw", "lr": float(lr), "betas": tuple(betas),
            "eps": float(eps), "weight_decay": float(weight_decay),
            "mu_dtype": mu_dtype}


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over every element, fp32 (optax.global_norm)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


class AdamW:
    """optax's clip + adamw chain over a list of fp32 parameters, reading
    their `.grad`. `count` is optax's update count."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 1e-4,
                 betas: Sequence[float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.01, mu_dtype: Optional[str] = None,
                 schedule: Optional[Schedule] = None,
                 grad_clip_norm: Optional[float] = None):
        if mu_dtype not in _MU_DTYPES:
            raise ValueError(f"mu_dtype {mu_dtype!r}: choose from "
                             f"{sorted(k for k in _MU_DTYPES if k)} or None")
        self.params: List[torch.Tensor] = list(params)
        self.lr, self.eps, self.weight_decay = float(lr), eps, weight_decay
        self.b1, self.b2 = betas
        self.schedule = schedule
        self.grad_clip_norm = grad_clip_norm
        mu = _MU_DTYPES[mu_dtype]
        self.mu = [torch.zeros_like(p, dtype=mu or p.dtype)
                   for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def lr_at(self, count: int) -> float:
        """The learning rate an update at optax count `count` uses."""
        if self.schedule is None:
            return self.lr
        return self.lr * float(self.schedule(count))

    @torch.no_grad()
    def step(self, grad_norm: Optional[torch.Tensor] = None) -> None:
        """One update from the parameters' `.grad` (clipped in place);
        `grad_norm` is their global norm when the caller has it already.
        Moments and parameters update in place, so the step holds two
        parameter-sized temporaries at most."""
        grads = [p.grad for p in self.params]
        if self.grad_clip_norm:
            if grad_norm is None:
                grad_norm = global_norm(grads)
            torch._foreach_mul_(
                grads, torch.clamp(self.grad_clip_norm / grad_norm, max=1.0))
        lr = self.lr_at(self.count)
        self.count += 1
        b1, b2 = self.b1, self.b2
        # mu = (1 - b1) g + b1 mu. JAX's promotion: b1 * mu runs in mu's
        # dtype with b1 rounded to it (a weakly typed scalar), the sum in
        # fp32 even when mu is kept in bf16
        if self.mu[0].dtype == torch.float32:
            mu = self.mu
            torch._foreach_mul_(mu, b1)
        else:
            mu = [m.float() for m in torch._foreach_mul(
                self.mu, torch.tensor(b1, dtype=self.mu[0].dtype).item())]
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        update = torch._foreach_div(mu, 1.0 - b1 ** self.count)   # mu_hat
        denom = torch._foreach_div(self.nu, 1.0 - b2 ** self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(update, denom)
        del denom
        torch._foreach_add_(update, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, update, alpha=-lr)
        if mu is not self.mu:
            for old, new in zip(self.mu, mu):
                old.copy_(new)


def build_optimizer(params: Iterable[torch.Tensor],
                    spec: Optional[dict] = None,
                    schedule: Optional[Schedule] = None,
                    grad_clip_norm: Optional[float] = None) -> AdamW:
    """[clip] -> adamw(lr = base_lr * schedule(count)) over `params`."""
    spec = spec or adamw()
    if spec.get("name", "adamw") != "adamw":
        raise ValueError(f"unknown optimizer {spec.get('name')!r}")
    return AdamW(params, lr=spec["lr"], betas=spec["betas"], eps=spec["eps"],
                 weight_decay=spec["weight_decay"],
                 mu_dtype=spec.get("mu_dtype"), schedule=schedule,
                 grad_clip_norm=grad_clip_norm)


def _resolve(t, max_duration, batches_per_epoch, scale: float = 1.0) -> int:
    return max(int(scale * time_to_batches(t, max_duration, batches_per_epoch)), 0)


def _warm(s: np.ndarray, warmup: int):
    return np.minimum(s / max(warmup, 1), 1.0) if warmup > 0 else 1.0


def multi_step_with_warmup(t_warmup: Union[str, int],
                           milestones: Sequence[Union[str, int]],
                           gamma: float = 0.1,
                           max_duration: Union[str, int] = "1000000ba",
                           batches_per_epoch: int = 0,
                           scale_schedule_ratio: float = 1.0) -> Schedule:
    """Linear warmup then x gamma at each milestone (Composer
    MultiStepWithWarmupScheduler). Milestones scale by
    scale_schedule_ratio; warmup does not. Epoch milestones with no known
    batches_per_epoch are unreachable and skipped (the yamls' `200ep` on a
    550000ba run is a "never decay" sentinel)."""
    warmup = _resolve(t_warmup, max_duration, batches_per_epoch)
    steps = []
    for m in milestones:
        try:
            steps.append(_resolve(m, max_duration, batches_per_epoch,
                                  scale_schedule_ratio))
        except ValueError:
            logging.getLogger(__name__).warning(
                "scheduler milestone %r is epoch-denominated but "
                "batches_per_epoch is unknown; treating as unreachable", m)
    steps = sorted(steps)

    def schedule(step):
        s = np.asarray(step, np.float32)
        factor = 1.0
        for m in steps:
            factor = factor * np.where(s >= m, gamma, 1.0)
        return _warm(s, warmup) * factor

    return schedule


def linear_with_warmup(t_warmup: Union[str, int],
                       alpha_i: float = 1.0, alpha_f: float = 0.0,
                       t_max: Union[str, int] = "1dur",
                       max_duration: Union[str, int] = "1000000ba",
                       batches_per_epoch: int = 0,
                       scale_schedule_ratio: float = 1.0) -> Schedule:
    warmup = _resolve(t_warmup, max_duration, batches_per_epoch)
    total = _resolve(t_max, max_duration, batches_per_epoch, scale_schedule_ratio)

    def schedule(step):
        s = np.asarray(step, np.float32)
        frac = np.clip((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        return _warm(s, warmup) * (alpha_i + frac * (alpha_f - alpha_i))

    return schedule


def cosine_annealing_with_warmup(t_warmup: Union[str, int],
                                 alpha_f: float = 0.0,
                                 t_max: Union[str, int] = "1dur",
                                 max_duration: Union[str, int] = "1000000ba",
                                 batches_per_epoch: int = 0,
                                 scale_schedule_ratio: float = 1.0) -> Schedule:
    warmup = _resolve(t_warmup, max_duration, batches_per_epoch)
    total = _resolve(t_max, max_duration, batches_per_epoch, scale_schedule_ratio)

    def schedule(step):
        s = np.asarray(step, np.float32)
        frac = np.clip((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * (1 + np.cos(np.pi * frac))
        return _warm(s, warmup) * (alpha_f + (1 - alpha_f) * cos)

    return schedule


def constant_with_warmup(t_warmup: Union[str, int],
                         max_duration: Union[str, int] = "1000000ba",
                         batches_per_epoch: int = 0, **_) -> Schedule:
    warmup = _resolve(t_warmup, max_duration, batches_per_epoch)
    return lambda step: _warm(np.asarray(step, np.float32), warmup)


def constant_scheduler(**_) -> Schedule:
    return lambda step: 1.0
