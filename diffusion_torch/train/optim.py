"""AdamW and LR schedules, as the JAX package's optax chain computes them.

Counterpart of `diffusion_tpu/train/optim.py`. `adamw` is the same spec
dict; `build_optimizer` returns an `AdamW` over the given parameters that
performs optax's `chain(clip_by_global_norm(c), adamw(lr=schedule))` update
step for step:

- clipping, where ||g|| >= c, takes the gradients to g / ||g|| * c
  (optax's `clip_by_global_norm`, not `clip_grad_norm_`'s
  c / (||g|| + 1e-6));
- the moments are ``mu = (1 - b1) g + b1 mu`` and ``nu = (1 - b2) g^2 +
  b2 nu``, bias-corrected by 1 - b^count computed in fp32, and the update
  is ``-lr * (mu_hat / (sqrt(nu_hat) + eps) + weight_decay * p)`` (eps
  outside the square root; decoupled weight decay on every parameter);
- every product is rounded on its own, in optax's order: no fused
  multiply-add (torch's ``add(alpha=)`` and ``addcmul`` fuse on the CPU,
  XLA's CPU code does not), so the update is optax's bit for bit where
  the gradients are;
- the learning rate is ``lr * schedule(count)`` in fp32 at optax's own
  update count, which starts at 0 and advances only when an update is
  applied (a skipped non-finite step leaves it where it was);
- ``mu_dtype="bfloat16"`` keeps the first moment in bf16, computing in
  fp32 and casting after the update, as optax does;
- on CUDA tensors one kernel pass over every parameter computes the same
  update, and the EMA of the weights where the step is handed one
  (`ops/adamw.py`); on CPU tensors the plain version's foreach passes do.

The schedules are the JAX module's numpy versions, copied (they import no
jax); 'Time' strings resolve against `max_duration`/`batches_per_epoch`.
"""

from __future__ import annotations

import logging
from typing import Callable, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch

from diffusion_torch.ops.adamw import (adamw_cuda, adamw_reference,
                                       ema_reference)
from diffusion_torch.utils.device import kernel_device_type
from diffusion_torch.utils.profiler import span
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


def global_norm(tensors: Sequence[torch.Tensor],
                group: Optional[object] = None,
                tp_sliced: Optional[Sequence[bool]] = None,
                tp_group: Optional[object] = None) -> torch.Tensor:
    """sqrt(sum of squares) over every element, fp32 (optax.global_norm).
    With a process `group`, the tensors are this rank's shards and the
    squares are summed over the group's ranks. With `tp_group`, the
    tensors marked in `tp_sliced` are tensor-parallel slices, whose squares
    are summed over the tp group's ranks too; the others are the same on
    every rank of it and count once."""
    import torch.distributed as dist
    squares = torch.stack(torch._foreach_norm(
        [t.float() for t in tensors])).square()
    sliced = (torch.zeros_like(squares, dtype=torch.bool) if tp_sliced is None
              else torch.tensor(list(tp_sliced), device=squares.device))
    zero = squares.new_zeros(())
    # (the whole tensors' squares, the tp slices')
    parts = torch.stack([torch.where(sliced, zero, squares).sum(),
                         torch.where(sliced, squares, zero).sum()])
    if group is not None:
        dist.all_reduce(parts, group=group)
    if tp_group is not None:
        dist.all_reduce(parts[1:], group=tp_group)
    return torch.sqrt(parts.sum())


class AdamW:
    """optax's clip + adamw chain over a list of fp32 parameters, reading
    their `.grad` (or the gradients `step` is given: a process mesh's
    trainer hands the local shards of the parameters and their gradients,
    and their global norm). `count` is optax's update count."""

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

    def state_dict(self) -> dict:
        """`count` and the moments `mu` (in their own dtype) and `nu`, in
        the order of `params`. The tensors are the live ones, not copies."""
        return {"count": self.count, "mu": list(self.mu), "nu": list(self.nu)}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a `state_dict()` into the moments in place; each moment
        keeps its dtype and device."""
        for key in ("mu", "nu"):
            own, got = getattr(self, key), state[key]
            if len(got) != len(own):
                raise ValueError(f"{key}: {len(got)} tensors for "
                                 f"{len(own)} parameters")
            for i, (o, g) in enumerate(zip(own, got)):
                if tuple(o.shape) != tuple(g.shape):
                    raise ValueError(f"{key}[{i}]: shape {tuple(g.shape)} "
                                     f"for a parameter of {tuple(o.shape)}")
            for o, g in zip(own, got):
                o.copy_(g)
        self.count = int(state["count"])

    def lr_at(self, count: int) -> float:
        """The learning rate an update at optax count `count` uses: the
        fp32 product of the base rate and the schedule's factor."""
        if self.schedule is None:
            return float(np.float32(self.lr))
        return float(np.float32(self.lr) * np.float32(self.schedule(count)))

    @torch.no_grad()
    def step(self, grad_norm: Optional[torch.Tensor] = None,
             grads: Optional[List[torch.Tensor]] = None,
             ema: Optional[List[torch.Tensor]] = None,
             smoothing: float = 1.0) -> None:
        """One update from the parameters' `.grad`, or `grads` in their
        order (left as they are); `grad_norm` is their global norm when the
        caller has it already. With `ema` (a tensor for each parameter, in
        their order), the EMA e = s e + (1 - s) p of the updated parameters
        follows at `smoothing` s (none at s = 1). Moments, parameters and
        EMA update in place: on CUDA tensors by one kernel pass
        (`ops/adamw.py::adamw_cuda`, in a `fused_update` span), on CPU
        tensors by the plain version (the EMA in an `ema` span)."""
        if grads is None:
            grads = [p.grad for p in self.params]
        if ema is not None and len(ema) != len(self.params):
            raise ValueError(f"{len(ema)} EMA tensors for "
                             f"{len(self.params)} parameters")
        clip = self.grad_clip_norm or None
        if clip and grad_norm is None:
            grad_norm = global_norm(grads)
        lr = self.lr_at(self.count)
        self.count += 1
        kw = dict(lr=lr, b1=self.b1, b2=self.b2, eps=self.eps,
                  weight_decay=self.weight_decay,
                  bc1=_bias_correction(self.b1, self.count),
                  bc2=_bias_correction(self.b2, self.count),
                  grad_norm=grad_norm, clip=clip)
        kind = kernel_device_type(self.params[0].device)
        if kind == "cuda":
            with span("fused_update"):
                adamw_cuda(self.params, grads, self.mu, self.nu, ema,
                           smoothing=smoothing, **kw)
        elif kind == "cpu":
            adamw_reference(self.params, grads, self.mu, self.nu, **kw)
            if ema is not None:
                with span("ema"):
                    ema_reference(ema, self.params, smoothing)
        else:
            raise ValueError(f"AdamW runs on CUDA or CPU tensors, not "
                             f"{self.params[0].device}")


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay ** count in fp32, as optax computes it."""
    return float(np.float32(1.0) - np.power(np.float32(decay),
                                            np.float32(count)))


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
