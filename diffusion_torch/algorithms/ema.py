"""EMA of the UNet's weights.

Counterpart of `diffusion_tpu/algorithms/ema.py`: half-life -> smoothing
2^(-interval / half_life), the `ema_start` delay (smoothing 0 before it, so
the EMA copies the weights until averaging begins), the update after every
optimizer step (smoothing 1 on steps off the update interval, and on a
skipped non-finite step), and `swap_in`/`swap_out` of the EMA weights with
the training weights. The trainer hands the EMA and the step's smoothing
to the optimizer's step, which updates it right after the weights, as the
JAX train step does (on the card in the same kernel pass); this object
owns the configuration, the swaps and the state flags.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from diffusion_torch.ops.adamw import ema_reference
from diffusion_torch.train.events import Algorithm, Event
from diffusion_torch.utils.time import Time, TimeUnit, time_to_batches

__all__ = ["EMA", "ema_smoothing_for_step", "apply_ema"]


def ema_smoothing_for_step(step: int, smoothing: float, ema_start: int,
                           update_interval: int) -> float:
    """Effective per-step smoothing: 0 before start (copy), `smoothing` on
    update steps, 1 otherwise (hold)."""
    if step < ema_start:
        return 0.0
    return smoothing if step % max(update_interval, 1) == 0 else 1.0


@torch.no_grad()
def apply_ema(ema_params: Dict[str, torch.Tensor],
              params: Dict[str, torch.Tensor], eff_smoothing: float) -> None:
    """In place: e = s * e + (1 - s) * p, all fp32 (the port's parameters
    and EMA copies are fp32), by two foreach passes. The Trainer hands the
    EMA to the optimizer's step instead (`AdamW.step(ema=, smoothing=)`),
    which computes the same after the update."""
    names = list(ema_params)
    ema_reference([ema_params[n] for n in names],
                  [params[n] for n in names], eff_smoothing)


class EMA(Algorithm):
    """Event-level EMA policy. Args as the JAX algorithm: `half_life` like
    '100ba' or an explicit `smoothing`; `update_interval` in batches;
    `ema_start` a time string."""

    def __init__(self, half_life: Optional[str] = "1000ba",
                 smoothing: Optional[float] = None,
                 update_interval: str = "1ba",
                 ema_start: str = "0.0dur"):
        self.half_life = half_life
        self.update_interval = Time.from_str(update_interval)
        if self.update_interval.unit != TimeUnit.BATCH:
            raise ValueError("update_interval must be batch-denominated")
        self._explicit_smoothing = smoothing
        self.ema_start = ema_start
        self.ema_weights_active = False
        self.ema_started = False

    def smoothing(self) -> float:
        if self._explicit_smoothing is not None:
            return float(self._explicit_smoothing)
        hl = Time.from_str(self.half_life)
        if hl.unit != TimeUnit.BATCH:
            raise ValueError("half_life must be batch-denominated")
        return float(2.0 ** (-self.update_interval.value / hl.value))

    def start_batch(self, max_duration, batches_per_epoch: int = 0) -> int:
        return time_to_batches(self.ema_start, max_duration, batches_per_epoch)

    def match(self, event: Event, state) -> bool:
        return event in (Event.EVAL_START, Event.EVAL_END, Event.BATCH_END)

    def apply(self, event: Event, state, logger) -> None:
        if event == Event.BATCH_END:
            if (not self.ema_started
                    and state.timestamp.batch >= state.ema_start_batch):
                self.ema_started = True
        elif event == Event.EVAL_START:
            self.swap_in(state)
        elif event == Event.EVAL_END:
            self.swap_out(state)

    @staticmethod
    @torch.no_grad()
    def _exchange(state) -> None:
        """Exchange the training weights' storage with the EMA weights' (no
        copy): the model then computes with what `ema_params` held. Shards
        of FSDP parameters (`TrainState.shards`) are views into storage
        FSDP keeps, so their values are exchanged by copies."""
        ts = state.train_state
        for name, p in ts.params.items():
            if ts.shards:
                tmp = p.clone()
                p.copy_(ts.ema_params[name])
                ts.ema_params[name].copy_(tmp)
            else:
                p.data, ts.ema_params[name] = ts.ema_params[name], p.data

    def swap_in(self, state) -> None:
        if self.ema_weights_active or state.train_state.ema_params is None:
            return
        self._exchange(state)
        self.ema_weights_active = True

    def swap_out(self, state) -> None:
        if not self.ema_weights_active:
            return
        self._exchange(state)
        self.ema_weights_active = False

    def state_dict(self) -> dict:
        return {"ema_weights_active": self.ema_weights_active,
                "ema_started": self.ema_started}

    def load_state_dict(self, d: dict) -> None:
        self.ema_weights_active = bool(d.get("ema_weights_active", False))
        self.ema_started = bool(d.get("ema_started", False))
