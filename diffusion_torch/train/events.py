"""Trainer event enum + callback/algorithm protocol.

A copy of `diffusion_tpu/train/events.py` (Composer's event system as the
reference's algorithms and callbacks use it), which imports no jax: the
port imports nothing of the JAX package.
"""

from __future__ import annotations

from enum import Enum
from typing import Iterable, List

__all__ = ["Event", "Callback", "Algorithm", "EventEngine"]


class Event(Enum):
    INIT = "init"
    FIT_START = "fit_start"
    EPOCH_START = "epoch_start"
    BEFORE_DATALOADER = "before_dataloader"
    AFTER_DATALOADER = "after_dataloader"
    BATCH_START = "batch_start"
    BEFORE_TRAIN_BATCH = "before_train_batch"
    AFTER_TRAIN_BATCH = "after_train_batch"
    BATCH_END = "batch_end"
    BATCH_CHECKPOINT = "batch_checkpoint"
    EPOCH_END = "epoch_end"
    EPOCH_CHECKPOINT = "epoch_checkpoint"
    EVAL_START = "eval_start"
    EVAL_BATCH_START = "eval_batch_start"
    EVAL_BATCH_END = "eval_batch_end"
    EVAL_END = "eval_end"
    PREDICT_START = "predict_start"
    PREDICT_END = "predict_end"
    FIT_END = "fit_end"


class Callback:
    """Observes training; runs on every event (override what you need)."""

    def run_event(self, event: Event, state, logger) -> None:
        method = getattr(self, event.value, None)
        if method is not None:
            method(state, logger)

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, d: dict) -> None:
        pass


class Algorithm(Callback):
    """Modifies training (weights/optimizer/batches); declares which events it matches."""

    def match(self, event: Event, state) -> bool:
        return False

    def apply(self, event: Event, state, logger) -> None:
        raise NotImplementedError

    def run_event(self, event: Event, state, logger) -> None:
        if self.match(event, state):
            self.apply(event, state, logger)


class EventEngine:
    """Dispatches events to algorithms first, then callbacks (Composer ordering)."""

    def __init__(self, algorithms: Iterable[Algorithm] = (), callbacks: Iterable[Callback] = ()):
        self.algorithms: List[Algorithm] = list(algorithms)
        self.callbacks: List[Callback] = list(callbacks)

    def run(self, event: Event, state, logger) -> None:
        for alg in self.algorithms:
            alg.run_event(event, state, logger)
        for cb in self.callbacks:
            cb.run_event(event, state, logger)
