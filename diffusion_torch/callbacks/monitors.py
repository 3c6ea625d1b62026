"""Monitor callbacks: throughput, LR, device memory, ETA, optimizer stats.

Counterpart of `diffusion_tpu/callbacks/monitors.py`, with its metric
names: the composer callbacks the reference declares in yaml (reference:
yamls/hydra-yamls/SD-2-base-256-mixdata.yaml:96-107 — SpeedMonitor(
window_size=10), LRMonitor, MemoryMonitor, RuntimeEstimator,
OptimizerMonitor). What differs:

- the per-device throughput divides by the trainer's device count (the
  port trains on one card);
- MemoryMonitor reads `torch.cuda.memory_stats` and the card's total memory
  (nothing on the CPU);
- OptimizerMonitor takes its parameter norm from `train/optim.py`
  `global_norm`;
- SpeedMonitor logs MFU only with `flops_per_batch` and
  `peak_tflops_per_device` both given (there is no table of peaks).
"""

from __future__ import annotations

import collections
import gc
from typing import Deque, Optional, Tuple

import torch

from diffusion_torch.train.events import Callback
from diffusion_torch.train.optim import global_norm
from diffusion_torch.utils.time import time_to_batches

__all__ = ["SpeedMonitor", "LRMonitor", "MemoryMonitor", "RuntimeEstimator",
           "OptimizerMonitor", "ScheduledGarbageCollector"]

# the port's Trainer drives one device
_DEVICE_COUNT = 1


class SpeedMonitor(Callback):
    """samples/sec over a rolling window (+ per-device), logged per batch.

    With `flops_per_batch` it also logs `throughput/flops_per_sec`, and with
    `peak_tflops_per_device` as well `throughput/device/mfu`
    (composer.callbacks.speed_monitor parity)."""

    def __init__(self, window_size: int = 10,
                 flops_per_batch: Optional[float] = None,
                 peak_tflops_per_device: Optional[float] = None):
        self.window: Deque[Tuple[float, int]] = collections.deque(maxlen=window_size)
        # float() so yaml/CLI strings like "1.1e8" work
        self.flops_per_batch = (float(flops_per_batch)
                                if flops_per_batch else None)
        self._peak = (float(peak_tflops_per_device) * 1e12
                      if peak_tflops_per_device else None)

    def batch_end(self, state, logger):
        self.window.append((state.batch_wct, state.timestamp.sample))
        if len(self.window) < 2:
            return
        # samples and wall-clock accumulated across the window, excluding the
        # first entry's wct (it delimits the window start)
        samples = self.window[-1][1] - self.window[0][1]
        wct = sum(w for w, _ in list(self.window)[1:])
        if wct <= 0 or samples <= 0:
            return
        sps = samples / wct
        metrics = {
            "throughput/samples_per_sec": sps,
            "throughput/device/samples_per_sec": sps / _DEVICE_COUNT,
            "throughput/batches_per_sec": (len(self.window) - 1) / wct,
            "wall_clock/train": state.total_wct,
        }
        if self.flops_per_batch:
            fps = self.flops_per_batch * metrics["throughput/batches_per_sec"]
            metrics["throughput/flops_per_sec"] = fps
            if self._peak:
                metrics["throughput/device/mfu"] = (
                    fps / _DEVICE_COUNT / self._peak)
        logger.log_metrics(metrics, step=state.timestamp.batch)


class LRMonitor(Callback):
    def batch_end(self, state, logger):
        if state.lr is not None:
            logger.log_metrics({"lr-AdamW/group0": state.lr},
                               step=state.timestamp.batch)


class MemoryMonitor(Callback):
    """Logs the CUDA caching allocator's bytes in use and peak, and the
    card's total memory, for the card the model lies on."""

    def batch_end(self, state, logger):
        device = state.model.device
        if device.type != "cuda":
            return
        stats = torch.cuda.memory_stats(device)
        metrics = {
            "memory/allocated_bytes": float(stats["allocated_bytes.all.current"]),
            "memory/peak_bytes": float(stats["allocated_bytes.all.peak"]),
            "memory/limit_bytes": float(
                torch.cuda.get_device_properties(device).total_memory),
        }
        logger.log_metrics(metrics, step=state.timestamp.batch)


class RuntimeEstimator(Callback):
    """ETA from rolling throughput vs remaining batches."""

    def __init__(self, window_size: int = 20):
        self.window: Deque[float] = collections.deque(maxlen=window_size)
        self._max_batches: Optional[int] = None

    def fit_start(self, state, logger):
        # the Trainer already computed max_batches (with scale_schedule_ratio
        # and real batches_per_epoch for 'ep'/'dur' durations)
        self._max_batches = getattr(state, "max_batches", None)
        if self._max_batches is None:
            try:
                self._max_batches = time_to_batches(state.max_duration,
                                                    state.max_duration)
            except ValueError:
                self._max_batches = None

    def batch_end(self, state, logger):
        if state.batch_wct > 0:  # 0 marks the warm-up's first batch
            self.window.append(state.batch_wct)
        if not self._max_batches or len(self.window) < 2:
            return
        per_batch = sum(self.window) / len(self.window)
        remaining = max(self._max_batches - state.timestamp.batch, 0)
        logger.log_metrics({"time/remaining_estimate_sec": per_batch * remaining},
                           step=state.timestamp.batch)


class OptimizerMonitor(Callback):
    """Gradient/parameter norms every `interval` batches: the train step's
    `grad/global_norm` and the parameters' global norm."""

    def __init__(self, log_optimizer_metrics: bool = True, interval: int = 10):
        self.log_optimizer_metrics = log_optimizer_metrics
        self.interval = max(interval, 1)

    def batch_end(self, state, logger):
        b = state.timestamp.batch
        if b % self.interval:
            return
        metrics = {}
        m = getattr(state, "metrics", None)
        if m and "grad/global_norm" in m:
            metrics["l2_norm/grad/global"] = float(m["grad/global_norm"])
        if self.log_optimizer_metrics:
            with torch.no_grad():
                metrics["l2_norm/param/global"] = float(global_norm(
                    list(state.train_state.params.values())))
        if metrics:
            logger.log_metrics(metrics, step=b)


class ScheduledGarbageCollector(Callback):
    """Deterministic host GC (reference callbacks/scheduled_garbage_collector
    .py:37-67): the Python-GC scheduling part, which keeps host-side pause
    times out of the input pipeline's critical path."""

    def __init__(self, batch_interval: int = 10000, gen_1_batch_interval: Optional[int] = None):
        self.batch_interval = int(batch_interval)
        self.gen_1_batch_interval = gen_1_batch_interval
        self._was_enabled = True
        self._active = False   # between fit_start and fit_end

    def fit_start(self, state, logger):
        self._was_enabled = gc.isenabled()
        self._active = True
        gc.disable()

    def fit_end(self, state, logger):
        self._active = False
        if self._was_enabled:
            gc.enable()
        gc.collect()

    def before_dataloader(self, state, logger):
        b = state.timestamp.batch
        if self.gen_1_batch_interval and b % self.gen_1_batch_interval == 0:
            gc.collect(1)
        if self.batch_interval and b % self.batch_interval == 0:
            gc.collect()

    def eval_start(self, state, logger):
        gc.collect()
        if self._active:          # mid-fit eval: GC on while evaluating
            gc.enable()

    def eval_end(self, state, logger):
        # only re-disable what fit_start disabled
        if self._active:
            gc.disable()
