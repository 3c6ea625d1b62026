"""Profiler callback: a torch.profiler trace around selected batches.

Counterpart of `diffusion_tpu/utils/profiler.py` (`JaxProfiler`, the
Trainer's `log_traces` flag): one trace of `num_batches` batches from
batch `start_batch` on, once. It records the host's operators and, where
the model lies on a CUDA device, the card's kernels (CUPTI), and writes a
Chrome trace (chrome://tracing, Perfetto) into `trace_dir`, named by the
batches it covers. When the trace ends it logs `profiler/trace_dir`;
`fit_end` stops (and writes) a trace that is still running.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from diffusion_torch.train.events import Callback

__all__ = ["TorchProfiler"]


class TorchProfiler(Callback):
    def __init__(self, trace_dir: str = "traces", start_batch: int = 10,
                 num_batches: int = 3):
        self.trace_dir = trace_dir
        self.start_batch = int(start_batch)
        self.num_batches = int(num_batches)
        self.trace_path: Optional[str] = None
        self._prof = None
        self._cuda = False
        self._done = False

    def batch_start(self, state, logger):
        if self._done or self._prof is not None:
            return
        if state.timestamp.batch == self.start_batch:
            os.makedirs(self.trace_dir, exist_ok=True)
            self._cuda = state.model.device.type == "cuda"
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self._cuda:
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()

    def _stop(self, last_batch: int) -> None:
        if self._cuda:
            torch.cuda.synchronize()
        self._prof.stop()
        self.trace_path = os.path.join(
            self.trace_dir,
            f"trace_ba{self.start_batch}-{last_batch}.pt.trace.json")
        self._prof.export_chrome_trace(self.trace_path)
        self._prof = None
        self._done = True

    def batch_end(self, state, logger):
        if self._prof is None:
            return
        batch = state.timestamp.batch
        if batch >= self.start_batch + self.num_batches:
            self._stop(batch)
            logger.log_metrics({"profiler/trace_dir": self.trace_dir},
                               step=batch)

    def fit_end(self, state, logger):
        if self._prof is not None:
            self._stop(state.timestamp.batch)
