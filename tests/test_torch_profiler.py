"""The Trainer's `log_traces`: a `TorchProfiler` callback (the JAX
Trainer's `JaxProfiler` counterpart) with its defaults, and a CPU run that
writes a Chrome trace of exactly the batches from `start_batch` to
`start_batch + num_batches`, once, logging `profiler/trace_dir`; a trace
still running when the fit ends is stopped and written by `fit_end`."""

import json
import os

import numpy as np
import torch

from diffusion_torch.models.models import stable_diffusion_tiny
from diffusion_torch.train.events import Callback
from diffusion_torch.train.trainer import Trainer
from diffusion_torch.utils.logging import Logger
from diffusion_torch.utils.profiler import TorchProfiler

torch.set_num_threads(1)


def _batches(n):
    rng = np.random.default_rng(0)
    return [{"image_latents": rng.standard_normal((2, 8, 8, 4)).astype(
                np.float32),
             "caption_latents": rng.standard_normal((2, 8, 32)).astype(
                 np.float32)} for _ in range(n)]


class _Marker(Callback):
    """A named, empty host range at every batch's start: the trace holds
    the markers of the batches it covers."""

    def batch_start(self, state, logger):
        with torch.profiler.record_function(
                f"chip_marker_batch_{state.timestamp.batch}"):
            pass


class _Metrics(Logger):
    def __init__(self):
        self.records = []

    def log_metrics(self, metrics, step=None):
        self.records.append((step, dict(metrics)))


def _markers(path):
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return sorted(int(e["name"].rsplit("_", 1)[1]) for e in events
                  if str(e.get("name", "")).startswith("chip_marker_batch_"))


def _trainer(n, callbacks, loggers=None, **kw):
    return Trainer(model=stable_diffusion_tiny(device="cpu",
                                               precomputed_latents=True),
                   train_dataloader=_batches(n), callbacks=callbacks,
                   loggers=loggers, max_duration=f"{n}ba", device="cpu",
                   **kw)


def test_log_traces_appends_the_profiler():
    tr = _trainer(1, [], log_traces=True)
    profs = [c for c in tr.engine.callbacks if isinstance(c, TorchProfiler)]
    assert len(profs) == 1
    assert (profs[0].trace_dir, profs[0].start_batch,
            profs[0].num_batches) == ("traces", 10, 3)
    assert not any(isinstance(c, TorchProfiler)
                   for c in _trainer(1, []).engine.callbacks)


def test_trace_covers_its_batches(tmp_path):
    prof = TorchProfiler(trace_dir=str(tmp_path / "traces"), start_batch=1,
                         num_batches=2)
    metrics = _Metrics()
    tr = _trainer(5, [prof, _Marker()], loggers=[metrics])
    tr.fit()
    assert prof.trace_path == str(tmp_path / "traces" /
                                  "trace_ba1-3.pt.trace.json")
    assert os.listdir(tmp_path / "traces") == ["trace_ba1-3.pt.trace.json"]
    assert _markers(prof.trace_path) == [1, 2]
    logged = [(s, m["profiler/trace_dir"]) for s, m in metrics.records
              if "profiler/trace_dir" in m]
    assert logged == [(3, str(tmp_path / "traces"))]
    with open(prof.trace_path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    # the host's operators of the traced steps (no CUDA activity here)
    assert any(str(n).startswith("aten::") for n in names)


def test_fit_end_stops_a_running_trace(tmp_path):
    prof = TorchProfiler(trace_dir=str(tmp_path), start_batch=1,
                         num_batches=5)
    tr = _trainer(3, [prof, _Marker()])
    tr.fit()
    assert prof.trace_path == str(tmp_path / "trace_ba1-3.pt.trace.json")
    assert _markers(prof.trace_path) == [1, 2]
    # once: a second fit over more batches starts no second trace
    tr.max_batches = 5
    tr.train_dataloader = _batches(2)
    tr.fit()
    assert os.listdir(tmp_path) == ["trace_ba1-3.pt.trace.json"]
