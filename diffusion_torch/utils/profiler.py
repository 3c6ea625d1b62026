"""The program's tracing: a torch.profiler callback, and spans.

`TorchProfiler` is the counterpart of `diffusion_tpu/utils/profiler.py`
(`JaxProfiler`, the Trainer's `log_traces` flag): one trace of
`num_batches` batches from batch `start_batch` on, once. It records the
host's operators and, where the model lies on a CUDA device, the card's
kernels (CUPTI), and writes a Chrome trace (chrome://tracing, Perfetto)
into `trace_dir`, named by the batches it covers. When the trace ends it
logs `profiler/trace_dir`; `fit_end` stops (and writes) a trace that is
still running.

`span(name)` times a part of the program on the host's clock into the
process-wide `recorder`, always: two `time.perf_counter_ns()` reads and a
list append, no device work. Spans nest per thread; a span opened where
none is open starts a record (`StepRecord`), which holds it and every span
opened inside it, and which the recorder keeps once the span closes: the
last `MAX_STEPS`, in memory only. The Trainer opens one `step` span a
batch, keyed by its step index, with `data`, `forward` and `backward` (one
a microbatch), `update` and inside it `fused_update` (the optimizer's
kernel pass, EMA included, on the card) or `ema` (the plain EMA pass on
the CPU); on a raw batch, `forward`
holds `StableDiffusion.forward`'s `encode` (the VAE and CLIP towers' encode).
A record also holds how far
the kernel wrappers' host time (`LaunchCounter.total_host_ns`) grew while
it was open. While a torch.profiler is running, and only then, a span also
opens a `record_function` range named `diffusion_torch.<name>`, so the
trace shows it on the profiler's clock around the operators it issued.

`step_graph` counts, for the process, how the training step's CUDA graph
(`train/step_graph.py`) engaged: its `captures`, its `replays`, and the
steps that ran eagerly by reason. A replayed step has a `replay` span in
place of the `backward` spans; its `forward` spans hold the draws and their
copy into the graph's inputs.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Deque, List, Optional

import torch

from diffusion_torch.ops._build import LaunchCounter
from diffusion_torch.train.events import Callback

__all__ = ["TorchProfiler", "Span", "StepRecord", "SpanRecorder", "recorder",
           "span", "MAX_STEPS", "RANGE_PREFIX", "StepGraphCounts",
           "step_graph"]

MAX_STEPS = 4096          # records kept: an 850,000-step run holds no more
RANGE_PREFIX = "diffusion_torch."

_clock = time.perf_counter_ns
_autograd_profiler = torch.autograd.profiler


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


class Span:
    """One timed interval of the host: `name`, `start_ns` and `end_ns`
    (`time.perf_counter_ns()`), and, once its record's spans are read
    (`StepRecord.spans`), the enclosing `parent` span (None for a record's
    first), the `step` and the `micro`batch index (each the parent's where
    not given). A context manager, made by a recorder's `span`; its
    opening and closing are kept to the least work, since the Trainer opens
    several a step."""

    __slots__ = ("name", "step", "micro", "parent", "start_ns", "end_ns",
                 "_range")
    _open: "_Open"                 # set on each recorder's subclass
    _recorder: "SpanRecorder"

    def __init__(self, name: str, step: Optional[int] = None,
                 micro: Optional[int] = None):
        self.name = name
        self.step = step
        self.micro = micro

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns

    def __enter__(self) -> "Span":
        opened = self._open
        spans = opened.spans
        if spans is None:
            opened.spans = [self]
            opened.wrapper_ns = LaunchCounter.total_host_ns()
        else:
            spans.append(self)
        # the Python-side flag torch keeps for such checks, set while any
        # torch.profiler (or autograd profiler) runs
        if _autograd_profiler._is_profiler_enabled:
            self._range = _autograd_profiler.record_function(
                RANGE_PREFIX + self.name)
            self._range.__enter__()
        else:
            self._range = None
        self.start_ns = _clock()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = _clock()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        opened = self._open
        spans = opened.spans
        if spans[0] is self:
            opened.spans = None
            self._recorder._keep(StepRecord(
                self.step, spans,
                LaunchCounter.total_host_ns() - opened.wrapper_ns))


class StepRecord:
    """The spans of one step (or of one span opened outside any step), in
    the order they opened, and `wrapper_host_ns`: how far the kernel
    wrappers' summed host time grew while its first span was open."""

    __slots__ = ("step", "_spans", "wrapper_host_ns", "_linked")

    def __init__(self, step: Optional[int], spans: List[Span],
                 wrapper_host_ns: int):
        self.step = step
        self._spans = spans
        self.wrapper_host_ns = wrapper_host_ns
        self._linked = False

    @property
    def spans(self) -> List[Span]:
        """The spans, each with its `parent`, `step` and `micro` filled
        in: spans of one thread nest, so a span's parent is the latest
        opened before it that had not closed when it opened (a tie, as a
        hand-set clock gives, counts as closed)."""
        if not self._linked:
            open_: List[Span] = []
            for s in self._spans:
                while open_ and open_[-1].end_ns <= s.start_ns:
                    open_.pop()
                parent = s.parent = open_[-1] if open_ else None
                if parent is not None:
                    if s.step is None:
                        s.step = parent.step
                    if s.micro is None:
                        s.micro = parent.micro
                open_.append(s)
            self._linked = True
        return self._spans

    @property
    def root(self) -> Span:
        return self.spans[0]

    def total_ns(self, name: str) -> int:
        """Summed duration of the spans called `name`."""
        return sum(s.end_ns - s.start_ns for s in self._spans
                   if s.name == name)

    def self_ns(self, span: Span) -> int:
        """`span`'s duration less the part its child spans cover (children
        of one span follow each other on one thread)."""
        return span.duration_ns - sum(s.duration_ns for s in self.spans
                                      if s.parent is span)


class _Open(threading.local):
    """This thread's open record: its spans (None where no span is open)
    and the wrappers' host time when it opened."""

    def __init__(self) -> None:
        self.spans: Optional[List[Span]] = None
        self.wrapper_ns = 0


class SpanRecorder:
    """The spans of the last `max_steps` records, in memory. `span(name,
    step=None, micro=None)` makes a span of this recorder."""

    def __init__(self, max_steps: int = MAX_STEPS):
        self._records: Deque[StepRecord] = collections.deque(
            maxlen=max_steps)
        self._lock = threading.Lock()
        # a class of its own: a span is made by one call, with no
        # reference to pass
        self.span = type("Span", (Span,), {
            "__slots__": (), "_open": _Open(), "_recorder": self})

    def _keep(self, record: StepRecord) -> None:
        with self._lock:
            self._records.append(record)

    def steps(self, first: Optional[int] = None,
              stop: Optional[int] = None) -> List[StepRecord]:
        """The closed records, oldest first; with `first`/`stop`, those
        whose step lies in [first, stop)."""
        with self._lock:
            records = list(self._records)
        if first is None and stop is None:
            return records
        return [r for r in records if r.step is not None
                and (first is None or r.step >= first)
                and (stop is None or r.step < stop)]

    def clear(self) -> None:
        with self._lock:
            self._records.clear()


recorder = SpanRecorder()
# ``with span("forward", micro=i): ...``: a span in the process-wide recorder
span = recorder.span


class StepGraphCounts:
    """How often the training step's CUDA graph engaged: `captures`,
    `replays` (the one after a capture included) and `eager`, the steps
    that ran without it, by reason (`device`, `sharded`, `dropout`,
    `raw_batch`, `shape`, `storage`, `warmup`)."""

    def __init__(self) -> None:
        self.captures = 0
        self.replays = 0
        self.eager: "collections.Counter[str]" = collections.Counter()


# the process's counts: `step_graph.replays`, `step_graph.eager["shape"]`
step_graph = StepGraphCounts()
