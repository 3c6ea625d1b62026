#!/usr/bin/env python
"""Host cost of the program's tracing (`diffusion_torch/utils/profiler.py`
spans, `LaunchCounter.launched`), in ns, on this machine's CPU.

    python tools/span_cost.py [--n 1000000]

Prints one JSON line, each figure the best of 3 passes:

- `step_span_ns`: a span as the Trainer opens them, over `--n` spans in
  steps of 8 (a `step` span holding 7), kept in the process-wide buffer's
  bound: the root's record and the counters' reads shared out;
- `child_span_ns`: a span inside an open step; `root_span_ns`: a step's
  first span alone (it also makes the record and sums the counters twice);
- `step_span_profiled_ns`: the first figure while a CPU torch.profiler
  runs (each span then opens its `record_function` range);
- `add_ns`, `launched_ns`: a launch counted by `add()`, and by
  `launched()` with the wrapper's entry clock read;
- for scale: `loop_ns`, an empty loop's pass; `clock_ns`, one
  `time.perf_counter_ns()`; `floor_ns`, a bare context manager that reads
  the clock twice and appends itself to a list.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from diffusion_torch.ops._build import LaunchCounter  # noqa: E402
from diffusion_torch.utils.profiler import recorder, span  # noqa: E402

_CHILDREN = ("data", "forward", "backward", "forward", "backward", "update",
             "ema")


class _Floor:
    __slots__ = ("name", "start_ns", "end_ns")
    kept: list = []

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.kept.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()


def _best(fn, n: int) -> float:
    times = []
    for _ in range(3):
        t0 = time.perf_counter_ns()
        fn(n)
        times.append((time.perf_counter_ns() - t0) / n)
    return min(times)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    n = ap.parse_args(argv).n
    rec = recorder

    def loop(k):
        for _ in range(k):
            pass

    def clocks(k):
        for _ in range(k):
            time.perf_counter_ns()

    def floors(k):
        for _ in range(k // 1000):
            for _ in range(1000):
                with _Floor("forward"):
                    pass
            _Floor.kept.clear()

    def steps(k):
        for i in range(k // 8):
            with span("step", step=i):
                for name in _CHILDREN:
                    with span(name):
                        pass

    def children(k):
        for _ in range(k // 1000):
            with span("step", step=0):
                for _ in range(1000):
                    with span("forward"):
                        pass
            rec.clear()

    def roots(k):
        for i in range(k):
            with span("step", step=i):
                pass

    counter = LaunchCounter()

    def adds(k):
        for _ in range(k):
            counter.add()

    def launches(k):
        for _ in range(k):
            counter.launched(time.perf_counter_ns())

    out = {"n": n, "loop_ns": _best(loop, n), "clock_ns": _best(clocks, n),
           "floor_ns": _best(floors, n),
           "step_span_ns": _best(steps, n),
           "child_span_ns": _best(children, n),
           "root_span_ns": _best(roots, n // 8),
           "add_ns": _best(adds, n), "launched_ns": _best(launches, n)}
    rec.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out["step_span_profiled_ns"] = _best(steps, n // 100)
    print(json.dumps({k: round(v, 1) if isinstance(v, float) else v
                      for k, v in out.items()}))


if __name__ == "__main__":
    main()
