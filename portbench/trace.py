"""Reading a torch.profiler trace of the traced window.

Device activity is every CUDA event (kernels, copies, memsets) inside the
window's range, which is bracketed by synchronizations. Busy time is the
union of their intervals; the idle share is 1 - busy / the window's wall
time, so idle time before the first kernel and after the last counts. The
categories are chip_smoke.py's (`_CATEGORIES`), copied.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

__all__ = ["WINDOW", "Trace", "read_trace", "CATEGORIES", "category"]

WINDOW = "portbench_window"

CATEGORIES = (   # kernel-name patterns, first match wins
    ("GroupNorm kernels", ("gn_fwd", "gn_bwd", "gn_partial", "gn_merge",
                           "gn_apply")),
    ("flash kernels", ("flash_",)),
    ("optimizer/EMA foreach", ("multi_tensor_apply", "foreach")),
    ("cuDNN convs", ("conv", "cudnn", "implicit", "dgrad", "wgrad",
                     "winograd", "xmma_fprop", "nhwc")),
    ("cuBLAS GEMMs", ("gemm", "cutlass", "xmma", "sm90_", "cublas",
                      "nvjet")),
    ("copies and casts", ("copy", "cat", "Copy")),
    ("reductions", ("reduce", "Reduce", "norm")),
)


_SCAN = 200            # host ops looked at, back from a gap, for its name


def _short(name: str) -> str:
    """A kernel's name without `void ` and cut to 160 characters (the
    templates' argument lists add nothing after the functor)."""
    return (name[5:] if name.startswith("void ") else name)[:160]


def category(name: str) -> str:
    return next((c for c, pats in CATEGORIES if any(p in name for p in pats)),
                "other elementwise")


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    ops: List[Tuple[float, float, str]]        # (start s, end s, name)
    gaps: List[Tuple[float, str]]              # (idle s, host op)

    def device_s(self, patterns) -> float:
        """Summed device time of the ops whose name holds a pattern."""
        return sum(e - s for s, e, n in self.ops
                   if any(p in n for p in patterns))

    def count(self, pattern: str) -> int:
        return sum(pattern in n for _, _, n in self.ops)

    def by_category(self) -> Dict[str, float]:
        out: Dict[str, float] = collections.defaultdict(float)
        for s, e, n in self.ops:
            out[category(n)] += e - s
        return dict(out)

    def breakdown(self) -> dict:
        by_name: Dict[str, float] = collections.defaultdict(float)
        for s, e, n in self.ops:
            by_name[n] += e - s
        idle: Dict[str, float] = collections.defaultdict(float)
        for seconds, host in self.gaps:
            idle[host] += seconds
        top = lambda d: [[k, v] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(by_name), "idle_gaps": top(idle)}


def read_trace(prof) -> Optional[Trace]:
    """The window's device activity, or None where the profiler recorded
    no range or no device event in it."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    windows = [e.time_range for e in events if e.name == WINDOW
               and e.device_type != cuda]
    if not windows:
        return None
    lo, hi = windows[0].start, windows[0].end
    ops, host = [], []
    for e in events:
        r = e.time_range
        if r.start < lo or r.end > hi:
            continue
        if e.device_type == cuda:
            if not getattr(e, "is_user_annotation", False) \
                    and not e.name.startswith("portbench_"):
                ops.append((r.start, r.end, _short(e.name)))
        elif e.name != WINDOW:
            host.append((r.start, r.end, e.name))
    if not ops:
        return None
    ops.sort()
    busy, cur_s, cur_e, idle = 0.0, None, None, []
    prev_end = lo
    for s0, s1, _ in ops:
        if cur_e is None or s0 > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            if s0 > prev_end:
                idle.append((prev_end, s0))
            cur_s, cur_e = s0, s1
        else:
            cur_e = max(cur_e, s1)
        prev_end = max(prev_end, cur_e)
    busy += cur_e - cur_s
    if hi > prev_end:
        idle.append((prev_end, hi))
    host.sort()
    starts = [h[0] for h in host]
    gaps = [((b - a) / 1e6, _host_at(host, starts, (a + b) / 2))
            for a, b in idle]
    return Trace(window_s=(hi - lo) / 1e6, busy_s=busy / 1e6,
                 ops=[(s / 1e6, e / 1e6, n) for s, e, n in ops], gaps=gaps)


def _host_at(host: List[tuple], starts: List[float], t: float) -> str:
    """The innermost host op running at time t: of those that span it, the
    latest to start (the CUDA runtime's own calls left out); "(no host
    op)" where none of the last `_SCAN` to start spans it (Python between
    ops)."""
    i = bisect.bisect_right(starts, t)
    for i in range(i - 1, max(i - _SCAN, 0) - 1, -1):
        s, e, n = host[i]
        if e >= t and not n.startswith("cuda"):
            return n
    return "(no host op)"
