"""`data.worker_share` on synthetic step records: the share of the
window's decoded samples that the wds reader's loader workers decoded,
read from the growth of the program's two counters in each step."""

import types

import pytest

from diffusion_torch.data import datapipes
from diffusion_torch.utils import profiler
from portbench import common


@pytest.fixture
def rec(monkeypatch):
    rec = profiler.SpanRecorder()
    monkeypatch.setattr(profiler, "recorder", rec)
    return rec


def _run(steps):
    return types.SimpleNamespace(traffic={"checked_steps": 3},
                                 window={"steps": steps})


def _steps(rec, workers, inline, n=4):
    """Steps 3.. of the window and its last, each counting `workers` and
    `inline` decoded samples inside its `data` span."""
    for i in range(n + 1):
        with rec.span("step", step=3 + i):
            with rec.span("data"):
                datapipes.decoded_in_workers.add(workers)
                datapipes.decoded_inline.add(inline)


def test_all_in_workers(rec):
    _steps(rec, 32, 0)
    assert common._reader("data.worker_share")(_run(5)) == 100.0


def test_all_inline(rec):
    _steps(rec, 0, 32)
    assert common._reader("data.worker_share")(_run(5)) == 0.0


def test_a_share_over_the_window_but_its_last_step(rec):
    _steps(rec, 24, 8, n=2)
    # the last step, left out, decoded only inline
    with rec.span("step", step=6):
        datapipes.decoded_inline.add(32)
    assert common._reader("data.worker_share")(_run(4)) == 75.0


def test_silent_without_the_counters_or_a_decode(rec, monkeypatch):
    _steps(rec, 0, 0)
    assert common._reader("data.worker_share")(_run(5)) is None
    assert common._reader("data.worker_share")(_run(0)) is None
    _steps(rec, 32, 0)
    monkeypatch.delattr(datapipes, "decoded_in_workers")
    assert common._reader("data.worker_share")(_run(5)) is None
