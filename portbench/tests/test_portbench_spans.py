"""The readers of the program's spans (`trainer.*_host_ms`,
`kernels.wrapper_host_ms`): their means over a hand-timed recorder, the
window's last step left out, None with no records or with a program that
records no spans, and the five read from a whole run of a training cell on
the CPU."""

import time

import pytest
import torch

from diffusion_torch.utils import profiler
from portbench import common
from portbench.kinds import train
from portbench.tests.tiny import tiny_files

READERS = ("trainer.forward_host_ms", "trainer.backward_host_ms",
           "trainer.update_host_ms", "trainer.loop_host_ms",
           "kernels.wrapper_host_ms")


def _run(steps, checked=3):
    return common.Run(cell={"name": "sd2-512-train"}, config={},
                      traffic={"checked_steps": checked},
                      window={"steps": steps})


@pytest.fixture
def clocked(monkeypatch):
    """A recorder of its own on a clock that moves only by hand (ms)."""
    now = [0]
    monkeypatch.setattr(profiler, "_clock", lambda: now[0])
    rec = profiler.SpanRecorder()
    monkeypatch.setattr(profiler, "recorder", rec)

    def tick(ms):
        now[0] += int(ms * 1e6)

    def step(i, fwd, bwd, upd, loop, wrappers):
        """Step i: two microbatches of `fwd`/`bwd` ms each, `upd` ms of
        update (half of it EMA), `loop` ms outside them (half in data)."""
        with rec.span("step", step=i):
            with rec.span("data"):
                tick(loop / 2)
            for m in range(2):
                with rec.span("forward", micro=m):
                    tick(fwd)
                with rec.span("backward", micro=m):
                    tick(bwd)
            with rec.span("update"):
                tick(upd / 2)
                with rec.span("ema"):
                    tick(upd / 2)
            tick(loop / 2)
        rec.steps()[-1].wrapper_host_ns = int(wrappers * 1e6)

    return rec, step


def _read(run):
    return {n: common._reader(n)(run) for n in READERS}


def test_means_over_the_window_but_its_last_step(clocked):
    rec, step = clocked
    for i in range(3):                  # checked steps: set-up
        step(i, 1000, 1000, 1000, 1000, 1000)
    step(3, 60, 40, 10, 2, 20)
    step(4, 80, 50, 14, 4, 30)
    step(5, 1000, 1000, 1000, 1000, 1000)   # holds the closing sync
    step(6, 1000, 1000, 1000, 1000, 1000)   # a traced step
    got = _read(_run(3))
    want = {"trainer.forward_host_ms": (120 + 160) / 2,
            "trainer.backward_host_ms": (80 + 100) / 2,
            "trainer.update_host_ms": (10 + 14) / 2,
            "trainer.loop_host_ms": (2 + 4) / 2,
            "kernels.wrapper_host_ms": (20 + 30) / 2}
    assert got == pytest.approx(want)
    # forward + backward + update + loop is the step spans' time
    steps = [r.root.duration_ns / 1e6 for r in rec.steps(3, 5)]
    assert sum(got[n] for n in READERS[:4]) == pytest.approx(
        sum(steps) / len(steps))


def test_an_epochs_end_adds_to_its_step(clocked):
    """A step whose loader ran dry leaves a record with the same step
    index (its `data` span): the readers add it to that step."""
    rec, step = clocked
    step(3, 60, 40, 10, 2, 20)
    with rec.span("step", step=4):
        with rec.span("data"):
            pass                        # the loader ran dry
    step(4, 80, 50, 14, 4, 30)
    got = _read(_run(3))
    assert got["trainer.forward_host_ms"] == pytest.approx((120 + 160) / 2)
    assert got["trainer.loop_host_ms"] == pytest.approx((2 + 4) / 2)


def test_none_without_records(clocked):
    rec, step = clocked
    assert _read(_run(3)) == dict.fromkeys(READERS)
    step(0, 1, 1, 1, 1, 1)
    step(3, 1, 1, 1, 1, 1)
    assert _read(_run(1)) == dict.fromkeys(READERS)   # only the last step
    assert _read(_run(0)) == dict.fromkeys(READERS)
    got = _read(_run(2))                               # step 3 alone
    assert got["trainer.forward_host_ms"] == 2.0       # two microbatches
    assert got["trainer.update_host_ms"] == 1.0


def test_none_from_a_program_without_spans(clocked, monkeypatch):
    rec, step = clocked
    step(3, 1, 1, 1, 1, 1)
    monkeypatch.delattr(profiler, "recorder")
    assert _read(_run(2)) == dict.fromkeys(READERS)


def test_a_whole_run_reads_all_five():
    profiler.recorder.clear()
    out = train.run(tiny_files(), 2 ** 33 + 7, 0.3, False,
                    torch.device("cpu"), time.perf_counter())
    run = out["run"]
    assert run.window["steps"] >= 2
    metrics = common.per_layer(common.benchmark(), run)
    got = {n: metrics[n]["value"] for n in READERS}
    assert all(v >= 0 for v in got.values())
    assert got["trainer.forward_host_ms"] > 0
    assert got["trainer.backward_host_ms"] > 0
    assert got["kernels.wrapper_host_ms"] == 0      # no launches on the CPU
    # the four host phases cover the window's steps (but its last): within
    # the time between one step's end and the next one's start
    per_step = sum(got[n] for n in READERS[:4])
    mean_step = 1e3 * run.window["seconds"] / run.window["steps"]
    assert per_step <= mean_step * 1.5
    assert per_step >= mean_step * 0.5
