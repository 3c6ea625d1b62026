"""The reader of the optimizer's fused-kernel engagement
(`optimizer.fused_share`): the share of the window's steps but its last
that hold a `fused_update` span, and None where no steps were recorded or
the program has no fused kernel (so no step holds the span)."""

import sys

import pytest

from diffusion_torch.utils import profiler
from portbench import common


def _run(steps, checked=3):
    return common.Run(cell={"name": "sd2-512-train"}, config={},
                      traffic={"checked_steps": checked},
                      window={"steps": steps})


@pytest.fixture
def rec(monkeypatch):
    """A recorder of its own in place of the process's."""
    rec = profiler.SpanRecorder()
    monkeypatch.setattr(profiler, "recorder", rec)
    return rec


def _steps(rec, fused):
    """Steps 3.. of the window, step 3 + i's update holding a
    `fused_update` span where `fused[i]`; then the window's last step,
    fused."""
    for i, f in enumerate(list(fused) + [True]):
        with rec.span("step", step=3 + i):
            with rec.span("replay"):
                pass
            with rec.span("update"):
                if f:
                    with rec.span("fused_update"):
                        pass


@pytest.mark.parametrize("fused,want", [
    ((True, True, True), 100.0),
    ((False, False, False), 0.0),
    ((True, False, True, False), 50.0),
    ((), None),                       # only the window's last step
])
def test_fused_share(rec, fused, want):
    _steps(rec, fused)
    read = common._reader("optimizer.fused_share")
    assert read(_run(len(fused) + 1)) == want
    assert read(_run(0)) is None


def test_fused_share_from_a_program_without_the_kernel(rec, monkeypatch):
    """A program without the fused kernel (the parent of its change), whose
    steps hold no `fused_update` span, gives no reading."""
    _steps(rec, (False, False))
    monkeypatch.setitem(sys.modules, "diffusion_torch.ops.adamw", None)
    assert common._reader("optimizer.fused_share")(_run(3)) is None
