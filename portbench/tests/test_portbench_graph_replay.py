"""The reader of the training step's CUDA-graph engagement
(`trainer.graph_replay_share`): the share of the window's steps but its
last that hold a `replay` span, and None where no steps were recorded or
the program has no spans or no step graph."""

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


def _steps(rec, replayed):
    """Steps 3.. of the window, step 3 + i holding a `replay` span where
    `replayed[i]`; then the window's last step, replayed."""
    for i, replay in enumerate(list(replayed) + [True]):
        with rec.span("step", step=3 + i):
            with rec.span("forward", micro=0):
                pass
            with rec.span("replay" if replay else "backward"):
                pass


@pytest.mark.parametrize("replayed,want", [
    ((True, True, True), 100.0),
    ((False, False, False), 0.0),
    ((False, True, True, True), 75.0),
    ((), None),                       # only the window's last step
])
def test_graph_replay_share(rec, replayed, want):
    _steps(rec, replayed)
    read = common._reader("trainer.graph_replay_share")
    assert read(_run(len(replayed) + 1)) == want
    assert read(_run(0)) is None


@pytest.mark.parametrize("missing", ["recorder", "step_graph"])
def test_graph_replay_share_from_a_program_without_it(rec, monkeypatch,
                                                      missing):
    """A program without spans, or with spans but no step graph (the
    parent of the graph's change), gives no reading."""
    _steps(rec, (False, False))
    monkeypatch.delattr(profiler, missing)
    assert common._reader("trainer.graph_replay_share")(_run(3)) is None
