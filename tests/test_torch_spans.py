"""The program's spans (`diffusion_torch/utils/profiler.py`) and the kernel
wrappers' host time (`LaunchCounter`): nesting, parents and self time; the
bounded record buffer; `record_function` ranges only while a profiler
runs, named `diffusion_torch.<span>` and nested as the spans are, in a CPU
torch.profiler trace and in `TorchProfiler`'s Chrome trace; the Trainer's
spans over a tiny fit; the counters' host-time sum. The wrappers' own
timing runs on the card (marked `gpu`, skipped without one):

    python -m pytest tests/test_torch_spans.py -q -m gpu -p no:randomly
"""

import json
import time

import numpy as np
import pytest
import torch

from diffusion_torch.algorithms.ema import EMA
from diffusion_torch.models.models import stable_diffusion_tiny
from diffusion_torch.ops._build import LaunchCounter
from diffusion_torch.train.trainer import Trainer
from diffusion_torch.utils import profiler
from diffusion_torch.utils.profiler import (MAX_STEPS, SpanRecorder,
                                            TorchProfiler)

torch.set_num_threads(1)


def _names(record):
    return [s.name for s in record.spans]


def test_nesting_parents_and_self_time():
    rec = SpanRecorder()
    with rec.span("step", step=7):
        with rec.span("forward", micro=1):
            with rec.span("inner"):
                time.sleep(0.002)
            time.sleep(0.001)
        with rec.span("update"):
            time.sleep(0.001)
    (record,) = rec.steps()
    assert record.step == 7 and _names(record) == [
        "step", "forward", "inner", "update"]
    step, fwd, inner, upd = record.spans
    assert record.root is step
    assert [s.parent for s in record.spans] == [None, step, fwd, step]
    assert [s.step for s in record.spans] == [7, 7, 7, 7]
    assert [s.micro for s in record.spans] == [None, 1, 1, None]
    for s in record.spans:
        assert 0 < s.start_ns < s.end_ns
        if s.parent is not None:
            assert s.parent.start_ns <= s.start_ns < s.end_ns \
                <= s.parent.end_ns
    assert inner.duration_ns >= 2_000_000
    assert record.self_ns(fwd) == fwd.duration_ns - inner.duration_ns
    assert record.self_ns(step) == (step.duration_ns - fwd.duration_ns
                                    - upd.duration_ns) >= 0
    assert record.self_ns(inner) == inner.duration_ns
    assert record.total_ns("forward") == fwd.duration_ns
    # a span outside any step makes a record of its own, with no step
    with rec.span("loose"):
        pass
    assert [r.step for r in rec.steps()] == [7, None]
    assert [r.step for r in rec.steps(0, 10)] == [7]


def test_a_record_is_kept_once_its_first_span_closes():
    rec = SpanRecorder()
    with rec.span("step", step=0):
        assert rec.steps() == []
        with pytest.raises(ValueError):
            with rec.span("data"):
                raise ValueError("the span closes on the way out")
    (record,) = rec.steps()
    assert _names(record) == ["step", "data"]
    assert record.spans[1].end_ns > 0


def test_the_buffer_keeps_the_last_records():
    assert profiler.recorder._records.maxlen == MAX_STEPS == 4096
    rec = SpanRecorder(max_steps=5)
    for i in range(12):
        with rec.span("step", step=i):
            with rec.span("forward"):
                pass
    assert [r.step for r in rec.steps()] == [7, 8, 9, 10, 11]
    assert [r.step for r in rec.steps(8, 10)] == [8, 9]
    assert [r.step for r in rec.steps(first=10)] == [10, 11]
    rec.clear()
    assert rec.steps() == []


def test_no_range_without_a_profiler(monkeypatch):
    made = []
    real = torch.autograd.profiler.record_function

    def counting(name, *args):
        made.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    rec = SpanRecorder()
    with rec.span("step", step=0):
        with rec.span("forward"):
            torch.ones(2) + 1
    assert made == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with rec.span("step", step=1):
            with rec.span("forward"):
                torch.ones(2) + 1
    assert made == ["diffusion_torch.step", "diffusion_torch.forward"]
    with rec.span("step", step=2):
        pass
    assert len(made) == 2


def _within(inner, outer):
    return outer.start <= inner.start and inner.end <= outer.end


def test_ranges_nest_as_the_spans_in_a_profiler_trace():
    rec = SpanRecorder()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with rec.span("step", step=3):
            with rec.span("forward"):
                torch.ones(4) + 1
            with rec.span("update"):
                with rec.span("ema"):
                    torch.zeros(4).mul_(2)
    events = {e.name: e.time_range for e in prof.events()
              if e.name.startswith("diffusion_torch.")}
    assert set(events) == {"diffusion_torch.step", "diffusion_torch.forward",
                           "diffusion_torch.update", "diffusion_torch.ema"}
    assert _within(events["diffusion_torch.forward"],
                   events["diffusion_torch.step"])
    assert _within(events["diffusion_torch.ema"],
                   events["diffusion_torch.update"])
    assert not _within(events["diffusion_torch.ema"],
                       events["diffusion_torch.forward"])
    adds = [e.time_range for e in prof.events() if e.name == "aten::add"]
    assert adds and all(_within(a, events["diffusion_torch.forward"])
                        for a in adds)
    # the recorder kept the step as well
    assert _names(rec.steps()[0]) == ["step", "forward", "update", "ema"]


def _batches(n):
    rng = np.random.default_rng(0)
    return [{"image_latents": rng.standard_normal((4, 8, 8, 4)).astype(
                np.float32),
             "caption_latents": rng.standard_normal((4, 8, 32)).astype(
                 np.float32)} for _ in range(n)]


def _fit(n, callbacks=()):
    profiler.recorder.clear()
    tr = Trainer(model=stable_diffusion_tiny(device="cpu",
                                             precomputed_latents=True),
                 train_dataloader=_batches(n), callbacks=list(callbacks),
                 algorithms=[EMA(smoothing=0.9, ema_start="0ba")],
                 max_duration=f"{n}ba", device_train_microbatch_size=2,
                 device="cpu")
    tr.fit()
    return profiler.recorder.steps()


def test_the_trainers_spans_over_a_fit():
    records = _fit(3)
    assert [r.step for r in records] == [0, 1, 2]
    for r in records:
        step = r.root
        assert step.name == "step" and step.parent is None
        assert sorted(_names(r)) == sorted(
            ["step", "data", "forward", "forward", "backward", "backward",
             "update", "ema"])
        by = {n: [s for s in r.spans if s.name == n] for n in set(_names(r))}
        assert [s.micro for s in by["forward"]] == [0, 1]
        assert [s.micro for s in by["backward"]] == [0, 1]
        (update,), (ema,) = by["update"], by["ema"]
        assert ema.parent is update
        for s in r.spans[1:]:
            if s is not ema:
                assert s.parent is step
            assert s.step == r.step
            assert step.start_ns <= s.start_ns < s.end_ns <= step.end_ns
        children = sum(s.duration_ns for s in r.spans if s.parent is step)
        assert children <= step.duration_ns
        assert r.self_ns(step) == step.duration_ns - children
        # each microbatch's forward before its backward, then the update
        order = [s.name for s in r.spans if s.parent is step]
        assert order == ["data", "forward", "backward", "forward",
                         "backward", "update"]
        # no kernel launches on the CPU: the wrappers' host time is still
        assert r.wrapper_host_ns == 0


def test_the_trainers_ranges_in_the_exported_chrome_trace(tmp_path):
    prof = TorchProfiler(trace_dir=str(tmp_path), start_batch=1,
                         num_batches=2)
    _fit(4, [prof])
    with open(prof.trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if str(e.get("name", "")).startswith("diffusion_torch.")
                  and e.get("ph") == "X"]
    names = [e["name"] for e in events]
    # batch 2 runs whole inside the trace (started at batch 1's start,
    # stopped at batch 3's end)
    assert names.count("diffusion_torch.step") >= 1
    for n in ("forward", "backward"):
        assert names.count(f"diffusion_torch.{n}") >= 4
    assert names.count("diffusion_torch.ema") >= 2
    steps = [e for e in events if e["name"] == "diffusion_torch.step"]
    inside = lambda e, o: (o["ts"] <= e["ts"]
                           and e["ts"] + e["dur"] <= o["ts"] + o["dur"])
    updates = [e for e in events if e["name"] == "diffusion_torch.update"]
    for e in events:
        if e["name"] == "diffusion_torch.ema":
            assert any(inside(e, u) for u in updates)
    covered = [e for e in events if e["name"] != "diffusion_torch.step"
               and any(inside(e, s) for s in steps)]
    assert {e["name"] for e in covered} >= {
        "diffusion_torch.data", "diffusion_torch.forward",
        "diffusion_torch.backward", "diffusion_torch.update",
        "diffusion_torch.ema"}


def test_launch_counter_sums_host_time():
    c = LaunchCounter()
    before = LaunchCounter.total_host_ns()
    c.add()
    assert (c.value, c.host_ns) == (1, 0)
    t0 = time.perf_counter_ns() - 3_000_000
    c.launched(t0)
    assert c.value == 2 and c.host_ns >= 3_000_000
    c.reset()
    assert c.value == 0 and c.host_ns >= 3_000_000
    assert LaunchCounter.total_host_ns() - before >= 3_000_000


def test_a_step_records_the_wrappers_host_time():
    c = LaunchCounter()
    rec = SpanRecorder()
    c.launched(time.perf_counter_ns() - 1_000_000)   # before: not counted
    with rec.span("step", step=0):
        with rec.span("forward"):
            c.launched(time.perf_counter_ns() - 2_000_000)
            c.launched(time.perf_counter_ns() - 2_000_000)
    with rec.span("step", step=1):
        pass
    first, second = rec.steps()
    assert 4_000_000 <= first.wrapper_host_ns < 4_000_000 + 5_000_000
    assert second.wrapper_host_ns == 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built for sm_90a)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_every_launching_wrapper_times_its_host(cuda):
    """Each wrapper adds one launch and its host time to its counter."""
    from diffusion_torch.ops import flash_attention as fa
    from diffusion_torch.ops import groupnorm as gn

    def grows(counter, fn):
        n, ns = counter.value, counter.host_ns
        out = fn()
        assert counter.value == n + 1 and counter.host_ns > ns
        return out

    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v, do = (torch.randn((1, 128, 2, 64), generator=gen, device=cuda,
                               dtype=torch.bfloat16) for _ in range(4))
    out, lse = grows(fa.launches, lambda: fa.flash_attention_cuda(q, k, v))
    n_dkv, ns_dkv = fa.launches_bwd_dkv.value, fa.launches_bwd_dkv.host_ns
    grows(fa.launches_bwd_dq,
          lambda: fa.flash_attention_bwd_cuda(q, k, v, out, lse, do))
    assert fa.launches_bwd_dkv.value == n_dkv + 1
    assert fa.launches_bwd_dkv.host_ns > ns_dkv

    x, g = (torch.randn((2, 256, 64), generator=gen, device=cuda,
                        dtype=torch.bfloat16) for _ in range(2))
    scale = torch.ones(64, device=cuda)
    bias = torch.zeros(64, device=cuda)
    y, mean, rstd = grows(gn.launches, lambda: gn.group_norm_cuda(
        x, scale, bias, 32, 1e-5, "silu"))
    grows(gn.launches_bwd, lambda: gn.group_norm_bwd_cuda(
        x, scale, bias, mean, rstd, g, 32, "silu"))
    part = grows(gn.launches, lambda: gn.group_norm_partials_cuda(x, 32))
    _, mean, rstd = grows(gn.launches, lambda: gn.group_norm_apply_cuda(
        x, scale, bias, part[None].contiguous(), 32, 1e-5, "silu"))
    cpart, gpart = grows(gn.launches_bwd,
                         lambda: gn.group_norm_bwd_partials_cuda(
                             x, scale, bias, mean, rstd, g, 32, "silu"))
    grows(gn.launches_bwd, lambda: gn.group_norm_bwd_apply_cuda(
        x, scale, bias, mean, rstd, g, cpart, gpart[None].contiguous(), 32,
        "silu"))
    torch.cuda.synchronize()
