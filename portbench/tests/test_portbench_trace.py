"""The trace's arithmetic on hand-made intervals: busy time as a union,
the idle share over the whole window, the gaps named by the host op, and
a roofline share that goes silent where the launches do not match."""

import types

import pytest
import torch

from portbench import common, flops
from portbench.trace import WINDOW, Trace, read_trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _event(name, start, end, device):
    return types.SimpleNamespace(
        name=name, device_type=device,
        time_range=types.SimpleNamespace(start=start, end=end))


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _trace():
    # window 0..100 us; kernels 10-30, 20-40 (overlapping), 60-70; the
    # host runs "step" 0-100 with "aten::mm" 40-65 inside it
    return read_trace(_Prof([
        _event(WINDOW, 0, 100, CPU), _event("step", 0, 100, CPU),
        _event("aten::mm", 40, 65, CPU),
        _event("cudaLaunchKernel", 41, 42, CPU),
        _event("flash_fwd_kernel", 10, 30, CUDA),
        _event("gn_fwd_kernel", 20, 40, CUDA),
        _event("flash_fwd_kernel", 60, 70, CUDA),
        _event("late_kernel", 95, 120, CUDA),      # ends after the window
    ]))


def test_busy_is_the_union_and_idle_spans_the_whole_window():
    tr = _trace()
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(40e-6)       # 10-40 and 60-70
    assert tr.device_s(("flash_",)) == pytest.approx(30e-6)
    assert tr.count("flash_fwd_kernel") == 2
    gaps = sorted(tr.gaps)
    assert [round(g * 1e6) for g, _ in gaps] == [10, 20, 30]
    named = {round(g * 1e6): n for g, n in tr.gaps}
    assert named == {10: "step", 20: "aten::mm", 30: "step"}
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["flash_fwd_kernel", pytest.approx(30e-6)]
    assert bd["idle_gaps"][0] == ["step", pytest.approx(40e-6)]


def test_no_window_or_no_device_events_reads_nothing():
    assert read_trace(_Prof([_event("x", 0, 1, CUDA)])) is None
    assert read_trace(_Prof([_event(WINDOW, 0, 10, CPU)])) is None


def test_idle_share_and_roofline_readers():
    run = common.Run(cell={"name": "c"}, config={}, traffic={},
                     window={"traced_steps": 1}, trace=_trace())
    reader = common._reader("device.idle_share.train")
    assert reader(run) == pytest.approx(60.0)
    share = flops.traced_share(run, ("flash_",), 15e-6,
                               {"flash_fwd_kernel": 2})
    assert share == pytest.approx(50.0)
    assert flops.traced_share(run, ("flash_",), 15e-6,
                              {"flash_fwd_kernel": 3}) is None
    assert flops.traced_share(run, ("absent",), 1.0) is None
    run.trace = None
    assert reader(run) is None


def test_every_per_layer_metric_has_a_reader_that_reads_none_untraced():
    bench = common.benchmark()
    for m in bench["per_layer"]:
        for cell in m["workloads"]:
            files = common.cell_files(bench, cell)
            run = common.Run(cell=files["cell"], config=files["config"],
                             traffic=files["traffic"],
                             window={"traced_steps": 0, "seconds": 0.0,
                                     "samples": 0, "peak_bytes": 0})
            assert common._reader(m["name"])(run) is None, m["name"]


def test_a_trace_object_with_no_ops():
    tr = Trace(window_s=1.0, busy_s=0.0, ops=[], gaps=[])
    assert tr.breakdown() == {"device_ops": [], "idle_gaps": []}
