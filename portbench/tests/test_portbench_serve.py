"""The serving cell on the CPU at the tiny widths: its traffic repeats from
the seed with the same work for every seed, a sound run is correct, an
answer altered where it is produced is not, and the fp8 control fails."""

import time

import numpy as np
import torch

from portbench import common
from portbench.control import control_checks
from portbench.kinds import serve
from portbench.tests.tiny import tiny_files

CPU = torch.device("cpu")
SEED = 2 ** 31 + 77
# PNG rounding alone reads about 1/255/sqrt(12) = 0.0011
LIMITS = {"image_rms": 0.004}


def test_schedule_same_work_other_order():
    t = tiny_files("sd2-512-serve")["traffic"]
    a, b = serve.schedule(SEED, t, 20.0), serve.schedule(SEED, t, 20.0)
    assert a == b
    c = serve.schedule(SEED + 1, t, 20.0)
    n = 80
    assert len(a) == len(c) == n
    assert sorted(len(r["prompt"].split()) for r in a) == \
        sorted(len(r["prompt"].split()) for r in c)
    assert [r["prompt"] for r in a] != [r["prompt"] for r in c]
    quantiles = -np.log1p(-(np.arange(n) + 0.5) / n) / t["rate_per_s"]
    for s in (a, c):
        gaps = np.diff([r["due"] for r in s])
        assert np.isclose(gaps[:, None], quantiles[None]).any(1).all()
    assert not np.allclose(np.diff([r["due"] for r in a]),
                           np.diff([r["due"] for r in c]))
    lens = [len(r["prompt"].split()) for r in a]
    assert min(lens) == t["prompt_words"][0]
    assert max(lens) == t["prompt_words"][1]


def _run(plant=None):
    files = tiny_files("sd2-512-serve", limits=LIMITS)
    return serve.run(files, SEED, 1.5, False, CPU, time.perf_counter(),
                     plant=plant)


def test_sound_run_is_correct():
    out = _run()
    assert out["failed"] == 0 and out["attempted"] == 6
    assert all(c.ok for c in out["checks"]), out["checks"]
    assert out["run"].stats["requests_total"] == 6
    # the held-back cell's readers: the counters read, the trace's are
    # silent without a device trace
    read = {m["name"]: common._reader(m["name"])(out["run"])
            for m in tiny_files("sd2-512-serve")["check"]["per_layer"]}
    assert read["batcher.requests_per_dispatch"] >= 1.0
    assert read["endpoint.dispatch_s"] > 0 and read["mfu.serve"] > 0
    assert read["device.idle_share.serve"] is None
    assert read["flash_roofline.serve"] is None


def _altered_decode(ep):
    decode = ep.model.vae.decode
    ep.model.vae.decode = lambda z: decode(z) + 0.05


def test_an_altered_answer_is_not_correct():
    out = _run(_altered_decode)
    assert not all(c.ok for c in out["checks"]), out["checks"]


def test_the_fp8_control_fails():
    checks = control_checks(tiny_files("sd2-512-serve", limits=LIMITS),
                            SEED, CPU)
    assert not all(c.ok for c in checks), checks
