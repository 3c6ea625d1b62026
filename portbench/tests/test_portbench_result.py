"""The last line's schema, the order of its keys, the checks printed last
on standard error, and the refusal without a card."""

import json
import os
import subprocess
import sys

from portbench import common
from portbench.tests.tiny import ROOT


def test_last_line_schema(capsys):
    checks = [common.Check("loss", 1e-3, 5e-3),
              common.Check("first_grad", 0.2, 0.1)]
    common.emit(False, 12, 0, {"setup_s": {"value": 9.5, "unit": "s"}},
                {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                 "count": 1, "memory_peak_bytes": 123}, checks,
                {"device_ops": [["k", 0.1]], "idle_gaps": []})
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert line["correct"] is False and line["attempted"] == 12
    assert line["checks"]["first_grad"] == {"value": 0.2, "limit": 0.1}
    tail = err.strip().splitlines()[-2:]
    assert tail[0].startswith("check loss 0.001 limit 0.005 ok")
    assert tail[1].endswith("FAILED")


def test_a_nan_never_passes():
    assert not common.Check("loss", float("nan"), 1.0).ok


def test_benchmark_entries_name_files_that_exist():
    bench = common.benchmark()
    for c in bench["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
    for w in bench["workloads"]:
        files = common.cell_files(bench, w["name"])
        if files["traffic"]["kind"] == "train":
            assert files["traffic"]["batch_size"] == \
                files["config"]["batch_size"]
            assert files["traffic"]["microbatch"] == \
                files["config"]["train"]["device_train_microbatch_size"]
        names = ({"image_rms"} if files["traffic"]["kind"] == "serve"
                 else {"loss", "first_grad", "change"})
        assert files["check"]["limits"] and \
            set(files["check"]["limits"]) <= names
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(common.HERE, "metrics",
                                           m["name"] + ".py"))


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "sd2-256-train",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
