"""What every cell shares: the files found by name, the device's record,
the per-layer readers, the check against JAX and the result line."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from typing import Any, Callable, Dict, List, Optional

__all__ = ["ROOT", "HERE", "load_json", "benchmark", "cell_files",
           "device_record", "forbidden_modules", "Run", "per_layer",
           "Check", "emit"]

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# what nothing the benchmark runs may load, by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "diffusion_tpu")


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell_files(bench: dict, name: str) -> dict:
    """The cell's entry, its configuration, its traffic and its own file
    (the limits of its check), each found by name. A cell held out of
    BENCHMARK.json keeps its entry in its own file (`entry`)."""
    path = os.path.join(HERE, "cells", name + ".json")
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None and os.path.exists(path):
        cell = load_json(path).get("entry")
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    return {"cell": cell,
            "config": load_json(os.path.join(
                HERE, "configs", cell["config"] + ".json")),
            "traffic": load_json(os.path.join(
                HERE, "traffic", cell["traffic"] + ".json")),
            "check": load_json(path)}


def device_record(count: int) -> dict:
    import torch
    rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": count}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        rec["power_limit"] = out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        rec["power_limit"] = "not read"
    return rec


def forbidden_modules() -> List[str]:
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Run:
    """What a per-layer reader reads: the cell's files, the window's
    counts and the traced window (None where the run was not traced)."""

    cell: dict
    config: dict
    traffic: dict
    window: Dict[str, Any]
    trace: Any = None
    stats: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _reader(name: str) -> Callable[[Run], Optional[float]]:
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _listed(metric: dict, cell: str, e2e: Dict[str, dict]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    moved = e2e.get(metric["moves"], {})
    return "workloads" not in moved or cell in moved["workloads"]


def end_to_end(bench: dict, cell: str) -> List[dict]:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def per_layer(bench: dict, run: Run) -> Dict[str, dict]:
    """Each per-layer metric listed for this cell, from its own reader;
    a reader that finds nothing returns None and the metric is left out."""
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    out = {}
    for m in bench["per_layer"]:
        if not _listed(m, run.cell["name"], e2e):
            continue
        value = _reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


@dataclasses.dataclass
class Check:
    """One number compared, with its limit (a gap: at most the limit)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


def emit(correct: bool, attempted: int, failed: int, metrics: dict,
         device: dict, checks: List[Check], breakdown: Optional[dict] = None
         ) -> None:
    """The result: each number compared beside its limit as the last lines
    of standard error, then one JSON line as the last of standard output,
    with the checks under the key that comes last."""
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in checks}
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
