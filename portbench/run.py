#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once, on the card this process sees.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics with
`--trace 0`, its per-layer metrics with `--trace 1`), `device`, with
`--trace 1` a `breakdown`, and last the numbers compared with their limits.
Exits non-zero, printing no result, without a CUDA device (or with fewer
than the cell asks for), or where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# a library the port loads must not load JAX through transformers
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
# fixed cache directories inside the checkout: only a cell's first run in
# a checkout builds
BUILD = os.path.join(ROOT, "build", "portbench")
os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(BUILD, "cuda-cache"))
os.environ["TRITON_CACHE_DIR"] = os.path.join(BUILD, "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import common
    bench = common.benchmark()
    files = common.cell_files(bench, args.workload)
    import torch
    chips = files["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {chips} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" found; this benchmark runs only on the GPU", file=sys.stderr)
        return 2
    from diffusion_torch.utils.compile_cache import enable_compile_cache
    enable_compile_cache(os.path.join(BUILD, "kernels"))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    kind = importlib.import_module(
        f"portbench.kinds.{files['traffic']['kind']}")
    out = kind.run(files, args.seed, args.seconds, bool(args.trace),
                     device, T_START)
    w = out["run"].window
    print(f"portbench: {args.workload} seed {args.seed}: setup_s "
          f"{out['end_to_end']['setup_s']!r}, window {w['seconds']!r} s, "
          f"{out['attempted']} steps, " + ", ".join(
              f"{k} {v!r}" for k, v in out["end_to_end"].items()
              if k != "setup_s"), file=sys.stderr)
    record = common.device_record(chips)
    record["memory_peak_bytes"] = int(out["peak_bytes"])
    breakdown = None
    if args.trace:
        tr = out["trace"]
        if tr is None:
            print("portbench: the profiler recorded no device activity in "
                  "the traced window", file=sys.stderr)
            return 3
        record["busy_s"], record["window_s"] = tr.busy_s, tr.window_s
        metrics = common.per_layer(bench, out["run"])
        breakdown = tr.breakdown()
    else:
        units = {m["name"]: m["unit"]
                 for m in common.end_to_end(bench, args.workload)}
        metrics = {k: {"value": float(v), "unit": units[k]}
                   for k, v in out["end_to_end"].items() if k in units}
    loaded = common.forbidden_modules()
    if loaded:
        print(f"portbench: JAX or the JAX package was loaded: {loaded}",
              file=sys.stderr)
        return 4
    checks = out["checks"]
    common.emit(all(c.ok for c in checks) and out["failed"] == 0,
                out["attempted"], out["failed"], metrics, record, checks,
                breakdown)
    return 0


if __name__ == "__main__":
    sys.exit(main())
