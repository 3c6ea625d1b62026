#!/usr/bin/env python3
"""The control of a training cell's check: the reference in fp8 put in the
program's place, against the reference in float32, on the cell's own sizes.

    python3 portbench/control.py --workload sd2-512-train --seeds 1 2 3

Prints, per seed, each number the check compares beside the cell's limit;
a control that the check passes is a check that cannot see a step down in
precision. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


from portbench.common import Check  # noqa: E402


def control_checks(files: dict, seed: int, device,
                   fault: str = "fp8") -> list:
    """The checks of the control (`fp8`), or of a planted fault
    (`half_batch`: the reference over half of each microbatch), put in
    the program's place."""
    if files["traffic"]["kind"] == "serve":
        return _serve_control(files, seed, device)
    from portbench.kinds.train import numbers, reference
    rows = files["traffic"]["reference_rows"]
    ref = reference(files, seed, device, rows)
    low = reference(files, seed, device, rows, control=fault == "fp8",
                    keep=0.5 if fault == "half_batch" else 1.0)
    limits = files["check"]["limits"]
    return [Check(n, v, limits.get(n, float("inf")))
            for n, v in numbers(low, ref).items()]


def _serve_control(files: dict, seed: int, device) -> list:
    """The cell's first `check_requests` prompts, each alone in its
    dispatch: the fp8 reference's images, rounded to 8 bits as a PNG
    rounds them, against the float32 reference's."""
    import numpy as np
    from portbench.kinds import serve
    from portbench.weights import derive_seed
    config, traffic = files["config"], files["traffic"]
    gen_seed = derive_seed(seed, "generation") % 2 ** 31
    reqs = serve.schedule(seed, traffic, 60.0)[:traffic["check_requests"]]
    rows = [(r["prompt"], 1, 0) for r in reqs]
    want = serve.reference_images(config, traffic, seed, gen_seed, rows,
                                  device)
    low = serve.reference_images(config, traffic, seed, gen_seed, rows,
                                 device, control=True)
    low8 = [np.round(np.clip(x, 0, 1) * 255).astype(np.uint8) for x in low]
    return serve.compare(low8, want, files["check"]["limits"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=("fp8", "half_batch"), default="fp8")
    args = ap.parse_args(argv)
    import torch
    from portbench import common
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    files = common.cell_files(common.benchmark(), args.workload)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        checks = control_checks(files, seed, device, args.fault)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          args.fault: {c.name: c.value for c in checks}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
