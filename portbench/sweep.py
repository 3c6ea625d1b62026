#!/usr/bin/env python3
"""Find a serving cell's knee on the card: the highest arrival rate whose
p90 latency stays under a limit with no growing backlog.

    python3 portbench/sweep.py --workload sd2-512-serve --seed 1 \
        --seconds 30 --rates 0.5 1 1.5 2 2.5

One endpoint, built and warmed once, serves first one request alone (the
latency the limit is set from: `--limit-x` times it), then the cell's
open-loop traffic at each rate for `--seconds`. Prints one JSON line per
rate: p50, p90, requests per dispatch, and the backlog (the median latency
of the window's last third over its first third; above `--growth` the
queue grows), and last the knee and 0.8 x the knee. The rate goes into the
cell's traffic file by hand, as a number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--limit-x", type=float, default=3.0)
    ap.add_argument("--growth", type=float, default=1.5)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    from diffusion_torch.inference.serve import make_server
    from diffusion_torch.utils.compile_cache import enable_compile_cache
    from portbench import common
    from portbench.kinds import serve
    from portbench.weights import derive_seed
    enable_compile_cache(os.path.join(common.ROOT, "build", "portbench",
                                      "kernels"))
    files = common.cell_files(common.benchmark(), args.workload)
    config, traffic = files["config"], files["traffic"]
    device = torch.device("cuda", 0)
    gen_seed = derive_seed(args.seed, "generation") % 2 ** 31
    ep = serve.endpoint(config, args.seed, device)
    serve._warm(ep, traffic, gen_seed)
    server = make_server(ep, "127.0.0.1", 0,
                         max_batch_size=traffic["max_batch_size"],
                         batch_wait_ms=traffic["batch_wait_ms"])
    port = server.server_address[1]
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        t0 = time.perf_counter()
        serve._post(port, serve.request_body(traffic, "a lighthouse on a "
                                             "cliff at dusk", gen_seed), 600)
        alone = time.perf_counter() - t0
        limit = args.limit_x * alone
        print(json.dumps({"alone_s": alone, "limit_s": limit}), flush=True)
        knee = None
        for rate in args.rates:
            t = dict(traffic, rate_per_s=rate)
            reqs = serve.schedule(args.seed, t, args.seconds)
            client = serve._Client(port, t, gen_seed, 600)
            before = serve._stats(port)
            start = time.perf_counter()
            client.send(reqs, start)
            client.wait(start + args.seconds + traffic["drain_s"])
            after = serve._stats(port)
            lat = np.array([r["done"] - r["at"] if r.get("status") == 200
                            else np.inf for r in client.results])
            third = max(1, len(lat) // 3)
            growth = float(np.median(lat[-third:]) / np.median(lat[:third]))
            p90 = float(np.percentile(lat, 90))
            row = {"rate": rate, "requests": len(lat),
                   "p50": float(np.percentile(lat, 50)), "p90": p90,
                   "growth": growth,
                   "requests_per_dispatch": (after["requests_total"]
                                             - before["requests_total"])
                   / max(1, after["dispatches_total"]
                         - before["dispatches_total"])}
            print(json.dumps(row), flush=True)
            if p90 <= limit and growth <= args.growth:
                knee = rate
        print(json.dumps({"knee": knee, "cell_rate": None if knee is None
                          else round(0.8 * knee, 3)}), flush=True)
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=60)
    return 0


if __name__ == "__main__":
    sys.exit(main())
