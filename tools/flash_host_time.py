#!/usr/bin/env python3
"""Where the host time of one flash-attention forward call goes, on one
NVIDIA GPU.

    python3 tools/flash_host_time.py [--root DIR] [--rounds 7]

Imports `diffusion_torch` from DIR (default: the checkout holding this
script), so one script measures two trees alike. At (2, 1024, 10, 64), the
serving shape whose device time is shorter than the wrapper's host time,
it measures in each round, each figure per call over 200 calls queued
without waiting for the device (a synchronization before each figure):

  wrapper_us  `flash_attention_cuda`, whole;
  checks_us   its argument checks (`_check_qkv`) alone;
  alloc_us    its two `torch.empty` outputs alone;
  c_call_us   the ctypes call of `dt_flash_attention_fwd` alone, on
              preallocated outputs (tensor maps, kernel attribute, launch);
  event_ms    20 back-to-back wrapper calls timed with CUDA events, before
              and after a CUDA graph of SDPA's flash forward is captured
              (only the first round's "before" precedes every capture);
  graph_ms    the kernel's device time alone (10 launches replayed from a
              CUDA graph, per launch).

Prints one JSON line: the medians over the rounds and every round. Exits
with code 2 where no CUDA device is present.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

SHAPE = (2, 1024, 10, 64)


def _per_call_us(fn, iters: int = 200) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def _event_ms(fn, iters: int = 20) -> float:
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph(fn, launches: int = 10):
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return graph


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--rounds", type=int, default=7)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("flash_host_time: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from diffusion_torch.ops import flash_attention as fa
    from diffusion_torch.ops._build import library

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(SHAPE, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    b, sq, h, d = SHAPE
    out = torch.empty(SHAPE, device=dev, dtype=torch.bfloat16)
    lse = torch.empty((b, h, sq), device=dev, dtype=torch.float32)
    c_fn = library().dt_flash_attention_fwd
    c_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              lse.data_ptr(), b, h, sq, k.shape[1], *fa._strides(q, k, v),
              d ** -0.5, torch.cuda.current_stream().cuda_stream)
    if c_fn(*c_args) != 0:
        raise RuntimeError("dt_flash_attention_fwd failed")

    def wrapper():
        fa.flash_attention_cuda(q, k, v)

    def alloc():
        torch.empty(SHAPE, device=dev, dtype=torch.bfloat16)
        torch.empty((b, h, sq), device=dev, dtype=torch.float32)

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    rounds = []
    for _ in range(args.rounds):
        r = {"wrapper_us": _per_call_us(wrapper),
             "checks_us": _per_call_us(lambda: fa._check_qkv(q, k, v)),
             "alloc_us": _per_call_us(alloc),
             "c_call_us": _per_call_us(lambda: c_fn(*c_args)),
             "event_ms_before_sdpa_graph": _event_ms(wrapper)}
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            lib_graph = _graph(lambda: F.scaled_dot_product_attention(
                qt, kt, vt))
        lib_graph.replay()
        torch.cuda.synchronize()
        r["event_ms_after_sdpa_graph"] = _event_ms(wrapper)
        graph = _graph(wrapper)
        r["graph_ms"] = _event_ms(graph.replay, iters=10) / 10
        del graph, lib_graph
        rounds.append(r)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "root": os.path.abspath(args.root), "shape": SHAPE, "card": card,
        "median": {key: statistics.median(r[key] for r in rounds)
                   for key in rounds[0]},
        "rounds": rounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
