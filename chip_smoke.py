#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (exit code 1):
  1. device: the card's name and power limit, the TF32 settings (both off),
     the host's PyYAML and Pillow versions;
  2. build: the CUDA kernels from diffusion_torch/csrc with one nvcc call;
     each kernel's ptxas registers, shared memory and spills, with no
     spills allowed in the wgmma kernels (flash forward, dQ and dK/dV);
     with --parent DIR, also the parent tree's flash backward source,
     alongside;
  3. kernels: each of the five kernels (GroupNorm forward and backward,
     flash-attention forward, dQ and dK/dV) against its plain PyTorch
     version in bf16 at the main paths' shapes, with the max-abs error
     beside its bound, and each one's time beside the plain version's, the
     library call's for the same function (timed only, never used by the
     port) and the card's bound for the work (CUDA events), the device
     time alone (launches replayed from a CUDA graph; with --parent, the
     parent's dQ kernel in turns) and the wrapper's host time per call;
     for the flash kernels also TFLOP/s, and dQ + dK/dV beside SDPA's
     flash backward in a CUDA graph. Then all 61 GroupNorm calls
     of one UNet forward (256px batch 16, 512px batch 4) and backward
     (256px batch 16), each set replayed from one CUDA graph, beside its
     summed byte bound;
  4. serve: the full-width SD-2-base endpoint (random weights from a seed).
     Its UNet and VAE decoder first run against an fp32 CPU copy of
     themselves on a small input. Then, at 512px behind the port's HTTP
     server on localhost: two concurrent, mergeable requests and a third
     with another step count; HTTP 200, decodable 512x512 PNGs, finite
     latents before the decode, and both forward kernels' launch counters
     above zero for that run;
  5. times: one UNet CFG step and each request's latency (one more CFG
     step at batch 4 runs under torch.profiler for the device's busy time,
     idle share and time by kernel category at the very end, after every
     timed phase);
  6. gradient reference: the full-width training UNet's loss and gradient
     at 256px, batch 2, on the card (bf16, kernels) against the same
     weights in fp32 on the CPU (plain versions), with the three backward
     kernels' launch counters above zero;
  7. train: `Trainer.fit()` for 6 steps of the SD-2-base-256 recipe on
     precomputed latents (AdamW 1e-4, weight decay 0.01, 10000-batch
     warmup, global batch 32 in two microbatches of 16) with the 512
     recipe's EMA (0.9999, from batch 0): finite losses and grad norms,
     changed params and EMA, all five kernels' launch counters above zero
     for the fit; step time, samples/s, peak memory, launches per step;
     then two more steps under torch.profiler for the device's busy time,
     idle share and time by kernel category;
  8. composed run: the unedited yamls/SD-2-base-256.yaml composed through
     diffusion_torch's config loader with dotted overrides only (global
     batch 32, the LAION reader over precomputed-latent MDS shards that the
     port's MDSWriter writes from a numpy seed, 256 training and 64 eval
     samples; the eval set through the LAION reader too; 6 batches, eval
     every 3) and run by `diffusion_torch.train.train.train(config)`:
     finite losses and grad norms, exactly one eval (after batch 3) with a
     finite MSE, all five kernels launched during the fit and both forward
     kernels during the eval; step time and samples/s beside phase 7's,
     the wait on the dataloader per step, the eval's MSE and wall time,
     peak memory, and which libdataio path ran;
  9. fp32 UNet: `encode_latents_in_fp16: false` builds an fp32 full-width
     UNet; one 256px batch-1 forward on the card runs its attention on
     plain math (the flash counter stays 0) and agrees with the same
     weights on the CPU.

The last three lines are the kernels' JSON summary, the card's name and
power limit as nvidia-smi reports them, and {"ok": true, "device": ...}.
Exits with code 2, printing no result, when no CUDA device is present.

    python3 chip_smoke.py --parent build/parent

times the parent commit's flash dQ kernel in turns with this tree's (unpack
the parent there first: `git archive <commit> | tar -x -C build/parent`).
"""

from __future__ import annotations

import argparse
import base64
import ctypes
import gc
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time

SIZE = 512          # the server's default size (JAX serve.py:206)
STEPS = 20          # the two merged requests
STEPS_THIRD = 10    # the third request, which cannot merge with them
TRAIN_SIZE = 256    # yamls/SD-2-base-256.yaml
TRAIN_BATCH = 32    # global batch: two microbatches of 16
TRAIN_MICRO = 16    # device_train_microbatch_size (SD-2-base-256.yaml)
TRAIN_STEPS = 6
COMPOSED_TRAIN, COMPOSED_EVAL = 256, 64   # samples (8 and 2 batches of 32)
COMPOSED_EVAL_AT = 3                      # trainer.eval_interval, batches
DEVICE = "cuda:0"
# NVIDIA H100 SXM peaks (data sheet; dense bf16 tensor cores, HBM3)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke failed: {what}")


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(flops: float, nbytes: float):
    """(ms, what bounds it): the larger of the work over the card's bf16
    peak and the bytes (each input read once, each output written once)
    over its memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# kernels whose ptxas report must show no spills (the wgmma kernels, whose
# accumulators and register A operands must stay in registers)
_NO_SPILL = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")


def _kernel_name(mangled: str) -> str:
    """A kernel's identifier (plus template arguments, still mangled) from
    its mangled name in an anonymous namespace, `_ZN<n><namespace>...`."""
    m = re.match(r"_ZN(\d+)(\w+)", mangled)
    rest = m.group(2)[int(m.group(1)):]             # past the namespace
    n = re.match(r"(\d+)", rest)
    ident = rest[len(n.group(1)):len(n.group(1)) + int(n.group(1))]
    tail = rest[len(n.group(1)) + int(n.group(1)):]
    return ident + (tail[:tail.index("EE") + 2] if tail.startswith("I")
                    else "")


def _ptxas_usage(log: str) -> dict:
    """{kernel: ptxas figures} from nvcc's -Xptxas -v log, with the codes
    of ptxas's notes that it serialized a kernel's wgmma instructions
    (C7510-C7520, "Potential Performance Loss") under "wgmma_serialized"."""
    usage, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(_ZN\w+)'", line)
        note = re.search(r"\((C75\d\d)\) Potential Performance Loss: wgmma"
                         r".* in the function '(_ZN\w+)'", line)
        if m:
            name = _kernel_name(m.group(1))
            usage.setdefault(name, {})
        elif note:
            usage.setdefault(_kernel_name(note.group(2)), {}).setdefault(
                "wgmma_serialized", []).append(note.group(1))
        elif name and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            usage[name].update(spill_stores=int(st), spill_loads=int(ld))
        elif name and "Used" in line:
            usage[name]["registers"] = int(re.search(
                r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            usage[name]["static_smem"] = int(smem.group(1)) if smem else 0
    return usage


def _host_us(fn, iters: int = 20) -> float:
    """The host's time per call of a wrapper (checks, allocation, tensor
    maps, launch), launches queued without waiting for the device."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return host


def _graph_ms(fn, launches: int = 10) -> float:
    """A kernel's device time alone: `launches` calls of its wrapper
    captured in one CUDA graph, replayed, per launch. Where the wrapper's
    host time exceeds the kernel's, back-to-back launches (`_time_ms`)
    time the host instead."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(launches):
            fn()
    return _time_ms(graph.replay, iters=10, warmup=2) / launches


def _gn_library(x, scale, bias, act):
    """F.group_norm (+ F.silu) on the NCHW channels_last view of the NHWC
    slab, weights in x's dtype: the library's GroupNorm, timed only."""
    import torch.nn.functional as F
    b, l, c = x.shape
    side = int(round(l ** 0.5))
    y = F.group_norm(x.view(b, side, side, c).permute(0, 3, 1, 2), 32,
                     scale.to(x.dtype), bias.to(x.dtype), 1e-5)
    return F.silu(y) if act else y


class _ParentDq:
    """The parent tree's dQ kernel, for timing in turns with this tree's:
    the `csrc/flash_attention_bwd.cu` of a parent tree unpacked under `root`
    (for example `git archive` of the parent commit into build/parent),
    built alone with nvcc (its headers from its own csrc) into
    build/parent_flash_dq/ and called through the C signature of this
    tree's wrapper. The build starts in the constructor; `load()` waits for
    it."""

    def __init__(self, root: str):
        from diffusion_torch.ops import _build
        src = os.path.join(root, "diffusion_torch", "csrc",
                           "flash_attention_bwd.cu")
        self.out = os.path.join(os.path.dirname(_build.BUILD_DIR),
                                "parent_flash_dq", "libflash_dq.so")
        os.makedirs(os.path.dirname(self.out), exist_ok=True)
        self.proc = subprocess.Popen(
            [_build._nvcc(), *_build._FLAGS, "-I", os.path.dirname(src),
             "-o", self.out, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.fn = None

    def load(self) -> None:
        from diffusion_torch.ops import _build
        log = self.proc.communicate()[0]
        _check(self.proc.returncode == 0,
               f"the parent's flash_attention_bwd.cu: {log}")
        self.fn = ctypes.CDLL(self.out).dt_flash_attention_bwd_dq
        self.fn.argtypes = _build._SIGNATURES["dt_flash_attention_bwd_dq"]
        self.fn.restype = ctypes.c_int

    def dq(self, q, k, v, out, lse, do):
        """(dq, delta), as `flash_attention_bwd_dq_cuda` returns them."""
        import torch
        b, sq, h, d = q.shape
        delta = torch.empty_like(lse)
        dq = torch.empty((b, sq, h, d), device=q.device, dtype=q.dtype)
        rc = self.fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                     dq.data_ptr(), b, h, sq, k.shape[1],
                     *[s for t in (q, k, v, out, do) for s in t.stride()[:3]],
                     d ** -0.5, torch.cuda.current_stream().cuda_stream)
        _check(rc == 0, f"the parent's dQ kernel: CUDA error {rc}")
        return dq, delta


def _sdpa_flash_bwd(qt, kt, vt, do_t):
    """SDPA's flash backward alone on (B, H, S, D) views (aten's op, which
    autograd calls after the flash forward), as a callable for a CUDA graph;
    None where this torch lacks the op or refuses it."""
    import torch
    try:
        fwd = torch.ops.aten._scaled_dot_product_flash_attention(qt, kt, vt)
        out, lse, cq, ck, mq, mk, seed, offset = fwd[:8]

        def run():
            return torch.ops.aten._scaled_dot_product_flash_attention_backward(
                do_t, qt, kt, vt, out, lse, cq, ck, mq, mk, 0.0, False, seed,
                offset)
        run()
        return run
    except (RuntimeError, AttributeError, TypeError) as e:
        print(f"SDPA's flash backward op is not callable here: {e}")
        return None


def _unet_group_norm_phase(card: str) -> dict:
    """Every GroupNorm call of one UNet forward, replayed from one CUDA
    graph (the device time alone): the 61 forward calls of a 256px training
    microbatch (batch 16) and of a 512px CFG step (batch 4), and the 61
    backward calls of the microbatch, each total beside its summed byte
    bound (x read once and y written once; x and g read once and dx written
    once). Returns {what: (ms, bound_ms)}."""
    import torch

    from diffusion_torch.models.unet import SD2_BASE_UNET, group_norm_shapes
    from diffusion_torch.ops import groupnorm as gn

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(4)
    out = {}
    for what, batch, side, backward in (
            ("256px microbatch (batch 16) forward", 16, 32, False),
            ("512px CFG step (batch 4) forward", 4, 64, False),
            ("256px microbatch (batch 16) backward", 16, 32, True)):
        calls = []
        for shape, groups, act in group_norm_shapes(SD2_BASE_UNET, batch,
                                                    side):
            x = torch.randn(shape, generator=gen, device=dev).bfloat16()
            c = shape[-1]
            scale = torch.randn(c, generator=gen, device=dev)
            bias = torch.randn(c, generator=gen, device=dev)
            g = torch.randn(shape, generator=gen, device=dev).bfloat16() \
                if backward else None
            _, mean, rstd = gn.group_norm_cuda(x, scale, bias, groups, 1e-5,
                                               act)
            calls.append((x, g, scale, bias, mean, rstd, act))
        nbytes = sum((3 if backward else 2) * _nbytes(x) for x, *_ in calls)
        bound = nbytes / PEAK_BYTES_PER_S * 1e3

        def ours():
            for x, g, scale, bias, mean, rstd, act in calls:
                if backward:
                    gn.group_norm_bwd_cuda(x, scale, bias, mean, rstd, g, 32,
                                           act)
                else:
                    gn.group_norm_cuda(x, scale, bias, 32, 1e-5, act)

        ms = _graph_ms(ours)
        print(f"kernel group_norm unet {what}: {len(calls)} calls in a CUDA "
              f"graph {ms:.4f} ms; summed byte bound {bound:.4f} ms "
              f"({nbytes / 1e6:.1f} MB) [{card}]")
        out[what] = (ms, bound)
        del calls
    return out


def _graph_turns(case, fn, parent_fn) -> None:
    """case["graph_ms"] from `fn` and, where the parent's kernels were
    built, case["parent_graph_ms"] from `parent_fn`, timed in turns (parent,
    this tree, this tree, parent); each the mean of its two."""
    if parent_fn is None:
        case["graph_ms"] = _graph_ms(fn)
        return
    a, b, c, d = (_graph_ms(f) for f in (parent_fn, fn, fn, parent_fn))
    case["graph_ms"], case["parent_graph_ms"] = (b + c) / 2, (a + d) / 2


def _kernel_phase(card: str, parent=None):
    """Each kernel against its plain version at the main paths' shapes;
    returns {kernel: [case, ...]}, a case being a dict of err, ms,
    plain_ms, library_ms, bound_ms, bound_by. `parent`: the parent's dQ
    kernel (`_ParentDq`), timed in turns with this tree's."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    import torch.nn.functional as F

    from diffusion_torch.ops import flash_attention as fa
    from diffusion_torch.ops import groupnorm as gn

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def report(name, shape, case, err_text, extra=""):
        rate = (f", {case['tflops']:.1f} TFLOP/s" if "tflops" in case
                else "") + (
            f"; in a CUDA graph {case['graph_ms']:.4f} ms" + (
                f" (library {case['library_graph_ms']:.4f} ms)"
                if "library_graph_ms" in case else "")
            + (f" (the parent's kernels {case['parent_graph_ms']:.4f} ms, "
               f"{case['parent_graph_ms'] / case['graph_ms']:.2f}x)"
               if "parent_graph_ms" in case else "")
            + f"; wrapper host time {case['host_us']:.1f} us per call"
            if "graph_ms" in case else "")
        print(f"kernel {name} {shape} bf16{extra}: {err_text}; "
              f"{case['ms']:.4f} ms vs plain {case['plain_ms']:.4f} ms, "
              f"library {case['library_ms']:.4f} ms, bound "
              f"{case['bound_ms']:.4f} ms ({case['bound_by']}){rate} "
              f"[{card}]")

    results = {name: [] for name in (
        "group_norm", "group_norm_bwd", "flash_attention",
        "flash_attention_bwd_dq", "flash_attention_bwd_dkv")}

    # GroupNorm forward: the serving shapes, then the 256px training ones
    for shape, act in (((2, 4096, 320), "silu"), ((2, 1024, 640), None),
                       ((1, 262144, 128), "silu"), ((16, 1024, 320), "silu")):
        x = randn(*shape)
        c = shape[-1]
        scale, bias = randn(c, dtype=torch.float32), randn(c, dtype=torch.float32)
        y, mean, rstd = gn.group_norm_cuda(x, scale, bias, 32, 1e-5, act)
        ref = gn.group_norm_reference(x, scale, bias, 32, 1e-5, act)
        ref_mean, ref_rstd = gn.group_norm_stats_reference(x, 32, 1e-5)
        err = (y.float() - ref.float()).abs().max().item()
        # kernel and plain version round nearly equal fp32 values to bf16:
        # at most one bf16 ulp (2**-7 relative) of the largest |y|, doubled
        bound = 2.0 ** -6 * ref.float().abs().max().item()
        stat_err = max((mean - ref_mean).abs().max().item(),
                       ((rstd - ref_rstd).abs() / ref_rstd).max().item())
        bms, by = _bound(10 * x.numel(), 2 * _nbytes(x) + 3 * c * 4)
        fn = lambda: gn.group_norm_cuda(x, scale, bias, 32, 1e-5, act)
        case = {"err": err, "bound_ms": bms, "bound_by": by,
                "ms": _time_ms(fn),
                "plain_ms": _time_ms(lambda: gn.group_norm_reference(
                    x, scale, bias, 32, 1e-5, act)),
                "library_ms": _time_ms(lambda: _gn_library(x, scale, bias,
                                                           act)),
                "host_us": _host_us(fn), "graph_ms": _graph_ms(fn)}
        report("group_norm", shape, case,
               f"max_abs_err {err:.3e} (bound {bound:.3e}), stats err "
               f"{stat_err:.3e} (bound 1e-4)", f" act={act}")
        _check(err <= bound and stat_err <= 1e-4,
               f"group_norm disagrees with its plain version at {shape}")
        results["group_norm"].append(case)

    # GroupNorm backward at the 256px training shapes (batch 16)
    for shape, act in (((16, 1024, 320), "silu"), ((16, 256, 640), None),
                       ((16, 1024, 960), "silu")):
        x, g = randn(*shape), randn(*shape)
        c = shape[-1]
        scale, bias = randn(c, dtype=torch.float32), randn(c, dtype=torch.float32)
        _, mean, rstd = gn.group_norm_cuda(x, scale, bias, 32, 1e-5, act)
        dx, dscale, dbias = gn.group_norm_bwd_cuda(x, scale, bias, mean, rstd,
                                                   g, 32, act)
        want = gn.group_norm_bwd_reference(x, scale, bias, mean, rstd, g, 32,
                                           act)
        err = (dx.float() - want[0].float()).abs().max().item()
        # both compute dx in fp32 from the same inputs and round once to
        # bf16: at most one ulp of the largest |dx|, doubled
        bound = 2.0 ** -6 * want[0].float().abs().max().item()
        p_err = max(((a - w).abs().max() / w.abs().max()).item()
                    for a, w in zip((dscale, dbias), want[1:]))
        xl = x.detach().requires_grad_()
        sl = scale.to(x.dtype).requires_grad_()
        bl = bias.to(x.dtype).requires_grad_()
        lib_out = _gn_library(xl, sl, bl, act)
        g_nchw = g.view(lib_out.shape[0], lib_out.shape[2], lib_out.shape[3],
                        c).permute(0, 3, 1, 2)
        bms, by = _bound(20 * x.numel(), 3 * _nbytes(x) + 7 * c * 4)
        fn = lambda: gn.group_norm_bwd_cuda(x, scale, bias, mean, rstd, g,
                                            32, act)
        case = {"err": err, "bound_ms": bms, "bound_by": by,
                "ms": _time_ms(fn),
                "plain_ms": _time_ms(lambda: gn.group_norm_bwd_reference(
                    x, scale, bias, mean, rstd, g, 32, act)),
                "library_ms": _time_ms(lambda: torch.autograd.grad(
                    lib_out, (xl, sl, bl), g_nchw, retain_graph=True)),
                "host_us": _host_us(fn), "graph_ms": _graph_ms(fn)}
        report("group_norm_bwd", shape, case,
               f"dx max_abs_err {err:.3e} (bound {bound:.3e}), "
               f"dscale/dbias relative err {p_err:.3e} (bound 1e-4)",
               f" act={act}")
        _check(err <= bound and p_err <= 1e-4,
               f"group_norm_bwd disagrees with its plain version at {shape}")
        results["group_norm_bwd"].append(case)

    # flash forward: the serving shapes, then the 256px training one; the
    # library call is SDPA's flash backend on the (B, H, S, D) views
    for shape in ((2, 4096, 5, 64), (2, 1024, 10, 64), (16, 1024, 5, 64)):
        q, k, v = randn(*shape), randn(*shape), randn(*shape)
        out, lse = fa.flash_attention_cuda(q, k, v)
        ref_out, ref_lse = fa.flash_attention_reference(q, k, v)
        err = (out.float() - ref_out.float()).abs().max().item()
        ref_max = ref_out.float().abs().max().item()
        rel_l2 = ((out.float() - ref_out.float()).norm()
                  / ref_out.float().norm()).item()
        lse_err = (lse - ref_lse).abs().max().item()
        b, s, h, d = shape
        flops = 4 * b * h * s * s * d
        bms, by = _bound(flops, 4 * _nbytes(q) + _nbytes(lse))
        # the kernel's times first, before any CUDA graph is captured
        case = {"err": err, "bound_ms": bms, "bound_by": by,
                "ms": _time_ms(lambda: fa.flash_attention_cuda(q, k, v)),
                "host_us": _host_us(lambda: fa.flash_attention_cuda(q, k, v)),
                "graph_ms": _graph_ms(lambda: fa.flash_attention_cuda(q, k, v)),
                "plain_ms": _time_ms(
                    lambda: fa.flash_attention_reference(q, k, v), 5, 1)}
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            case["library_ms"] = _time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt))
            case["library_graph_ms"] = _graph_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt))
        case["tflops"] = flops / case["ms"] / 1e9
        # p is cast to bf16 against the running max in the kernel, against
        # the final lse in the plain version (2**-9 relative on each term,
        # each side), and the output is rounded to bf16 once: a few outputs
        # one bf16 ulp apart (two allowed at the largest |out|), 3e-3
        # relative L2 in all; p rounded to fp8 e4m3 (2**-4) gives ~2.4e-2
        out_bound = min(2e-2, 2.0 ** -6 * ref_max)
        report("flash_attention", shape, case,
               f"out max_abs_err {err:.3e} (bound {out_bound:.3e}), relative "
               f"L2 error {rel_l2:.3e} (bound {2.0 ** -7:.3e}), lse "
               f"max_abs_err {lse_err:.3e} (bound 1e-3)")
        _check(err <= out_bound and rel_l2 <= 2.0 ** -7 and lse_err <= 1e-3,
               f"flash_attention disagrees with its plain version at {shape}")
        results["flash_attention"].append(case)

    # flash backward: 256px training (first stage, batch 16), then 512px
    for shape in ((16, 1024, 5, 64), (4, 4096, 5, 64)):
        q, k, v, do = (randn(*shape) for _ in range(4))
        out, lse = fa.flash_attention_cuda(q, k, v)
        dq, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, out, lse, do)
        dk, dv = fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta)
        want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do)
        # both round p and ds to bf16 before their products and the outputs
        # once more: one bf16 ulp of the largest element, doubled
        errs = [((a.float() - w.float()).abs().max().item(),
                 2.0 ** -6 * w.float().abs().max().item())
                for a, w in zip((dq, dk, dv), want)]
        b, s, h, d = shape
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        do_t = do.transpose(1, 2)
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            lib_out = F.scaled_dot_product_attention(qt, kt, vt)
            lib_bwd = _time_ms(lambda: torch.autograd.grad(
                lib_out, (qt, kt, vt), do_t, retain_graph=True))
            lib_both = _time_ms(lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(qt, kt, vt), (qt, kt, vt),
                do_t))
        lib_run = _sdpa_flash_bwd(*(t.detach() for t in (qt, kt, vt)), do_t)
        lib_graph = _graph_ms(lib_run) if lib_run else None
        plain = _time_ms(lambda: fa.flash_attention_bwd_reference(
            q, k, v, out, lse, do), 5, 1)
        flops = 2 * b * h * s * s * d             # one S x S x d product
        small = _nbytes(lse) + _nbytes(delta)
        # delta = rowsum(dO * O) in fp32 on both sides, summed in another
        # order: 1e-5 of the row's sum of |dO * O|
        prod = do.float() * out.float()
        delta_err = ((delta - prod.sum(-1).transpose(1, 2)).abs()
                     / prod.abs().sum(-1).transpose(1, 2)).max().item()
        graph = {}
        for name, n_mm, nbytes, fn, (err, bound), theirs in (
                ("flash_attention_bwd_dq", 3, 6 * _nbytes(q) + small,
                 lambda: fa.flash_attention_bwd_dq_cuda(q, k, v, out, lse, do),
                 errs[0],
                 parent and (lambda: parent.dq(q, k, v, out, lse, do))),
                ("flash_attention_bwd_dkv", 4, 6 * _nbytes(q) + small,
                 lambda: fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse,
                                                         delta),
                 max(errs[1:]), None)):
            bms, by = _bound(n_mm * flops, nbytes)
            case = {"err": err, "bound_ms": bms, "bound_by": by,
                    "ms": _time_ms(fn), "plain_ms": plain,
                    "library_ms": lib_bwd, "host_us": _host_us(fn)}
            _graph_turns(case, fn, theirs)
            case["tflops"] = n_mm * flops / case["ms"] / 1e9
            graph[name] = case["graph_ms"]
            delta_text = (f", delta relative err {delta_err:.3e} (bound "
                          f"1e-5)" if name.endswith("_dq") else "")
            report(name, shape, case,
                   f"max_abs_err {err:.3e} (bound {bound:.3e}){delta_text}; "
                   f"plain and library times are the whole backward")
            _check(err <= bound and (delta_err <= 1e-5
                                     or not name.endswith("_dq")),
                   f"{name} disagrees with its plain version at {shape}")
            results[name].append(case)
        both = sum(graph.values())
        lib_text = (f"{lib_graph:.4f} ms ({lib_graph / both:.2f}x ours)"
                    if lib_graph else "not measured")
        print(f"kernel flash_attention_bwd dQ + dK/dV {shape} bf16: in a "
              f"CUDA graph {both:.4f} ms ({graph['flash_attention_bwd_dq']:.4f}"
              f" + {graph['flash_attention_bwd_dkv']:.4f}) vs library (SDPA "
              f"flash backward alone, in a CUDA graph) {lib_text} [{card}]")
        ours = _time_ms(lambda: fa.flash_attention_bwd_cuda(
            q, k, v, *fa.flash_attention_cuda(q, k, v), do))
        print(f"kernel flash_attention forward+backward {shape} bf16: "
              f"{ours:.4f} ms vs library (SDPA flash) {lib_both:.4f} ms "
              f"[{card}]")
    return results


def _rel_l2(got, want) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return ((got - want).norm() / want.norm()).item()


def _reference_phase(model, card: str) -> None:
    """The full-width UNet and VAE decoder on the card (bf16, kernels)
    against the same weights on the CPU (fp32, plain versions), at 256px so
    the UNet's first stage (S=1024) runs the flash kernel."""
    import copy

    import torch
    gen = torch.Generator().manual_seed(1)
    lat = torch.randn((2, 4, 32, 32), generator=gen).contiguous(
        memory_format=torch.channels_last)
    t = torch.tensor([999, 20])
    ctx = torch.randn((2, 77, 1024), generator=gen)
    z = torch.randn((1, 4, 16, 16), generator=gen)
    for name, module, run in (
            ("UNet", model.unet, lambda m, dev: m(lat.to(dev), t.to(dev),
                                                  ctx.to(dev))),
            ("VAE decode", model.vae, lambda m, dev: m.decode(z.to(dev)))):
        with torch.inference_mode():
            got = run(module, "cuda:0")
            ref = copy.deepcopy(module).to("cpu")
            ref.dtype = torch.float32
            want = run(ref, "cpu")
        del ref
        err = _rel_l2(got, want)
        finite = bool(torch.isfinite(got).all())
        # bf16 keeps 8 significant bits (2**-8 relative per rounding); the
        # roundings of ~100 layers add up to a few percent of the output
        print(f"reference: {name} {tuple(got.shape)} bf16 on the card vs "
              f"fp32 on the CPU: relative L2 error {err:.3e} (bound 5e-2), "
              f"finite {finite} [{card}]")
        _check(finite and err <= 5e-2,
               f"{name} disagrees with its fp32 CPU reference")


def _grad_reference_phase(model, card: str) -> None:
    """The full-width training UNet's loss and gradient on the card (bf16,
    kernels) against the same weights in fp32 on the CPU (plain versions),
    at 256px with batch 2 (the flash kernels run at S=1024), with the same
    explicit timesteps and noise on both sides."""
    import copy
    import dataclasses

    import torch

    from diffusion_torch.ops import flash_attention as fa
    from diffusion_torch.ops import groupnorm as gn

    gen = torch.Generator().manual_seed(2)
    side = TRAIN_SIZE // 8
    ctx = model.unet.config.cross_attention_dim
    batch = {"image_latents": torch.randn((2, side, side, 4), generator=gen),
             "caption_latents": torch.randn((2, 77, ctx), generator=gen)}
    noise = torch.randn((2, side, side, 4), generator=gen)
    t = torch.tensor([741, 58])
    named = ("down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q."
             "weight", "down_blocks.0.resnets.0.norm1.weight")

    def loss_and_grads(sd, dev):
        sd.unet.zero_grad(set_to_none=True)
        loss = sd.loss_fn({k: v.to(dev) for k, v in batch.items()},
                          noise=noise.to(dev), timesteps=t.to(dev))
        loss.backward()
        grads = {n: p.grad.float().cpu() for n, p in sd.unet.named_parameters()}
        sd.unet.zero_grad(set_to_none=True)
        return loss.item(), grads

    counters = (fa.launches_bwd_dq, fa.launches_bwd_dkv, gn.launches_bwd)
    for c in counters:
        c.reset()
    got_loss, got = loss_and_grads(model, DEVICE)
    torch.cuda.synchronize()
    kernel_bwd = tuple(c.value for c in counters)
    ref_unet = copy.deepcopy(model.unet).to("cpu")
    ref_unet.dtype = torch.float32
    want_loss, want = loss_and_grads(
        dataclasses.replace(model, unet=ref_unet), "cpu")
    del ref_unet

    def rel(names):
        num = sum((got[n] - want[n]).square().sum().item() for n in names)
        den = sum(want[n].square().sum().item() for n in names)
        return (num / den) ** 0.5

    loss_err = abs(got_loss - want_loss) / abs(want_loss)
    whole, parts = rel(want), [rel([n]) for n in named]
    finite = all(bool(torch.isfinite(g).all()) for g in got.values())
    # bf16 keeps 8 significant bits (2**-8 relative per rounding); the
    # forward's ~100 layers reach a few percent of the output (the serving
    # reference), the backward twice as many layers again, and a weight
    # gradient sums products of two bf16 tensors: 1e-1 for the whole
    # gradient, 2e-1 for one tensor, 3e-2 for the loss (a mean)
    print(f"grad reference: full-width UNet, {TRAIN_SIZE}px batch 2, bf16 "
          f"on the card vs fp32 on the CPU: loss {got_loss:.6f} vs "
          f"{want_loss:.6f} (relative difference {loss_err:.3e}, bound "
          f"3e-2); whole gradient relative L2 error {whole:.3e} (bound "
          f"1e-1); {named[0]} {parts[0]:.3e}, {named[1]} {parts[1]:.3e} "
          f"(bound 2e-1 each); finite {finite}; backward kernel launches "
          f"(flash dQ, flash dK/dV, GroupNorm) {kernel_bwd} [{card}]")
    _check(finite and loss_err <= 3e-2 and whole <= 1e-1
           and max(parts) <= 2e-1 and min(kernel_bwd) > 0,
           "the full-width gradient disagrees with its fp32 CPU reference")


def _train_phase(model, card: str):
    """`Trainer.fit()` over the SD-2-base-256 recipe; returns the five
    kernels' launch counts during the fit and the step time (s) after the
    first step."""
    import torch

    from diffusion_torch.algorithms.ema import EMA
    from diffusion_torch.ops import groupnorm as gn
    from diffusion_torch.train.events import Callback
    from diffusion_torch.train.optim import adamw, multi_step_with_warmup
    from diffusion_torch.train.trainer import Trainer

    class Record(Callback):
        """Syncs on each step's metrics; keeps them and the host time."""

        def __init__(self):
            self.steps = []

        def batch_end(self, state, logger):
            m = {k: float(v) for k, v in state.metrics.items()}
            self.steps.append((m, time.perf_counter(), state.lr))

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(3)
    side = TRAIN_SIZE // 8
    ctx = model.unet.config.cross_attention_dim
    batches = [{"image_latents": torch.randn((TRAIN_BATCH, side, side, 4),
                                             generator=gen, device=dev),
                "caption_latents": torch.randn((TRAIN_BATCH, 77, ctx),
                                               generator=gen, device=dev)}
               for _ in range(TRAIN_STEPS)]
    initial = {n: p.detach().to("cpu", copy=True)
               for n, p in model.unet.named_parameters()}
    record = Record()
    trainer = Trainer(
        model=model, train_dataloader=batches,
        optimizers=adamw(lr=1e-4, weight_decay=0.01),
        schedulers=multi_step_with_warmup(t_warmup="10000ba",
                                          milestones=["200ep"]),
        algorithms=[EMA(smoothing=0.9999, ema_start="0ba")],
        callbacks=[record], max_duration=f"{TRAIN_STEPS}ba",
        device_train_microbatch_size=TRAIN_MICRO, seed=17, device=dev)
    counters = _counters()
    for c in (*counters.values(), gn.contiguity_copies):
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.fit()
    torch.cuda.synchronize()
    launches = {name: c.value for name, c in counters.items()}
    copies = gn.contiguity_copies.value
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    ts = trainer.train_state
    for i, (m, _, lr) in enumerate(record.steps):
        print(f"train: step {i}: loss {m['loss/train/total']:.6f}, grad norm "
              f"{m['grad/global_norm']:.6f}, lr {lr:.3e}")
    _check(len(record.steps) == TRAIN_STEPS, "the fit ran too few steps")
    _check(all(math.isfinite(v) for m, _, _ in record.steps
               for v in m.values()), "a loss or grad norm is not finite")
    changed = {n: (p.detach().cpu() != initial[n]) for n, p in ts.params.items()}
    n_changed = sum(int(c.sum()) for c in changed.values())
    n_total = sum(c.numel() for c in changed.values())
    tensors_changed = sum(bool(c.any()) for c in changed.values())
    ema_vs_init = sum(int((ts.ema_params[n].cpu() != initial[n]).sum())
                      for n in initial)
    ema_vs_params = sum(int((ts.ema_params[n] != p.detach()).sum())
                        for n, p in ts.params.items())
    print(f"train: {n_changed} of {n_total} UNet parameters "
          f"({tensors_changed} of {len(changed)} tensors) differ from their "
          f"initial values; EMA differs from the initial values in "
          f"{ema_vs_init} and from the params in {ema_vs_params} elements")
    _check(n_changed > 0 and ema_vs_init > 0 and ema_vs_params > 0,
           "params or EMA did not change")
    times = [b - a for (_, a, _), (_, b, _) in zip(record.steps,
                                                   record.steps[1:])]
    step_s = sum(times) / len(times)
    print(f"train: SD-2-base {TRAIN_SIZE}px, global batch {TRAIN_BATCH} "
          f"({TRAIN_BATCH // TRAIN_MICRO} microbatches of {TRAIN_MICRO}), "
          f"{TRAIN_STEPS} steps in {time.perf_counter() - t0:.2f} s: step "
          f"time after the first {step_s * 1e3:.1f} ms (steps: "
          f"{', '.join(f'{x * 1e3:.1f}' for x in times)} ms), "
          f"{TRAIN_BATCH / step_s:.2f} samples/s, peak device memory "
          f"{peak:.2f} GiB [{card}]")
    print(f"train: kernel launches during the fit {json.dumps(launches)}; "
          f"per step " + json.dumps(
              {k: v / TRAIN_STEPS for k, v in launches.items()})
          + f"; GroupNorm cotangents copied to contiguous: {copies} "
          f"({copies / TRAIN_STEPS:.1f} per step)")
    for name, n in launches.items():
        _check(n > 0, f"{name} kernel was not launched during the fit")
    del trainer
    _profile_phase(model, batches, card)
    return launches, step_s


def _counters() -> dict:
    """The five kernels' launch counters, by the names of the JSON line."""
    from diffusion_torch.ops import flash_attention as fa
    from diffusion_torch.ops import groupnorm as gn
    return {"group_norm": gn.launches, "group_norm_bwd": gn.launches_bwd,
            "flash_attention": fa.launches,
            "flash_attention_bwd_dq": fa.launches_bwd_dq,
            "flash_attention_bwd_dkv": fa.launches_bwd_dkv}


class ComposedRecord:
    """A callback for the composed run, named by a `_target_` in its
    config: per step the metrics (synchronised), the step's end and the
    wait on the dataloader; per eval its wall time (synchronised) and the
    kernels' launches inside it."""

    def __init__(self):
        self.steps, self.waits, self.evals = [], [], []
        self._t = self._got = self._launches = None

    def run_event(self, event, state, logger) -> None:
        import torch
        name = event.value
        if name == "before_dataloader":
            self._t = time.perf_counter()
        elif name == "after_dataloader":
            self._got = time.perf_counter()
            self.waits.append(self._got - self._t)
        elif name == "batch_end":
            metrics = {k: float(v) for k, v in state.metrics.items()}
            now = time.perf_counter()
            # the step's own time: from the batch in hand to its metrics
            self.steps.append((metrics, now, state.lr, now - self._got))
        elif name == "eval_start":
            torch.cuda.synchronize()
            self._t = time.perf_counter()
            self._launches = {k: c.value for k, c in _counters().items()}
        elif name == "eval_end":
            torch.cuda.synchronize()
            self.evals.append((state.timestamp.batch,
                               time.perf_counter() - self._t,
                               {k: c.value - self._launches[k]
                                for k, c in _counters().items()}))

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, d: dict) -> None:
        pass


def _write_laion_shards(path: str, n: int, rng, size: int = TRAIN_SIZE,
                        dim: int = 1024) -> int:
    """LAION's MDS columns (`jpg`, `caption`, `latents_256` 4x32x32 fp16
    NCHW, `caption_latents` 77x1024 fp16, at size 256) with the port's
    MDSWriter, values from `rng`; returns the bytes written."""
    import numpy as np
    from PIL import Image

    from diffusion_torch.data.mds import MDSWriter
    cols = {"jpg": "bytes", "caption": "str", f"latents_{size}": "bytes",
            "caption_latents": "bytes"}
    with MDSWriter(path, cols, size_limit=1 << 23) as w:
        for i in range(n):
            buf = io.BytesIO()
            Image.fromarray(rng.integers(0, 255, (32, 32, 3), np.uint8)).save(
                buf, format="JPEG")
            w.write({"jpg": buf.getvalue(), "caption": f"sample {i}",
                     f"latents_{size}": rng.standard_normal(
                         (4, size // 8, size // 8)).astype(
                             np.float16).tobytes(),
                     "caption_latents": rng.standard_normal(
                         (77, dim)).astype(np.float16).tobytes()})
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def _composed_phase(card: str, train_step_s: float) -> dict:
    """yamls/SD-2-base-256.yaml composed by the port's loader and run by
    its `train(config)` over MDS shards written here; returns the five
    kernels' launch counts during the run."""
    import tempfile

    import numpy as np
    import torch

    from diffusion_torch.config import load_config
    from diffusion_torch.data import native
    from diffusion_torch.train.train import train

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_laion_") as tmp:
        t0 = time.perf_counter()
        rng = np.random.default_rng(6)
        train_dir, eval_dir = (os.path.join(tmp, d) for d in ("train", "eval"))
        nbytes = (_write_laion_shards(train_dir, COMPOSED_TRAIN, rng),
                  _write_laion_shards(eval_dir, COMPOSED_EVAL, rng))
        print(f"composed: wrote {COMPOSED_TRAIN} training and {COMPOSED_EVAL}"
              f" eval LAION samples ({nbytes[0] / 1e6:.1f} + "
              f"{nbytes[1] / 1e6:.1f} MB of MDS shards) in "
              f"{time.perf_counter() - t0:.1f} s")
        metrics_file = os.path.join(tmp, "metrics.jsonl")
        overrides = [
            f"batch_size={TRAIN_BATCH}",
            f"dataset.train_dataset.remote={train_dir}",
            f"dataset.train_dataset.local={train_dir}",
            "dataset.train_dataset.num_workers=2",
            "dataset.eval_dataset._target_="
            "diffusion_tpu.data.laion.build_streaming_laion_dataloader",
            f"dataset.eval_dataset.remote={eval_dir}",
            f"dataset.eval_dataset.local={eval_dir}",
            "+dataset.eval_dataset.precomputed_latents=true",
            f"dataset.eval_dataset.batch_size={TRAIN_BATCH}",
            f"dataset.eval_batch_size={TRAIN_BATCH}",
            "dataset.eval_dataset.num_workers=2",
            f"trainer.max_duration={TRAIN_STEPS}ba",
            f"trainer.eval_interval={COMPOSED_EVAL_AT}ba",
            "+logger.file._target_=diffusion_tpu.utils.logging.FileLogger",
            f"+logger.file.filename={metrics_file}",
            f"+callbacks.chip_smoke._target_={__name__}.ComposedRecord"]
        config = load_config(os.path.join(root, "yamls", "SD-2-base-256.yaml"),
                             overrides)
        print(f"composed: yamls/SD-2-base-256.yaml with {len(overrides)} "
              f"dotted overrides: {' '.join(overrides)}")
        # WandBLogger is a no-op without wandb; with it, it stays offline
        os.environ.setdefault("WANDB_MODE", "disabled")
        counters = _counters()
        for c in counters.values():
            c.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = train(config)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: c.value for name, c in counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with open(metrics_file) as f:
            records = [json.loads(line) for line in f]

    record = next(c for c in trainer.engine.callbacks
                  if type(c).__name__ == "ComposedRecord")
    model = trainer.model
    print(f"composed: model {type(model).__module__}.{type(model).__name__}, "
          f"UNet {sum(p.numel() for p in model.unet.parameters()) / 1e6:.1f}M"
          f" params, compute {model.unet.dtype}; loaders "
          f"{type(trainer.train_dataloader).__module__} ({len(trainer.train_dataloader)}"
          f" batches an epoch, {trainer.train_dataloader.worker_type} workers);"
          f" algorithms {[type(a).__name__ for a in trainer.engine.algorithms]};"
          f" libdataio: {native.build_info()}")
    for i, (m, _, lr, own) in enumerate(record.steps):
        print(f"composed: step {i}: loss {m['loss/train/total']:.6f}, grad "
              f"norm {m['grad/global_norm']:.6f}, lr {lr:.3e}, waited "
              f"{record.waits[i] * 1e3:.1f} ms on the dataloader, then "
              f"{own * 1e3:.1f} ms to the step's metrics")
    _check(trainer.state.timestamp.batch == TRAIN_STEPS
           and len(record.steps) == TRAIN_STEPS,
           "the composed run did not take its 6 batches")
    _check(all(math.isfinite(v) for m, *_ in record.steps
               for v in m.values()),
           "a loss or grad norm of the composed run is not finite")
    times = [b[1] - a[1] for a, b in zip(record.steps, record.steps[1:])]
    # the batch after the eval carries the eval: leave it out
    train_times = [t for i, t in enumerate(times) if i + 1 != COMPOSED_EVAL_AT]
    step_s = sum(train_times) / len(train_times)
    waits = record.waits[1:]
    wait_s = sum(waits) / len(waits)
    owns = [st[3] for i, st in enumerate(record.steps)
            if i and i != COMPOSED_EVAL_AT]
    own_s = sum(owns) / len(owns)
    print(f"composed: SD-2-base {TRAIN_SIZE}px from MDS shards, global batch "
          f"{TRAIN_BATCH}: run {wall:.2f} s (composition and the model's "
          f"build included); step time after the first {step_s * 1e3:.1f} ms"
          f" (steps: {', '.join(f'{x * 1e3:.1f}' for x in times)} ms, the "
          f"one after the eval left out), {TRAIN_BATCH / step_s:.2f} "
          f"samples/s, against {train_step_s * 1e3:.1f} ms and "
          f"{TRAIN_BATCH / train_step_s:.2f} samples/s from memory (phase "
          f"7); dataloader wait {wait_s * 1e3:.1f} ms a step after the first "
          f"({wait_s / step_s:.3f} of the step; first step "
          f"{record.waits[0] * 1e3:.1f} ms, the workers' start), the step's "
          f"own time (batch in hand to metrics) {own_s * 1e3:.1f} ms; peak "
          f"device memory {peak:.2f} GiB [{card}]")
    evals = [r for r in records if "metrics/eval/MeanSquaredError" in r]
    _check(len(evals) == 1 and len(record.evals) == 1
           and evals[0]["step"] == COMPOSED_EVAL_AT
           and record.evals[0][0] == COMPOSED_EVAL_AT,
           f"expected one eval after batch {COMPOSED_EVAL_AT}: {evals}")
    mse = evals[0]["metrics/eval/MeanSquaredError"]
    mse_bin = evals[0]["metrics/eval/MeanSquaredError/bin-0-1"]
    _, eval_s, eval_launches = record.evals[0]
    print(f"composed: eval after batch {COMPOSED_EVAL_AT}: MSE {mse:.6f}, "
          f"bin 0-1 {mse_bin:.6f}, {COMPOSED_EVAL // TRAIN_BATCH} batches of "
          f"{TRAIN_BATCH} in {eval_s * 1e3:.1f} ms [{card}]")
    _check(math.isfinite(mse) and mse == mse_bin,
           "the eval MSE is not finite or differs from its (0, 1) bin")
    fit_launches = {k: launches[k] - eval_launches[k] for k in launches}
    print(f"composed: kernel launches during the fit {json.dumps(fit_launches)}"
          f" (per step " + json.dumps({k: v / TRAIN_STEPS for k, v in
                                       fit_launches.items()})
          + f"); during the eval {json.dumps(eval_launches)} (per eval batch "
          + json.dumps({k: v / (COMPOSED_EVAL // TRAIN_BATCH)
                        for k, v in eval_launches.items()}) + ")")
    for name in launches:
        _check(fit_launches[name] > 0,
               f"{name} kernel was not launched during the composed fit")
    for name in ("group_norm", "flash_attention"):
        _check(eval_launches[name] > 0,
               f"{name} kernel was not launched during the eval")
    return launches


def _fp32_unet_phase(card: str) -> None:
    """`encode_latents_in_fp16: false`: the fp32 full-width UNet's
    attention runs on plain math on the card (the flash kernels take bf16
    with head dim 64 only), and its output agrees with the same weights on
    the CPU."""
    import copy

    import torch

    from diffusion_torch.models.models import stable_diffusion_2
    from diffusion_torch.ops import flash_attention as fa
    from diffusion_torch.ops import groupnorm as gn

    model = stable_diffusion_2(precomputed_latents=True,
                               encode_latents_in_fp16=False, device=DEVICE,
                               seed=0)
    gen = torch.Generator().manual_seed(7)
    side = TRAIN_SIZE // 8
    lat = torch.randn((1, 4, side, side), generator=gen).contiguous(
        memory_format=torch.channels_last)
    t = torch.tensor([500])
    ctx = torch.randn((1, 77, 1024), generator=gen)
    fa.launches.reset()
    gn.launches.reset()
    with torch.inference_mode():
        got = model.unet(lat.to(DEVICE), t.to(DEVICE), ctx.to(DEVICE))
        torch.cuda.synchronize()
        flash, norm = fa.launches.value, gn.launches.value
        ref = copy.deepcopy(model.unet).to("cpu")
        want = ref(lat, t, ctx)
    err = _rel_l2(got, want)
    finite = bool(torch.isfinite(got).all())
    print(f"fp32 UNet: encode_latents_in_fp16=false, compute "
          f"{model.unet.dtype}, {TRAIN_SIZE}px batch 1 forward on the card: "
          f"{tuple(got.shape)}, finite {finite}, flash launches {flash}, "
          f"GroupNorm launches {norm}; against fp32 on the CPU relative L2 "
          f"error {err:.3e} (bound 1e-3) [{card}]")
    _check(finite and flash == 0 and norm > 0 and err <= 1e-3,
           "the fp32 UNet did not run its attention on plain math, or "
           "disagrees with the CPU")


_CATEGORIES = (   # kernel-name patterns, first match wins
    # this tree's gn_fwd_kernel / gn_bwd_kernel, and the parent's kernels
    ("GroupNorm kernels", ("gn_fwd", "gn_bwd", "gn_partial", "gn_merge",
                           "gn_apply")),
    ("flash kernels", ("flash_",)),
    ("optimizer/EMA foreach", ("multi_tensor_apply", "foreach")),
    ("cuDNN convs", ("conv", "cudnn", "implicit", "dgrad", "wgrad",
                     "winograd", "xmma_fprop", "nhwc")),
    ("cuBLAS GEMMs", ("gemm", "cutlass", "xmma", "sm90_", "cublas",
                      "nvjet")),
    ("copies and casts", ("copy", "cat", "Copy")),
    ("reductions", ("reduce", "Reduce", "norm")),
)


def _device_profile(events, window: str, what: str, card: str) -> None:
    """Print the device's busy time (the union of kernel intervals), the
    idle share of the first-to-last kernel span, and device time by kernel
    category, for the kernels inside the profiler range named `window`
    (bracketed by synchronizations, so its kernels run inside it). Prints
    "not measured" where the profiler recorded no device events."""
    import torch
    steps = [e.time_range for e in events if e.name == window]
    # device activity: kernels, copies, memsets; not the GPU-side copies of
    # the profiler's own ranges (user annotations)
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("chip_smoke_")]
    lo, hi = (steps[0].start, steps[0].end) if steps else (0, -1)
    inside = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in kernels
                    if lo <= e.time_range.start and e.time_range.end <= hi)
    if not inside:
        print(f"profile: {what}: not measured (the profiler recorded no "
              f"device events) [{card}]")
        return
    busy, cur_s, cur_e = 0.0, None, None
    for s0, s1, _ in inside:
        if cur_e is None or s0 > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s0, s1
        else:
            cur_e = max(cur_e, s1)
    busy += cur_e - cur_s
    span = inside[-1][1] - inside[0][0]
    cats = {}
    for s0, s1, name in inside:
        cat = next((c for c, pats in _CATEGORIES
                    if any(p in name for p in pats)), "other elementwise")
        t, k = cats.get(cat, (0.0, 0))
        cats[cat] = (t + (s1 - s0), k + 1)
    print(f"profile: {what}: {len(inside)} kernels, device busy "
          f"{busy / 1e3:.2f} ms, first-to-last kernel span "
          f"{span / 1e3:.2f} ms, idle share {1 - busy / span:.3f}; host wall "
          f"time {(hi - lo) / 1e3:.2f} ms [{card}]")
    print(f"profile: {what}: device time by category (ms, kernels): "
          + "; ".join(f"{c} {t / 1e3:.2f} ({k})" for c, (t, k) in
                      sorted(cats.items(), key=lambda x: -x[1][0])))


def _profile_phase(model, batches, card: str) -> None:
    """Two more steps of the recipe under torch.profiler (CUDA activity);
    the device profile of the second step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from diffusion_torch.algorithms.ema import EMA
    from diffusion_torch.train.events import Callback
    from diffusion_torch.train.optim import adamw, multi_step_with_warmup
    from diffusion_torch.train.trainer import Trainer

    class Mark(Callback):
        """Brackets each step, synchronized, in a named profiler range."""

        def __init__(self):
            self.step, self.range = 0, None

        def batch_start(self, state, logger):
            torch.cuda.synchronize()
            self.range = torch.profiler.record_function(
                f"chip_smoke_step_{self.step}")
            self.range.__enter__()

        def batch_end(self, state, logger):
            torch.cuda.synchronize()
            self.range.__exit__(None, None, None)
            self.step += 1

    trainer = Trainer(
        model=model, train_dataloader=batches[:2],
        optimizers=adamw(lr=1e-4, weight_decay=0.01),
        schedulers=multi_step_with_warmup(t_warmup="10000ba",
                                          milestones=["200ep"]),
        algorithms=[EMA(smoothing=0.9999, ema_start="0ba")],
        callbacks=[Mark()], max_duration="2ba",
        device_train_microbatch_size=TRAIN_MICRO, seed=18, device=DEVICE)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.fit()
        torch.cuda.synchronize()
    _device_profile(prof.events(), "chip_smoke_step_1",
                    "training step (second of two, profiler on)", card)


def _profile_serving_step(unet, lat, t, ctx, card: str) -> None:
    """One more UNet CFG step under torch.profiler (CUDA activity),
    synchronized on both sides: its device profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function("chip_smoke_unet_step"):
                unet(lat, t, ctx)
                torch.cuda.synchronize()
    _device_profile(prof.events(), "chip_smoke_unet_step",
                    f"serving UNet CFG step (batch {lat.shape[0]}, {SIZE}px, "
                    f"profiler on)", card)


def _post(port: int, payload: dict, out: dict, key: str) -> None:
    from http.client import HTTPConnection
    t0 = time.perf_counter()
    conn = HTTPConnection("127.0.0.1", port, timeout=900)
    try:
        conn.request("POST", "/predict", body=json.dumps(payload),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        out[key] = (resp.status, json.loads(resp.read()),
                    time.perf_counter() - t0)
    finally:
        conn.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", metavar="DIR",
                    help="a tree of the parent commit (git archive), whose "
                         "flash dQ kernel is timed in turns with this one")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    from PIL import Image

    from diffusion_torch.inference.inference_model import \
        StableDiffusionInference
    from diffusion_torch.models.models import stable_diffusion_2
    from diffusion_torch.inference.serve import make_server
    from diffusion_torch.ops import _build
    from diffusion_torch.ops import flash_attention as fa
    from diffusion_torch.ops import groupnorm as gn

    # 1. device
    card = _card_line()
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {kind} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}); nvidia-smi: {card}")
    print(f"tf32: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    import PIL
    import yaml
    print(f"host: PyYAML {yaml.__version__} (the config loader), Pillow "
          f"{PIL.__version__} (JPEG decode), g++ {shutil.which('g++')} "
          f"(libdataio)")

    # 2. build (the parent's dQ kernel alongside, where a parent tree is
    # given)
    t0 = time.perf_counter()
    parent = _ParentDq(args.parent) if args.parent else None
    _build.library()
    if parent:
        parent.load()
    print(f"build: {time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}")
    with open(_build.build_log()) as f:
        usage = _ptxas_usage(f.read())
    for name, u in usage.items():
        print(f"ptxas: {name}: {u.get('registers')} registers, "
              f"{u.get('static_smem')} bytes static smem, spill stores "
              f"{u.get('spill_stores')} / loads {u.get('spill_loads')} bytes"
              + (f", wgmma serialized ({', '.join(u['wgmma_serialized'])})"
                 if "wgmma_serialized" in u else ""))
    for name in _NO_SPILL:
        u = usage.get(name)
        _check(u is not None and u.get("spill_stores") == 0
               and u.get("spill_loads") == 0,
               f"ptxas reports spills (or no entry) for {name}: {u}")
    _check("wgmma_serialized" not in usage["flash_bwd_dq_kernel"],
           "ptxas serialized the dQ kernel's wgmma pipeline")

    # 3. kernels against their plain versions
    kernels = _kernel_phase(card, parent)
    _unet_group_norm_phase(card)

    # 4. serve
    t0 = time.perf_counter()
    endpoint = StableDiffusionInference(default_size=SIZE,
                                        device="cuda:0", seed=0)
    model = endpoint.model
    n_unet = sum(p.numel() for p in model.unet.parameters())
    n_text = sum(p.numel() for p in model.text_encoder.parameters())
    print(f"serve: SD-2-base endpoint built in {time.perf_counter() - t0:.1f}"
          f" s: UNet {n_unet / 1e6:.1f}M, CLIP text {n_text / 1e6:.1f}M "
          f"params (fp32, bf16 compute), {SIZE}px")
    _reference_phase(model, card)
    decoded = []
    model.vae.post_quant_conv.register_forward_pre_hook(
        lambda mod, inp: decoded.append(
            (tuple(inp[0].shape), bool(torch.isfinite(inp[0]).all()))))
    # warm-up outside the counted run: cuDNN picks its algorithms per shape
    ids = torch.from_numpy(model.tokenizer(["warm up", "warm up"])["input_ids"])
    for n in (1, 2):
        model.generate(ids[:n], height=SIZE, width=SIZE,
                       num_inference_steps=1, seed=0)
    torch.cuda.synchronize()
    decoded.clear()

    server = make_server(endpoint, "127.0.0.1", 0, max_batch_size=2,
                         batch_wait_ms=500.0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    results: dict = {}
    try:
        gn.launches.reset()
        fa.launches.reset()
        common = {"guidance_scale": 7.5, "seed": 0, "height": SIZE,
                  "width": SIZE}
        pair = [threading.Thread(target=_post, args=(port, {
            "prompt": prompt, "num_inference_steps": STEPS, **common},
            results, key)) for key, prompt in (
                ("first", "a lighthouse on a cliff at dusk"),
                ("second", "a bowl of ramen, studio photo"))]
        for t in pair:
            t.start()
        for t in pair:
            t.join()
        _post(port, {"prompt": "an astronaut riding a horse",
                     "num_inference_steps": STEPS_THIRD, **common},
              results, "third")
        torch.cuda.synchronize()
        launches = {"group_norm": gn.launches.value,
                    "flash_attention": fa.launches.value}
        stats = server.batcher.snapshot()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)

    for key in ("first", "second", "third"):
        _check(key in results, f"request {key} got no response")
        status, body, seconds = results[key]
        _check(status == 200, f"request {key}: HTTP {status} {body}")
        _check(len(body["images"]) == 1, f"request {key}: one image expected")
        img = Image.open(io.BytesIO(base64.b64decode(body["images"][0])))
        img.load()
        _check(img.size == (SIZE, SIZE) and img.mode == "RGB",
               f"request {key}: PNG {img.size} {img.mode}")
        print(f"serve: request {key}: HTTP 200, {img.size[0]}x{img.size[1]} "
              f"PNG, {seconds:.3f} s end to end [{card}]")
    print(f"serve: batcher {json.dumps(stats)}")
    _check(stats["dispatches_total"] == 2,
           "the two concurrent requests were not merged into one dispatch")
    _check(len(decoded) == 2 and all(ok for _, ok in decoded),
           f"latents before the decode not finite: {decoded}")
    print(f"serve: latents before decode finite, shapes "
          f"{[s for s, _ in decoded]}")
    print(f"serve: kernel launches during serving {launches}")
    for name, n in launches.items():
        _check(n > 0, f"{name} kernel was not launched while serving")

    # 5. times
    unet = model.unet
    ctx = torch.randn((4, 77, 1024), device="cuda:0")
    for batch in (4, 2):
        lat = torch.randn((batch, 4, SIZE // 8, SIZE // 8),
                          device="cuda:0").contiguous(
                              memory_format=torch.channels_last)
        t = torch.full((batch,), 500, device="cuda:0", dtype=torch.int64)
        with torch.inference_mode():
            ms = _time_ms(lambda: unet(lat, t, ctx[:batch]), iters=5, warmup=2)
        print(f"times: UNet CFG step, batch {batch} ({batch // 2} prompt(s) "
              f"x 2), {SIZE}px: {ms:.2f} ms [{card}]")
        if batch == 4:       # profiled at the end, after every timed phase
            serve_inputs = (lat, t, ctx)
    print(f"times: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card}]")

    # 6-7. the training slice, on a model of its own: free the endpoint;
    # its UNet, whose CFG step is profiled last, waits on the CPU so the
    # training phase's peak memory is its own
    serve_unet = unet.to("cpu")
    del endpoint, model, unet, server
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_model = stable_diffusion_2(precomputed_latents=True, device=DEVICE,
                                     seed=0)
    _check(train_model.vae is None and train_model.unet.training,
           "the training builder built the frozen towers or froze the UNet")
    print(f"train: SD-2-base training model built in "
          f"{time.perf_counter() - t0:.1f} s (UNet only, trainable)")
    _grad_reference_phase(train_model, card)
    train_launches, train_step_s = _train_phase(train_model, card)
    del train_model
    gc.collect()
    torch.cuda.empty_cache()

    # 8-9. the composed run, and the fp32 UNet
    composed_launches = _composed_phase(card, train_step_s)
    gc.collect()
    torch.cuda.empty_cache()
    _fp32_unet_phase(card)
    gc.collect()
    torch.cuda.empty_cache()
    _profile_serving_step(serve_unet.to(DEVICE), *serve_inputs, card)

    summary = []
    for name, source, replaces in (
            ("group_norm", "diffusion_torch/csrc/group_norm.cu",
             "diffusion_tpu/ops/groupnorm.py:119"),
            ("group_norm_bwd", "diffusion_torch/csrc/group_norm.cu",
             "diffusion_tpu/ops/groupnorm.py:183"),
            ("flash_attention", "diffusion_torch/csrc/flash_attention.cu",
             "diffusion_tpu/ops/flash_attention.py:201"),
            ("flash_attention_bwd_dq",
             "diffusion_torch/csrc/flash_attention_bwd.cu",
             "diffusion_tpu/ops/flash_attention.py:243"),
            ("flash_attention_bwd_dkv",
             "diffusion_torch/csrc/flash_attention_bwd.cu",
             "diffusion_tpu/ops/flash_attention.py:268")):
        cases = kernels[name]
        # the first case is the main path's most frequent shape: serving's
        # for the forward kernels, 256px training's for the backward ones
        first = cases[0]
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": (launches.get(name, 0) + train_launches[name]
                         + composed_launches[name]),
            "max_abs_err": max(c["err"] for c in cases),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": first["library_ms"]})
    print(json.dumps({"kernels": summary}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
