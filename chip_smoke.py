#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (exit code 1):
  1. device: the card's name and power limit, the TF32 settings (both off);
  2. build: both CUDA kernels from diffusion_torch/csrc with nvcc;
  3. kernels: each kernel against its plain PyTorch version in bf16 at the
     serving path's shapes, with the max-abs error beside its bound, and
     each one's time beside the plain version's (CUDA events);
  4. serve: the full-width SD-2-base endpoint (random weights from a seed).
     Its UNet and VAE decoder first run against an fp32 CPU copy of
     themselves on a small input. Then, at 512px behind the port's HTTP
     server on localhost: two concurrent, mergeable requests and a third
     with another step count; HTTP 200, decodable 512x512 PNGs, finite
     latents before the decode, and both kernels' launch counters above
     zero for that run;
  5. times: one UNet CFG step and each request's latency.

The last three lines are the kernels' JSON summary, the card's name and
power limit as nvidia-smi reports them, and {"ok": true, "device": ...}.
Exits with code 2, printing no result, when no CUDA device is present.
"""

from __future__ import annotations

import base64
import io
import json
import subprocess
import sys
import threading
import time

SIZE = 512          # the server's default size (JAX serve.py:206)
STEPS = 20          # the two merged requests
STEPS_THIRD = 10    # the third request, which cannot merge with them


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


def _kernel_phase(card: str):
    import torch

    from diffusion_torch.ops import flash_attention as fa
    from diffusion_torch.ops import groupnorm as gn

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    results = {"group_norm": [], "flash_attention": []}
    for shape, act in (((2, 4096, 320), "silu"), ((2, 1024, 640), None),
                       ((1, 262144, 128), "silu")):
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
        ms = _time_ms(lambda: gn.group_norm_cuda(x, scale, bias, 32, 1e-5, act))
        plain = _time_ms(lambda: gn.group_norm_reference(x, scale, bias, 32,
                                                         1e-5, act))
        print(f"kernel group_norm x{shape} bf16 act={act}: max_abs_err "
              f"{err:.3e} (bound {bound:.3e}), stats err {stat_err:.3e} "
              f"(bound 1e-4); {ms:.4f} ms vs plain {plain:.4f} ms [{card}]")
        _check(err <= bound and stat_err <= 1e-4,
               f"group_norm disagrees with its plain version at {shape}")
        results["group_norm"].append((err, ms, plain))

    for shape in ((2, 4096, 5, 64), (2, 1024, 10, 64)):
        q, k, v = randn(*shape), randn(*shape), randn(*shape)
        out, lse = fa.flash_attention_cuda(q, k, v)
        ref_out, ref_lse = fa.flash_attention_reference(q, k, v)
        err = (out.float() - ref_out.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        # p is cast to bf16 against the running max in the kernel, against
        # the final lse in the plain version: ~2**-8 relative on each term
        ms = _time_ms(lambda: fa.flash_attention_cuda(q, k, v))
        plain = _time_ms(lambda: fa.flash_attention_reference(q, k, v), 5, 1)
        print(f"kernel flash_attention q/k/v{shape} bf16: out max_abs_err "
              f"{err:.3e} (bound 2e-2), lse max_abs_err {lse_err:.3e} "
              f"(bound 1e-3); {ms:.4f} ms vs plain {plain:.4f} ms [{card}]")
        _check(err <= 2e-2 and lse_err <= 1e-3,
               f"flash_attention disagrees with its plain version at {shape}")
        results["flash_attention"].append((err, ms, plain))
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    from PIL import Image

    from diffusion_torch.inference.inference_model import \
        StableDiffusionInference
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

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}")
    with open(_build.build_log()) as f:
        usage = [line.strip() for line in f if "Used" in line or "spill" in line]
    print("ptxas: " + " | ".join(usage))

    # 3. kernels against their plain versions
    kernels = _kernel_phase(card)

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
    print(f"times: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card}]")

    summary = []
    for name, source, replaces in (
            ("group_norm", "diffusion_torch/csrc/group_norm.cu",
             "diffusion_tpu/ops/groupnorm.py:119"),
            ("flash_attention", "diffusion_torch/csrc/flash_attention.cu",
             "diffusion_tpu/ops/flash_attention.py:201")):
        cases = kernels[name]
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(c[0] for c in cases),
            # the first case is the serving path's most frequent shape
            "ms": cases[0][1], "plain_ms": cases[0][2]})
    print(json.dumps({"kernels": summary}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
