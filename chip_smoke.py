#!/usr/bin/env python3
"""Drive the port's serving, training and eval paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (exit code 1):
  1. device: the card's name and power limit, the TF32 settings (both off),
     the host's PyYAML and Pillow versions;
  2. build: the CUDA kernels from diffusion_torch/csrc with one nvcc call;
     each kernel's ptxas registers, shared memory and spills, with no
     spills allowed in the wgmma kernels (flash forward, dQ and dK/dV);
  3. kernels: each of the five kernels (GroupNorm forward and backward,
     flash-attention forward, dQ and dK/dV) against its plain PyTorch
     version in bf16 at the main paths' shapes, with the max-abs error
     beside its bound, and each one's time beside the plain version's, the
     library call's for the same function (timed only, never used by the
     port) and the card's bound for the work (`portbench.flops.bound_s`;
     CUDA events), the device time alone (launches replayed from a CUDA
     graph) and the wrapper's host time per call;
     for the flash kernels also TFLOP/s, and dQ + dK/dV beside SDPA's
     flash backward in a CUDA graph (the backward at 256px batch 16 and
     at 512px batch 4 and 8, the 512 recipe's microbatch). The three flash
     kernels also at the MMDiT's joint attention at 1,024px, (2, 4250, 24,
     64), and at 4,096 queries against its 4,250 keys: the tail instances,
     whose launch counters must read 1 a call there and 0 at whole tiles,
     with the bound at the true lengths. The GroupNorm
     forward also at the
     VAE encoder's largest slabs (256px, microbatch 16). Then all 61
     GroupNorm calls of one UNet forward (256px batch 16, 512px batch 4)
     and backward (256px batch 16), and all 22 of one VAE encode (256px
     batch 16, 512px batch 1), each set replayed from one CUDA graph,
     beside its summed byte bound;
 3b. the fused AdamW (+ EMA) kernel against the plain version's foreach
     passes over the SD2 UNet's 865.9M trainable values (with and without
     the EMA) and the MMDiT's 2.03B: p, mu, nu and e bit-equal after one
     update from the same state, the kernel's time beside its byte bound
     and the foreach passes' time,
     and its bandwidth;
 3c. the working copies' two kernels over the same two weight sets: the
     bf16 copy's pass bit-equal to `.to(torch.bfloat16)`, the gradients'
     pass storing and adding bit-equal to the cast and AccumulateGrad,
     each timed beside its byte bound (6 bytes a value; 6 and 10);
  4. serve: the full-width SD-2-base endpoint (random weights from a seed).
     Its UNet, VAE decoder and VAE encoder (posterior mean and logvar of a
     64x64 image) first run against an fp32 CPU copy of themselves on a
     small input. Then, at 512px behind the port's HTTP
     server on localhost: two concurrent, mergeable requests and a third
     with another step count; HTTP 200, decodable 512x512 PNGs, finite
     latents before the decode, and both forward kernels' launch counters
     above zero for that run;
  5. times: one UNet CFG step and each request's latency (one more CFG
     step at batch 4 runs under torch.profiler at the very end, after every
     timed phase: the device's busy time, idle share and time by kernel
     category, read by `portbench.trace.read_trace`, so the idle share is
     over the profiled window's wall time, as the benchmark's);
 5b. img2img and inpainting on the same endpoint: one VAE encode's
     GroupNorm calls (all 22 through the kernel's wrapper) and the
     encode's time at 512px batch 2 and 256px batch 16 (CUDA events);
     then, one at a time over HTTP, a 20-step text-to-image request, an
     img2img request (strength 0.5: 10 steps run) and an inpainting
     request (a left-half-white mask, strength 0.8: 16 steps): HTTP 200,
     512x512 PNGs, each latency beside phase 4's, and launch counts that
     are the text request's less the steps not run plus the encoder's 22
     GroupNorm calls; then through `generate` on the card with the same
     draws, an all-ones mask must give the img2img output and an all-zeros
     mask the VAE reconstruction decode(lat0), both bit for bit;
 5c. samplers over HTTP on the same endpoint, one at a time: 20-step
     requests with `scheduler: dpm++2m`, `scheduler: euler`, DDIM with
     `guidance_rescale: 0.7`, and a dpm++2m img2img request (strength
     0.5): HTTP 200, 512x512 PNGs, finite latents before the decode, each
     latency beside phase 5b's 20-step DDIM text request, and launch
     counts equal to that request's (a sampler changes no UNet work; the
     img2img request's are its less the 10 steps not run plus the
     encoder's 22 GroupNorm calls);
  6. gradient reference: the full-width training UNet's loss and gradient
     at 256px, batch 2, on the card (bf16, kernels) against the same
     weights in fp32 on the CPU (plain versions), with the three backward
     kernels' launch counters above zero;
  7. train: `Trainer.fit()` for 6 steps of the SD-2-base-256 recipe on
     precomputed latents (AdamW 1e-4, weight decay 0.01, 10000-batch
     warmup, global batch 32 in two microbatches of 16) with the 512
     recipe's EMA (0.9999, from batch 0): finite losses and grad norms,
     changed params and EMA, all five kernels' launch counters above zero
     for the fit; step 0 eager (the warm-up), step 1 capturing the step's
     CUDA graph, steps 2-5 replaying it (`utils.profiler.step_graph`);
     the replayed steps' time, samples/s, peak memory, launches per step
     (every step's, a replay's being its captured nodes);
  8. composed run: the unedited yamls/SD-2-base-256.yaml composed through
     diffusion_torch's config loader with dotted overrides only (global
     batch 32, the LAION reader over precomputed-latent MDS shards that the
     port's MDSWriter writes from a numpy seed, 256 training samples; the
     recipe's own COCO eval reader over 64 COCO samples, JPEGs and caption
     lists in MDS shards, so `model.init_frozen_towers=true`; 6 batches,
     eval every 3) and run by `diffusion_torch.train.train.train(config)`:
     finite losses and grad norms, exactly one eval (after batch 3) with a
     finite MSE, all five kernels launched during the fit and both forward
     kernels during the eval; step time and samples/s beside phase 7's,
     the wait on the dataloader per step, the eval's MSE and wall time,
     peak memory, and which libdataio path ran;
 8b. online-encode run: the unedited yamls/SD-2-base-256-wds.yaml (raw
     images, no precomputed latents) with dotted overrides only (global
     batch 32 in microbatches of 16; `meta_json` manifests of webdataset
     tar shards written from a numpy seed, 256 training and 64 eval
     samples, JPEGs of four non-square sizes with .txt captions and .json
     metadata; a `filter_strategy` file that drops punsafe > 0.5, set on
     every 8th training sample; 6 batches, eval every 3) through
     `train(config)`: finite losses and grad norms, one eval with a finite
     MSE, the filter dropped exactly the flagged samples, all five kernels
     launched during the fit, the frozen VAE and CLIP parameters
     bit-unchanged and without gradients; step time, samples/s, the
     towers' encode share of the step (CUDA events), the loader wait and
     peak memory beside phase 8's;
  9. fp32 UNet: `encode_latents_in_fp16: false` builds an fp32 full-width
     UNet; one 256px batch-1 forward on the card runs its attention on
     plain math (the flash counter stays 0) and agrees with the same
     weights on the CPU;
 10. checkpoint: first the free disk space under build/, which must hold
     the phase's peak (two fp32 checkpoints of params, mu and nu, about
     10.4 GB each, and a 2.5 GB fp16 pretrained directory; it fails,
     naming the need, when it is short), in a temporary directory there
     that is deleted at the end. Phase 8's composed run again, plus
     `trainer.save_folder`, `save_interval=3ba` and
     `save_num_checkpoints_to_keep=1`: run 1 gets a SIGTERM after batch
     3 (a `Preempt` callback) and must leave fit() with ba3 saved (async:
     pinned host buffer, then a writer thread); run 2 adds
     `trainer.autoresume=true`, and a `ResumeCheck` callback holds the
     restored parameters, moments, count, step and timestamp against run
     1's live trainer with torch.equal before any step; run 2's batches
     4-6 must be within 1e-3 (relative) of phase 8's losses and grad
     norms, with a line saying whether they are bit-equal (and, if not,
     which backward ops are not deterministic); ba6 must be complete and
     ba3 pruned. Then a step right after an async save beside one
     without, and the restore's time alone. Last, a full-width fp16
     diffusers directory (unet/, vae/ with its encoder, text_encoder/) written
     from seeded random modules by the port's safetensors writer; the
     endpoint built from it with `pretrained=True` and
     `checkpoint_path=ba6` must hold ba6's UNet and the fp16 towers in
     fp32 exactly, and serve one 512px request over HTTP (200, a 512x512
     PNG, finite latents, GroupNorm and flash launches). Sizes, copy,
     write and restore times and rates, the request's latency and the
     free disk space are printed with the card's name and power limit.
 11. eval job: the full-width InceptionV3 and CLIP ViT-L/14 towers (random
     weights, seed 0) against fp32 CPU copies of themselves on 2 images
     (features, logits, image and text embeddings; relative L2 within
     1e-3, TF32 off), and their times on 32 256px images; then the port's
     `diffusion_torch.scripts.fid_clip_evaluation.main` (yamls/eval.yaml's
     job) at full width with `--allow_random_towers` over 64 COCO samples
     in MDS shards (phase 8's writer): 256px, 2 batches of 16, guidance
     3.0, dpm++2m at 20 steps. It must give a finite
     `FrechetInceptionDistance-scale-3p0` and `CLIPScore-scale-3p0` in its
     results and its `--out` jsonl, ten 256px images from
     `LogDiffusionImages`, and GroupNorm and flash launches; its wall time,
     generation time per batch, the host's FID compute() and peak memory
     are printed. Then `coco_eval.main` at guidance 1.0 and 7.0 (one batch,
     10 DDIM steps): both scales' FID and CLIPScore finite;
 12. LoRA: a full-width fp16 diffusers directory (phase 10's writer) and
     256 raw JPEG + caption samples in MDS shards (and 64 COCO samples);
     the unedited yamls/SD-2-base-256-lora.yaml (rank 8, adapters only)
     with dotted overrides (global batch 32 in microbatches of 16,
     `model.pretrained=true` over the directory, 6 batches, an eval on
     COCO and a save after batches 3 and 6) through `train(config)`: the
     trainable parameter count, the base bit-unchanged and the adapters
     changed (a `LoraRecord` callback), step 1's loss beside the
     pretrained rank-0 model's on the same batch and draws (bound 1e-3),
     step time, samples/s and peak memory beside phase 8b's, the
     checkpoint's size and save, launches; then an endpoint with
     `lora_rank=8` over the directory and the adapter checkpoint serves
     one 512px 20-step request over HTTP; then the adapter folded into a
     rank-0 UNet against the adapter UNet for one CFG step (bf16,
     relative L2 within 1e-2), trained and with B redrawn;
 13. readers: a Pexels JSON manifest (160 JPEG records of four sizes,
     every 32nd also naming a missing file) with the unedited
     yamls/SD-2-base-256-pexels.yaml, `trainer.log_traces=true` and a
     `TorchProfiler(start_batch=1, num_batches=2)` callback (the trace's
     size and CUDA kernel events); then the unedited
     yamls/SD-2-base-256-mixdata.yaml over that manifest and three tar
     shard sources (phase 8b's writer) with an eval on COCO, and the
     samples drawn per source beside the normalized weights; global
     batch 32 in microbatches of 16, 4 batches each; loader wait and step
     time;
 14. pixel diffusion: `discrete_pixel_diffusion` and
     `continuous_pixel_diffusion` at full width (SD2's UNet widths, 3
     channels, the CLIP ViT-L/14 text tower), 64x64 pixels: 3 steps of
     batch 16 in microbatches of 8 through `Trainer.fit()`, then 2
     prompts at 20 steps under DDIM, the SDE and the ODE: step time, peak
     memory, each request's latency, launches, the flash calls at S =
     4096, finite images in [0, 1];
 15. the main recipe end to end: a full-width fp16 pretrained directory
     (phase 10's writer), 128 raw JPEG + caption samples in MDS shards
     (every short side >= 512, the bucket the recipe precomputes) and a
     COCO captions json with 16 JPEGs; `python -m
     diffusion_torch.scripts.convert_coco` makes the eval MDS; `python -m
     diffusion_torch.scripts.precompute_latents --sizes 256 512
     --model-name <the directory>` in a subprocess writes the latent
     shards (its wall time and images/s, GroupNorm launches, output bytes,
     no cached input shard left); in this process the job's encode at
     batch 32 per size (CUDA events) and its GroupNorm calls per encode,
     then two written samples' `latents_256` and `caption_latents`
     against an fp32 CPU encode with the same weights and eps (relative L2
     within 5e-2). Then the unedited yamls/SD-2-base-256.yaml for 3
     batches of 32 on the job's shards with a save after the last, and
     the unedited yamls/SD-2-base-512.yaml warm-started from that
     checkpoint (`trainer.load_path`; the yaml's `load_weights_only`):
     global batch 16 in the yaml's microbatches of 8, 4 batches, the
     yaml's COCO eval (batch 8) after batch 2. The 512 yaml's precomputed
     latents and `val_guidance_scales: []` build no VAE, so its raw COCO
     eval needs `+model.init_frozen_towers=true` (reference fault 9, as
     for the 256 yaml). Before step 1 the UNet equals the saved parameters
     bit for bit, Adam's count and moments are fresh, the clock is at 0
     and the EMA equals the loaded weights; the EMA equals the weights
     after every step (`ema_start: 800000ba`); finite losses, grad norms
     and eval MSE; all five kernels launched in both fits, a flash call
     at (8, 4096, 5, 64); step time, samples/s, data wait, peak memory,
     the weights-only load time, the eval's wall time and launches per
     step;
 16. remat and the process mesh: (a) the unedited
     yamls/SD-2-base-1024-sp.yaml (remat on, online VAE encode) through
     `diffusion_torch.run.main` under a one-rank NCCL process group (the
     launch code a torchrun rank runs), with dotted overrides only
     (`trainer.mesh_config.data=1 trainer.mesh_config.sp=1`, global batch 8
     in the yaml's microbatches of 4, 4 batches, 64 seeded 1024px JPEG +
     caption samples in MDS shards, the yaml's COCO eval over 8 images
     after batch 2), then again with `model.remat=false`: per run its
     steps, samples/s, peak memory, the flash launches at (4, 16384, 5,
     64) and the GroupNorm launches per step, and what remat costs in time
     and saves in memory; (b) one 256px step of the full-width UNet under
     FSDP2 (`fully_shard` on the one-rank mesh) against the plain step:
     the parameters after it; then, on the same one-rank NCCL group, the
     dispatcher ops the Trainer calls under sp, `group_norm(shard=)` (its
     stages around an NCCL all-gather of the partials) and
     `ring_attention`, forward and backward, against the stage kernels and
     the whole-tensor kernels; (c) ring attention's per-step body over 4
     local shards of (2, 16384, 5, 64) bf16, forward and backward through
     the flash kernels, against the whole-sequence kernels, and the sp
     GroupNorm stages (SiLU) over 4 row shards of (4, 16384, 320), forward
     and backward, against the one-call kernels and each shard's dx
     against the plain fp32 stages (a cotangent whose per-group sums are
     of order 1 and differ between shards; a control that feeds stage 2
     only its own shard's sums must miss the bound), with the times beside
     the whole-tensor calls; (d) with one card, one line saying that the
     ranks' transport ran on the CPU (the tests) only;
 17. Megatron tensor parallelism: (a) the unedited
     yamls/SD-2-base-512-tp.yaml through `diffusion_torch.run.main` with
     dotted overrides only (`trainer.mesh_config.fsdp=1
     trainer.mesh_config.data=1`, so the yaml's tp 2 stays; global batch
     16 in the yaml's microbatches of 8, 3 batches over 48 seeded 512px
     latent MDS samples, no eval), first with `trainer.mesh_config.tp=1`
     in this process as the reference, then as two tp ranks: this script
     started again twice (`--tp-rank`), each process joining a gloo group
     over the two and keeping `cuda:0`. Each rank's losses and grad norms
     against the reference's (1e-4 and 1e-3 relative), its first step's
     gradients against the reference's sliced as the rank holds them
     (relative L2 5e-2 a tensor, 1e-2 whole: a few times what the card
     measured) and against the reference's first step replayed on the
     UNet's one-process tp twin (`tp_local_twin`; phase 16(b)'s
     elementwise bound), the whole (unsliced) parameters, moments and EMA
     bit-equal on both ranks after the run (`tp_replicas_differ`), its
     flash calls a microbatch ((8, 4096, 5, 64) whole, (8, 1024, 5, 64)
     head-sharded: 5 each), its GroupNorm launches a step (the
     reference's), its UNet parameter count, device memory and step times
     (two processes on one card: not a tp speed); then a control, one
     batch with a planted fault (`tp_copy`'s backward not summing), which
     must miss the grad-norm, gradient and replica checks; where gloo
     refuses a CUDA tensor, that error in one line; (b)
     `tp_copy` and `tp_reduce` forward and backward on a one-rank NCCL
     group; (c) a Transformer2D of the 10-head level (640 channels, 1024
     tokens) and of the 5-head level (320, 4096; attention gated whole,
     GEGLU sharded), batch 8, as 2 tp shards in this process
     (`tp_local_twin`) against the whole block through the kernels:
     output, dx and every parameter's gradient within bf16 bounds, the
     flash calls' shapes, the times; (d) one line saying where tp ranks
     have run.
 18. The FLOP count and MFU (run right after phase 7, on its model): (a)
     one 256px loss-and-grad microbatch of 16 and one 512px CFG UNet step
     at batch 4 counted on the card by `utils/flops.py` (dot, conv, flash);
     the flash class must equal the three flash wrappers' launches times
     their formulas (2 / 3 / 4 units at each launch's shapes), and the
     launch counters the wrappers' calls; the same model built on the
     meta device (shapes only) and routed as the card must count the same
     in every class, and routed as the CPU the same conv and dot + 6/9 of
     the flash class (2/2 forward only); (b) `flops_per_batch` of the recipe's batch of 32
     and the MFU of phase 7's step and of phase 5's CFG step against
     `device_peak_flops()`; (c) the unedited yamls/SD-2-base-256.yaml
     through `train(config)` on phase 8's shards, 3 batches, with
     `callbacks.speed_monitor.flops_per_batch` from (a):
     `throughput/device/mfu` must be logged and lie in (0, 1); (d)
     `enable_compile_cache` on one fresh directory in two child
     processes: the first runs nvcc into it (while (c) trains), the
     second loads the library without nvcc.

The last three lines are the kernels' JSON summary, the card's name and
power limit as nvidia-smi reports them, and {"ok": true, "device": ...}.
Exits with code 2, printing no result, when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
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
ONLINE_TRAIN, ONLINE_EVAL = 256, 64       # wds samples of the online run
ONLINE_FLAG_EVERY = 8                     # every 8th flagged unsafe
IMG2IMG_STRENGTH, INPAINT_STRENGTH = 0.5, 0.8
# phase 5c: (name, request fields) of the four sampler requests
SAMPLER_REQUESTS = (("dpm++2m", {"scheduler": "dpm++2m"}),
                    ("euler", {"scheduler": "euler"}),
                    ("ddim rescaled", {"guidance_rescale": 0.7}),
                    ("dpm++2m img2img", {"scheduler": "dpm++2m",
                                         "strength": IMG2IMG_STRENGTH}))
DEVICE = "cuda:0"
_ROOT = os.path.dirname(os.path.abspath(__file__))


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


def _least_ms(flops: float, nbytes: float):
    """(ms, what bounds it): the benchmark's `bound_s`, and which of the
    two terms it compares, the operations' or the bytes', is the larger."""
    from portbench.flops import bound_s
    by = "operations" if bound_s(flops, 0) > bound_s(0, nbytes) else "bytes"
    return bound_s(flops, nbytes) * 1e3, by


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


def _instances(usage: dict, name: str) -> dict:
    """The entries of `_ptxas_usage` for kernel `name`: the plain kernel,
    or each instance of a template (`name` plus mangled arguments)."""
    return {k: u for k, u in usage.items()
            if k == name or k.startswith(name + "I")}


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
    backward calls of the microbatch; then the 22 calls of one VAE encode
    of a 256px microbatch (batch 16) and of a 512px image, with their
    kernel launches (the plans'). Each total beside its summed byte bound
    (x read once and y written once; x and g read once and dx written
    once), and each forward set beside the same calls through
    `F.group_norm` + `F.silu` in one CUDA graph (the library, timed only).
    Returns {what: (ms, bound_ms)}."""
    import torch

    from diffusion_torch.models.unet import SD2_BASE_UNET, group_norm_shapes
    from diffusion_torch.models.vae import SD2_VAE, encoder_group_norm_shapes
    from diffusion_torch.ops import groupnorm as gn
    from portbench.flops import bound_s

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(4)
    out = {}
    for what, shapes, backward in (
            ("unet 256px microbatch (batch 16) forward",
             group_norm_shapes(SD2_BASE_UNET, 16, 32), False),
            ("unet 512px CFG step (batch 4) forward",
             group_norm_shapes(SD2_BASE_UNET, 4, 64), False),
            ("unet 256px microbatch (batch 16) backward",
             group_norm_shapes(SD2_BASE_UNET, 16, 32), True),
            ("vae encoder 256px microbatch (batch 16) forward",
             encoder_group_norm_shapes(SD2_VAE, 16, 256, 256), False),
            ("vae encoder 512px (batch 1) forward",
             encoder_group_norm_shapes(SD2_VAE, 1, 512, 512), False)):
        calls = []
        for shape, groups, act in shapes:
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
        bound = bound_s(0, nbytes) * 1e3

        def ours():
            for x, g, scale, bias, mean, rstd, act in calls:
                if backward:
                    gn.group_norm_bwd_cuda(x, scale, bias, mean, rstd, g, 32,
                                           act)
                else:
                    gn.group_norm_cuda(x, scale, bias, 32, 1e-5, act)

        ms = _graph_ms(ours)
        kernels = sum(gn.plan(*shape, groups, 2, backward).launches
                      for shape, groups, _ in shapes)
        library = ""
        if not backward:
            # the same calls through F.group_norm + F.silu, timed only
            lib_ms = _graph_ms(lambda: [
                _gn_library(x, scale, bias, act)
                for x, _, scale, bias, _, _, act in calls])
            library = (f"; F.group_norm + F.silu in a CUDA graph "
                       f"{lib_ms:.4f} ms")
        print(f"kernel group_norm {what}: {len(calls)} calls ({kernels} "
              f"kernel launches) in a CUDA graph {ms:.4f} ms{library}; "
              f"summed byte bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB) "
              f"[{card}]")
        out[what] = (ms, bound)
        del calls
    return out


def _adamw_case(shapes, seed: int, ema: bool):
    """Fresh optimizer state over parameters of `shapes` on the card, each
    its own allocation as a model's are: p, g, mu, nu (and e) fp32, nu and
    e as an Adam state and an EMA tracking the weights hold them."""
    import torch
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(scale=1.0):
        return [torch.randn(s, generator=gen, device=dev).mul_(scale)
                for s in shapes]

    p, g, mu, nu = draw(), draw(1e-2), draw(1e-3), draw(1e-3)
    for v in nu:
        v.square_()
    e = None
    if ema:
        e = draw(1e-2)
        for a, b in zip(e, p):
            a.add_(b)
    return p, g, mu, nu, e


def _adamw_phase(card: str) -> dict:
    """The fused AdamW (+ EMA) kernel (`ops/adamw.py::adamw_cuda`) against
    the plain version's foreach passes (`adamw_reference`) over the SD2
    UNet's 865.9M trainable values, with and without the EMA, and the
    MMDiT's 2.03B (shapes from the models built on the meta device): one
    update from the same state on each side (p, mu, nu and e must be
    bit-equal), then each
    timed with CUDA events (5 updates after one), beside the bound (28
    bytes a parameter, 36 with the EMA, over 3.35 TB/s), the achieved
    bandwidth and the wrapper's host time a call (checks, pointers,
    launches). Returns {what: (ms, bound_ms, foreach_ms)}."""
    import torch

    from diffusion_torch.models.models import (stable_diffusion_2,
                                               stable_diffusion_3)
    from diffusion_torch.ops import adamw as ka
    from diffusion_torch.train.optim import _bias_correction
    from portbench.flops import PEAK_BYTES_PER_S, bound_s

    gc.collect()
    torch.cuda.empty_cache()
    lists = {}
    for name, build in (("sd2 unet", lambda: stable_diffusion_2(
            precomputed_latents=True, device="meta")),
            ("sd3 mmdit", lambda: stable_diffusion_3(device="meta"))):
        lists[name] = [tuple(q.shape) for q in build().unet.parameters()
                       if q.requires_grad]
    kw = dict(lr=1e-4, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
              bc1=_bias_correction(0.9, 1000),
              bc2=_bias_correction(0.999, 1000), smoothing=0.9999)
    out = {}
    for what, shapes, ema in (("sd2 unet", lists["sd2 unet"], False),
                              ("sd2 unet + ema", lists["sd2 unet"], True),
                              ("sd3 mmdit", lists["sd3 mmdit"], False)):
        n = sum(math.prod(s) for s in shapes)
        p, g, mu, nu, e = _adamw_case(shapes, 7, ema)
        # the plain side's copy shares g, which neither side writes
        ref = [[t.clone() for t in ts] for ts in (p, mu, nu)] + [
            [t.clone() for t in e] if ema else None]
        before = ka.launches.value
        ka.adamw_cuda(p, g, mu, nu, e, **kw)
        launched = ka.launches.value - before
        ka.adamw_reference(ref[0], g, ref[1], ref[2], ref[3], **kw)
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for got, want in zip(
            (p, mu, nu, e or ()), (*ref[:3], ref[3] or ()))
            for a, b in zip(got, want))
        _check(equal, f"adamw kernel ({what}): p, mu, nu or e differ from "
                      f"the foreach passes")
        ms = _time_ms(lambda: ka.adamw_cuda(p, g, mu, nu, e, **kw),
                      iters=5, warmup=1)
        foreach_ms = _time_ms(lambda: ka.adamw_reference(
            ref[0], g, ref[1], ref[2], ref[3], **kw), iters=5, warmup=1)
        host_us = _host_us(lambda: ka.adamw_cuda(p, g, mu, nu, e, **kw),
                           iters=5)
        nbytes = (36 if ema else 28) * n
        bound = bound_s(0, nbytes) * 1e3
        print(f"kernel adamw_ema_foreach {what}: {n / 1e6:.1f}M values in "
              f"{len(shapes)} tensors, {launched} launches; p/mu/nu"
              f"{'/e' if ema else ''} bit-equal to the foreach passes "
              f"{equal}; kernel {ms:.4f} ms, bound {bound:.4f} ms "
              f"({nbytes / 1e9:.2f} GB), {nbytes / ms / 1e9:.3f} TB/s "
              f"({100 * nbytes / ms * 1e3 / PEAK_BYTES_PER_S:.1f}% of 3.35); "
              f"foreach passes {foreach_ms:.4f} ms; the wrapper's host "
              f"time {host_us:.0f} us a call [{card}]")
        out[what] = (ms, bound, foreach_ms)
        del p, g, mu, nu, e, ref
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _working_copy_phase(card: str) -> dict:
    """The working copies' two kernels (`ops/working_copy.py`) over the
    trained `Linear` / `Conv2d` weights of the SD2 UNet (865.9M values) and
    the MMDiT (2.03B), shapes from the models built on the meta device:
    the copy's pass (`refresh_cuda`, 6 bytes a value; kh x kw
    convolutions' copies in channels_last order) against
    `.to(torch.bfloat16)`, and the gradients' pass (`accumulate_cuda`, one
    launch a tensor; 3x3 and larger kernels' gradients in channels_last
    order, as cuDNN gives them) storing a first microbatch's gradient (6
    bytes a value) and adding a second (10), each against autograd's cast
    and add, bit for bit; then each timed (the gradients' pass in a CUDA
    graph: its host time per launch exceeds a small tensor's kernel)
    beside its bound. Returns {what: (ms, bound_ms)}."""
    import torch

    from diffusion_torch.models.models import (stable_diffusion_2,
                                               stable_diffusion_3)
    from diffusion_torch.ops import working_copy as wc
    from portbench.flops import PEAK_BYTES_PER_S, bound_s

    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device(DEVICE)
    out = {}
    for what, build in (("sd2 unet", lambda: stable_diffusion_2(
            precomputed_latents=True, device="meta")),
            ("sd3 mmdit", lambda: stable_diffusion_3(device="meta"))):
        shapes = [tuple(p.shape) for m in build().unet.modules()
                  if getattr(m, "casts_weights", False)
                  for p in (m.weight, m.bias)
                  if p is not None and p.requires_grad]
        n = sum(math.prod(s) for s in shapes)
        gen = torch.Generator(device=dev).manual_seed(11)
        params = [torch.randn(s, generator=gen, device=dev) for s in shapes]
        # a kh x kw convolution's copy in channels_last order, as training
        # makes it
        copies = [wc._view(torch.empty(p.numel(), dtype=torch.bfloat16,
                                       device=dev), p) for p in params]
        tiled = sum(not c.is_contiguous() for c in copies)
        before = wc.refreshes.value
        wc.refresh_cuda(params, copies)
        launched = wc.refreshes.value - before
        torch.cuda.synchronize()
        equal = all(torch.equal(c, p.to(torch.bfloat16))
                    for c, p in zip(copies, params))
        _check(equal, f"working copy kernel ({what}): a copy differs from "
                      f".to(torch.bfloat16)")
        ms = _time_ms(lambda: wc.refresh_cuda(params, copies), iters=5,
                      warmup=1)
        host_us = _host_us(lambda: wc.refresh_cuda(params, copies), iters=5)
        bound = bound_s(0, 6 * n) * 1e3
        print(f"kernel working_copy_refresh {what}: {n / 1e6:.1f}M values in "
              f"{len(shapes)} tensors ({tiled} channels_last, a launch "
              f"each), {launched} launches; bit-equal to "
              f".to(torch.bfloat16) {equal}; kernel {ms:.4f} ms, bound "
              f"{bound:.4f} ms ({6 * n / 1e9:.2f} GB), "
              f"{6 * n / ms / 1e9:.3f} TB/s "
              f"({100 * 6 * n / ms * 1e3 / PEAK_BYTES_PER_S:.1f}% of 3.35); "
              f"the wrapper's host time {host_us:.0f} us a call [{card}]")
        out[f"refresh {what}"] = (ms, bound)
        del params

        def grad_like(c):
            g = torch.randn(c.shape, generator=gen, device=dev).to(
                torch.bfloat16)
            tiled = g.dim() == 4 and g.shape[2] * g.shape[3] > 1
            return g.contiguous(memory_format=torch.channels_last) \
                if tiled else g
        first, second = ([grad_like(c) for c in copies] for _ in range(2))
        del copies
        tiled = sum(not g.is_contiguous() for g in first)
        grads = [torch.empty(g.shape, device=dev) for g in first]
        for add, gs in ((False, first), (True, second)):
            for grad, g in zip(grads, gs):
                wc.accumulate_cuda(grad, g, add)
            torch.cuda.synchronize()
            equal = all(torch.equal(
                grad, g0.float() + g.float() if add else g0.float())
                for grad, g0, g in zip(grads, first, gs))
            _check(equal, f"grad accumulate kernel ({what}, "
                          f"{'add' if add else 'store'}): .grad differs from "
                          f"the cast and AccumulateGrad")

            def one_pass(gs=gs, add=add):
                for grad, g in zip(grads, gs):
                    wc.accumulate_cuda(grad, g, add)
            ms = _graph_ms(one_pass, launches=1)
            host_us = _host_us(one_pass, iters=3)
            nbytes = (10 if add else 6) * n
            bound = bound_s(0, nbytes) * 1e3
            mode = "add" if add else "store"
            print(f"kernel grad_accumulate {what} {mode}: {n / 1e6:.1f}M "
                  f"values in {len(grads)} tensors ({tiled} channels_last, "
                  f"tiled), a launch each; bit-equal to the cast and "
                  f"AccumulateGrad {equal}; in a CUDA graph {ms:.4f} ms, "
                  f"bound {bound:.4f} ms ({nbytes / 1e9:.2f} GB), "
                  f"{nbytes / ms / 1e9:.3f} TB/s "
                  f"({100 * nbytes / ms * 1e3 / PEAK_BYTES_PER_S:.1f}% of "
                  f"3.35); host {host_us / 1e3:.2f} ms a pass [{card}]")
            out[f"accumulate {mode} {what}"] = (ms, bound)
        del first, second, grads
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _lengths(sq: int, skv: int, tails: int) -> str:
    """A flash case's lengths and its tail launches, for its `kernel`
    line: the key length where it is not the query length, and the tail
    instance's launches where a length is not a multiple of 64."""
    text = f" Skv={skv}" if skv != sq else ""
    if sq % 64 or skv % 64:
        text += f" tail launches {tails}"
    return text


def _kernel_phase(card: str):
    """Each kernel against its plain version at the main paths' shapes;
    returns {kernel: [case, ...]}, a case being a dict of err, ms,
    plain_ms, library_ms, bound_ms, bound_by."""
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

    # GroupNorm forward: the serving shapes, the 256px training one, then
    # the VAE encoder's largest slabs at 256px, microbatch 16 (two launches
    # and one)
    for shape, act in (((2, 4096, 320), "silu"), ((2, 1024, 640), None),
                       ((1, 262144, 128), "silu"), ((16, 1024, 320), "silu"),
                       ((16, 65536, 128), "silu"),
                       ((16, 16384, 256), "silu")):
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
        bms, by = _least_ms(10 * x.numel(), 2 * _nbytes(x) + 3 * c * 4)
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
        bms, by = _least_ms(20 * x.numel(), 3 * _nbytes(x) + 7 * c * 4)
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

    # flash forward: the serving shapes, the 256px training one, then the
    # MMDiT's joint attention at 1,024px (4,250 tokens, the tail instance)
    # and a whole-tile query block against its ragged keys, then FLUX's at
    # head dim 128 (4,608 tokens, whole tiles) and a ragged 4,173; the
    # library call is SDPA's flash backend on the (B, H, S, D) views
    for shape, skv in (((2, 4096, 5, 64), 4096), ((2, 1024, 10, 64), 1024),
                       ((16, 1024, 5, 64), 1024), ((2, 4250, 24, 64), 4250),
                       ((2, 4096, 24, 64), 4250), ((2, 4608, 24, 128), 4608),
                       ((2, 4173, 24, 128), 4173)):
        b, s, h, d = shape
        q = randn(*shape)
        k, v = randn(b, skv, h, d), randn(b, skv, h, d)
        ragged = bool(s % 64 or skv % 64)
        fa.launches_tail.reset()
        out, lse = fa.flash_attention_cuda(q, k, v)
        tails = fa.launches_tail.value
        _check(tails == int(ragged), f"flash_attention at {shape}, Skv = "
               f"{skv}: {tails} tail launches, not {int(ragged)}")
        ref_out, ref_lse = fa.flash_attention_reference(q, k, v)
        err = (out.float() - ref_out.float()).abs().max().item()
        ref_max = ref_out.float().abs().max().item()
        rel_l2 = ((out.float() - ref_out.float()).norm()
                  / ref_out.float().norm()).item()
        lse_err = (lse - ref_lse).abs().max().item()
        flops = 4 * b * h * s * skv * d
        bms, by = _least_ms(flops, 2 * _nbytes(q) + 2 * _nbytes(k)
                         + _nbytes(lse))
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
               f"max_abs_err {lse_err:.3e} (bound 1e-3)",
               _lengths(s, skv, tails))
        _check(err <= out_bound and rel_l2 <= 2.0 ** -7 and lse_err <= 1e-3,
               f"flash_attention disagrees with its plain version at {shape}"
               f", Skv = {skv}")
        results["flash_attention"].append(case)

    # flash backward: 256px training (first stage, batch 16), then 512px:
    # batch 4, and the 512 recipe's microbatch of 8; then the MMDiT's joint
    # attention (the tail instances) and whole-tile queries on ragged keys;
    # then FLUX's at head dim 128, whole and ragged
    for shape, skv in (((16, 1024, 5, 64), 1024), ((4, 4096, 5, 64), 4096),
                       ((8, 4096, 5, 64), 4096), ((2, 4250, 24, 64), 4250),
                       ((2, 4096, 24, 64), 4250), ((2, 4608, 24, 128), 4608),
                       ((2, 4173, 24, 128), 4173)):
        b, s, h, d = shape
        q, do = randn(*shape), randn(*shape)
        k, v = randn(b, skv, h, d), randn(b, skv, h, d)
        ragged = bool(s % 64 or skv % 64)
        out, lse = fa.flash_attention_cuda(q, k, v)
        fa.launches_bwd_dq_tail.reset()
        fa.launches_bwd_dkv_tail.reset()
        dq, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, out, lse, do)
        dk, dv = fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta)
        tails = (fa.launches_bwd_dq_tail.value, fa.launches_bwd_dkv_tail.value)
        _check(tails == (int(ragged),) * 2, f"flash backward at {shape}, "
               f"Skv = {skv}: {tails} tail launches (dQ, dK/dV), not "
               f"{int(ragged)} each")
        want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do)
        # both round p and ds to bf16 before their products and the outputs
        # once more: one bf16 ulp of the largest element, doubled
        errs = [((a.float() - w.float()).abs().max().item(),
                 2.0 ** -6 * w.float().abs().max().item())
                for a, w in zip((dq, dk, dv), want)]
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
        flops = 2 * b * h * s * skv * d           # one Sq x Skv x d product
        small = _nbytes(lse) + _nbytes(delta)
        # delta = rowsum(dO * O) in fp32 on both sides, summed in another
        # order: 1e-5 of the row's sum of |dO * O|
        prod = do.float() * out.float()
        delta_err = ((delta - prod.sum(-1).transpose(1, 2)).abs()
                     / prod.abs().sum(-1).transpose(1, 2)).max().item()
        graph = {}
        for name, n_mm, nbytes, fn, (err, bound) in (
                ("flash_attention_bwd_dq", 3,
                 4 * _nbytes(q) + 2 * _nbytes(k) + small,
                 lambda: fa.flash_attention_bwd_dq_cuda(q, k, v, out, lse, do),
                 errs[0]),
                ("flash_attention_bwd_dkv", 4,
                 2 * _nbytes(q) + 4 * _nbytes(k) + small,
                 lambda: fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse,
                                                         delta),
                 max(errs[1:]))):
            bms, by = _least_ms(n_mm * flops, nbytes)
            case = {"err": err, "bound_ms": bms, "bound_by": by,
                    "ms": _time_ms(fn), "plain_ms": plain,
                    "library_ms": lib_bwd, "host_us": _host_us(fn),
                    "graph_ms": _graph_ms(fn)}
            case["tflops"] = n_mm * flops / case["ms"] / 1e9
            graph[name] = case["graph_ms"]
            delta_text = (f", delta relative err {delta_err:.3e} (bound "
                          f"1e-5)" if name.endswith("_dq") else "")
            report(name, shape, case,
                   f"max_abs_err {err:.3e} (bound {bound:.3e}){delta_text}; "
                   f"plain and library times are the whole backward",
                   _lengths(s, skv, tails[name.endswith("_dkv")]))
            _check(err <= bound and (delta_err <= 1e-5
                                     or not name.endswith("_dq")),
                   f"{name} disagrees with its plain version at {shape}, "
                   f"Skv = {skv}")
            results[name].append(case)
        both = sum(graph.values())
        lib_text = (f"{lib_graph:.4f} ms ({lib_graph / both:.2f}x ours)"
                    if lib_graph else "not measured")
        print(f"kernel flash_attention_bwd dQ + dK/dV {shape} bf16"
              f"{_lengths(s, skv, tails[0])}: in a "
              f"CUDA graph {both:.4f} ms ({graph['flash_attention_bwd_dq']:.4f}"
              f" + {graph['flash_attention_bwd_dkv']:.4f}) vs library (SDPA "
              f"flash backward alone, in a CUDA graph) {lib_text} [{card}]")
        ours = _time_ms(lambda: fa.flash_attention_bwd_cuda(
            q, k, v, *fa.flash_attention_cuda(q, k, v), do))
        print(f"kernel flash_attention forward+backward {shape} bf16"
              f"{_lengths(s, skv, tails[0])}: "
              f"{ours:.4f} ms vs library (SDPA flash) {lib_both:.4f} ms "
              f"[{card}]")
    return results


def _smooth_image(rng, height: int, width: int):
    """A uint8 (H, W, 3) image of smooth colour waves drawn from `rng` (a
    photo-like JPEG, unlike white noise)."""
    import numpy as np
    y, x = np.mgrid[0:height, 0:width] / max(height, width)
    out = np.empty((height, width, 3))
    for c in range(3):
        fx, fy, phase = rng.uniform(0.5, 3.0), rng.uniform(0.5, 3.0), \
            rng.uniform(0, 2 * np.pi)
        out[..., c] = 127.5 + 127.5 * np.sin(2 * np.pi * (fx * x + fy * y)
                                             + phase)
    return np.clip(out, 0, 255).astype(np.uint8)


def _jpeg(arr) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def _b64_png(arr, mode=None) -> str:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr, mode=mode).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


def _left_half_mask(height: int, width: int):
    """An inpainting mask, uint8 (H, W): white (255, regenerate) on the
    left half, black (keep) on the right."""
    import numpy as np
    mask = np.zeros((height, width), np.uint8)
    mask[:, :width // 2] = 255
    return mask


# the wds shards' JPEG sizes (width, height): non-square, so the reader's
# resize and center crop both run
_WDS_SIZES = ((320, 256), (256, 384), (400, 300), (288, 512))


def _write_wds_shards(path: str, n: int, rng, start: int = 0,
                      flag_every: int = 0, per_shard: int = 64):
    """webdataset tar shards of `n` samples under `path` (`<key>.jpg`,
    `.txt` caption "wds sample <i>", `.json` with width, height and
    punsafe: 0.9 on every `flag_every`-th sample, else 0.1) and a JSON
    manifest of them; returns (manifest path, the flagged keys, bytes)."""
    import tarfile
    os.makedirs(path, exist_ok=True)
    shards, flagged, nbytes = [], set(), 0
    for first in range(start, start + n, per_shard):
        shard = os.path.join(path, f"{first:06d}.tar")
        with tarfile.open(shard, "w") as tf:
            for i in range(first, min(first + per_shard, start + n)):
                w, h = _WDS_SIZES[i % len(_WDS_SIZES)]
                unsafe = bool(flag_every) and i % flag_every == 5
                if unsafe:
                    flagged.add(f"{i:06d}")
                meta = {"width": w, "height": h,
                        "punsafe": 0.9 if unsafe else 0.1}
                for ext, data in (
                        ("jpg", _jpeg(_smooth_image(rng, h, w))),
                        ("txt", f"wds sample {i}".encode()),
                        ("json", json.dumps(meta).encode())):
                    info = tarfile.TarInfo(f"{i:06d}.{ext}")
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
        shards.append(shard)
        nbytes += os.path.getsize(shard)
    manifest = os.path.join(path, "manifest.json")
    with open(manifest, "w") as f:
        json.dump({"shards": shards}, f)
    return manifest, flagged, nbytes


def _write_coco_shards(path: str, n: int, rng) -> int:
    """COCO's MDS columns (`image` JPEG bytes of COCO-like non-square sizes,
    `captions` a JSON list of five) with the port's MDSWriter, values from
    `rng`; returns the bytes written."""
    from diffusion_torch.data.mds import MDSWriter
    sizes = ((640, 480), (480, 640), (500, 375))
    with MDSWriter(path, {"image": "bytes", "captions": "json"},
                   size_limit=1 << 23) as w:
        for i in range(n):
            width, height = sizes[i % len(sizes)]
            w.write({"image": _jpeg(_smooth_image(rng, height, width)),
                     "captions": [f"coco image {i}, caption {k}"
                                  for k in range(5)]})
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def _rel_l2(got, want) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return ((got - want).norm() / want.norm()).item()


def _reference_phase(model, card: str) -> None:
    """The full-width UNet, VAE decoder and VAE encoder on the card (bf16,
    kernels) against the same weights on the CPU (fp32, plain versions), at
    256px so the UNet's first stage (S=1024) runs the flash kernel; the
    encoder on a 64x64 batch-1 image (its posterior's mean and logvar)."""
    import copy

    import torch
    gen = torch.Generator().manual_seed(1)
    lat = torch.randn((2, 4, 32, 32), generator=gen).contiguous(
        memory_format=torch.channels_last)
    t = torch.tensor([999, 20])
    ctx = torch.randn((2, 77, 1024), generator=gen)
    z = torch.randn((1, 4, 16, 16), generator=gen)
    x = torch.rand((1, 3, 64, 64), generator=gen) * 2.0 - 1.0

    def encode(m, dev):
        post = m.encode(x.to(dev))
        return {"posterior mean": post.mean, "posterior logvar": post.logvar}

    for name, module, run in (
            ("UNet", model.unet, lambda m, dev: {"": m(
                lat.to(dev), t.to(dev), ctx.to(dev))}),
            ("VAE decode", model.vae, lambda m, dev: {"": m.decode(
                z.to(dev))}),
            ("VAE encode", model.vae, encode)):
        with torch.inference_mode():
            got = run(module, "cuda:0")
            ref = copy.deepcopy(module).to("cpu")
            ref.dtype = torch.float32
            want = run(ref, "cpu")
        del ref
        for part, out in got.items():
            err = _rel_l2(out, want[part])
            finite = bool(torch.isfinite(out).all())
            # bf16 keeps 8 significant bits (2**-8 relative per rounding);
            # the roundings of ~100 layers add up to a few percent
            print(f"reference: {name}{' ' + part if part else ''} "
                  f"{tuple(out.shape)} bf16 on the card vs fp32 on the CPU: "
                  f"relative L2 error {err:.3e} (bound 5e-2), finite "
                  f"{finite} [{card}]")
            _check(finite and err <= 5e-2,
                   f"{name} {part} disagrees with its fp32 CPU reference")


def _img2img_phase(endpoint, card: str, merged_s: float) -> tuple:
    """Phase 5b: img2img and inpainting on the full-width endpoint (see the
    module docstring). Returns the forward kernels' launches in its three
    requests, the 20-step text request's launches and its latency, and
    the encoder's GroupNorm calls."""
    import numpy as np
    import torch
    from PIL import Image

    from diffusion_torch.inference.serve import make_server
    from diffusion_torch.models.unet import group_norm_shapes
    from diffusion_torch.models.vae import encoder_group_norm_shapes
    from diffusion_torch.ops import flash_attention as fa
    from diffusion_torch.ops import groupnorm as gn

    t_phase = time.perf_counter()
    model = endpoint.model
    per_step_gn = len(group_norm_shapes(model.unet.config, 2, SIZE // 8))
    rng = np.random.default_rng(5)
    src = _smooth_image(rng, SIZE, SIZE)
    image_b64 = _b64_png(src)
    mask_b64 = _b64_png(_left_half_mask(SIZE, SIZE), "L")
    dev = model.device

    # the encoder alone: its GroupNorm calls, and times at two sizes
    n_calls = len(encoder_group_norm_shapes(model.vae.config, 1, SIZE, SIZE))
    with torch.inference_mode():
        x512 = torch.rand((2, 3, SIZE, SIZE), device=dev) * 2 - 1
        x256 = torch.rand((TRAIN_MICRO, 3, TRAIN_SIZE, TRAIN_SIZE),
                          device=dev) * 2 - 1
        model.vae.encode(x512[:1])          # cuDNN picks per shape
        torch.cuda.synchronize()
        gn.launches.reset()
        model.vae.encode(x512[:1])
        torch.cuda.synchronize()
        per_encode = gn.launches.value
        times = {shape: _time_ms(lambda: model.vae.encode(x), iters=5,
                                 warmup=2)
                 for shape, x in (((2, SIZE), x512),
                                  ((TRAIN_MICRO, TRAIN_SIZE), x256))}
    del x512, x256
    print(f"img2img: VAE encode: {per_encode} GroupNorm calls an encode "
          f"(expected {n_calls}); {times[(2, SIZE)]:.2f} ms at {SIZE}px "
          f"batch 2, {times[(TRAIN_MICRO, TRAIN_SIZE)]:.2f} ms at "
          f"{TRAIN_SIZE}px batch {TRAIN_MICRO} (CUDA events, 5 encodes "
          f"after 2) [{card}]")
    _check(per_encode == n_calls, "the encoder's GroupNorm calls did not all "
           "go through the kernel's wrapper")

    # three requests over HTTP, one at a time: text-to-image, img2img and
    # inpainting at the same step count
    server = make_server(endpoint, "127.0.0.1", 0, max_batch_size=1,
                         batch_wait_ms=0.0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    common = {"prompt": "a lighthouse on a cliff at dusk", "guidance_scale":
              7.5, "seed": 0, "height": SIZE, "width": SIZE,
              "num_inference_steps": STEPS}
    requests = (("text", {}),
                ("img2img", {"image": image_b64,
                             "strength": IMG2IMG_STRENGTH}),
                ("inpaint", {"image": image_b64, "mask": mask_b64,
                             "strength": INPAINT_STRENGTH}))
    results, launches = {}, {}
    try:
        for key, extra in requests:
            gn.launches.reset()
            fa.launches.reset()
            _post(server.server_address[1], {**common, **extra}, results, key)
            torch.cuda.synchronize()
            launches[key] = {"group_norm": gn.launches.value,
                             "flash_attention": fa.launches.value}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    steps = {"text": STEPS, "img2img": int(STEPS * IMG2IMG_STRENGTH),
             "inpaint": int(STEPS * INPAINT_STRENGTH)}
    for key, _ in requests:
        _check(key in results, f"request {key} got no response")
        status, body, seconds = results[key]
        _check(status == 200, f"request {key}: HTTP {status} {body}")
        img = Image.open(io.BytesIO(base64.b64decode(body["images"][0])))
        img.load()
        _check(img.size == (SIZE, SIZE) and img.mode == "RGB",
               f"request {key}: PNG {img.size} {img.mode}")
        print(f"img2img: request {key}: HTTP 200, {img.size[0]}x"
              f"{img.size[1]} PNG, {STEPS} steps ({steps[key]} run), "
              f"{seconds:.3f} s end to end, beside phase 4's two merged "
              f"{STEPS}-step text-to-image requests {merged_s:.3f} s; "
              f"launches {json.dumps(launches[key])} [{card}]")
        # the UNet's calls scale with the steps run; the encoder adds its
        # GroupNorm calls once
        want_gn = (launches["text"]["group_norm"]
                   - per_step_gn * (STEPS - steps[key])
                   + (n_calls if key != "text" else 0))
        _check(launches[key]["group_norm"] == want_gn
               and launches[key]["flash_attention"] * STEPS
               == launches["text"]["flash_attention"] * steps[key],
               f"request {key}: launches {launches[key]} are not the "
               f"encoder's {n_calls} GroupNorm calls and {steps[key]} "
               f"UNet steps beside text-to-image's {launches['text']}")

    # the mask's extremes through generate, with the same draws
    ids = torch.from_numpy(model.tokenizer([common["prompt"]])["input_ids"])
    image = torch.from_numpy(src.astype(np.float32) / 255.0)[None].to(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    lat = (1, SIZE // 8, SIZE // 8, 4)
    eps = torch.randn(lat, generator=gen, device=dev)
    noise = torch.randn(lat, generator=gen, device=dev)
    kw = dict(height=SIZE, width=SIZE, guidance_scale=7.5,
              num_inference_steps=STEPS, image=image,
              strength=IMG2IMG_STRENGTH, latents=noise, latent_noise=eps)
    plain = model.generate(ids, **kw)
    ones = model.generate(ids, mask=torch.ones((1, SIZE, SIZE)), **kw)
    zeros = model.generate(ids, mask=torch.zeros((1, SIZE, SIZE)), **kw)
    with torch.inference_mode():
        lat0 = model.encode_images(image * 2.0 - 1.0, eps)
        recon = model.vae.decode(lat0.permute(0, 3, 1, 2) / model.latent_scale)
        recon = (recon * 0.5 + 0.5).clamp(0.0, 1.0).permute(0, 2, 3, 1)
    same_ones, same_zeros = torch.equal(plain, ones), torch.equal(zeros, recon)
    finite = bool(torch.isfinite(plain).all())
    print(f"img2img: generate on the card with the same draws: an all-ones "
          f"mask equals img2img {same_ones}, an all-zeros mask equals the "
          f"VAE reconstruction decode(lat0) {same_zeros}; finite {finite}; "
          f"phase {time.perf_counter() - t_phase:.1f} s [{card}]")
    _check(same_ones and same_zeros and finite,
           "the inpainting blend is not the identity at mask 1 or the "
           "reconstruction at mask 0")
    return ({k: sum(v[k] for v in launches.values())
             for k in ("group_norm", "flash_attention")},
            launches["text"], results["text"][2], n_calls)


def _launches_match(got: dict, text: dict, steps_run: int,
                    unet_gn_per_step: int, encoder_calls: int) -> bool:
    """Whether a request's forward-kernel launches are those of a
    `STEPS`-step text-to-image request (`text`) less the UNet steps not
    run, plus the encoder's GroupNorm calls. The flash kernel runs only in
    the UNet. A sampler changes no UNet work: a text request's counts must
    equal the DDIM request's exactly."""
    skipped = STEPS - steps_run
    want = {"group_norm": (text["group_norm"] - unet_gn_per_step * skipped
                           + encoder_calls),
            "flash_attention": (text["flash_attention"]
                                - text["flash_attention"] // STEPS * skipped)}
    return got == want


def _sampler_phase(endpoint, card: str, ddim_text: dict, ddim_s: float,
                   encoder_calls: int) -> dict:
    """Phase 5c: the samplers over HTTP on the full-width endpoint (see the
    module docstring). Returns the forward kernels' launches in its four
    requests."""
    import numpy as np
    import torch
    from PIL import Image

    from diffusion_torch.inference.serve import make_server
    from diffusion_torch.models.unet import group_norm_shapes
    from diffusion_torch.ops import flash_attention as fa
    from diffusion_torch.ops import groupnorm as gn

    t_phase = time.perf_counter()
    model = endpoint.model
    per_step_gn = len(group_norm_shapes(model.unet.config, 2, SIZE // 8))
    image_b64 = _b64_png(_smooth_image(np.random.default_rng(5), SIZE, SIZE))
    decoded = []
    hook = model.vae.post_quant_conv.register_forward_pre_hook(
        lambda mod, inp: decoded.append(bool(torch.isfinite(inp[0]).all())))
    server = make_server(endpoint, "127.0.0.1", 0, max_batch_size=1,
                         batch_wait_ms=0.0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    common = {"prompt": "a lighthouse on a cliff at dusk", "guidance_scale":
              7.5, "seed": 0, "height": SIZE, "width": SIZE,
              "num_inference_steps": STEPS}
    results, launches, finite = {}, {}, {}
    try:
        for key, extra in SAMPLER_REQUESTS:
            gn.launches.reset()
            fa.launches.reset()
            decoded.clear()
            payload = dict(common, **extra)
            if "strength" in extra:
                payload["image"] = image_b64
            _post(server.server_address[1], payload, results, key)
            torch.cuda.synchronize()
            launches[key] = {"group_norm": gn.launches.value,
                             "flash_attention": fa.launches.value}
            finite[key] = list(decoded)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        hook.remove()
    for key, extra in SAMPLER_REQUESTS:
        _check(key in results, f"request {key} got no response")
        status, body, seconds = results[key]
        _check(status == 200, f"request {key}: HTTP {status} {body}")
        img = Image.open(io.BytesIO(base64.b64decode(body["images"][0])))
        img.load()
        _check(img.size == (SIZE, SIZE) and img.mode == "RGB",
               f"request {key}: PNG {img.size} {img.mode}")
        _check(finite[key] == [True],
               f"request {key}: latents before the decode not finite "
               f"({finite[key]})")
        steps_run = int(STEPS * extra.get("strength", 1.0))
        encoder = encoder_calls if "strength" in extra else 0
        same = _launches_match(launches[key], ddim_text, steps_run,
                               per_step_gn, encoder)
        less = " less the steps not run plus the encoder" if encoder else ""
        print(f"samplers: request {key} {json.dumps(extra)}: HTTP 200, "
              f"{img.size[0]}x{img.size[1]} PNG, finite latents, {STEPS} "
              f"steps ({steps_run} run), {seconds:.3f} s end to end beside "
              f"phase 5b's {STEPS}-step DDIM text request {ddim_s:.3f} s; "
              f"launches {json.dumps(launches[key])}, equal to DDIM's "
              f"{json.dumps(ddim_text)}{less}"
              f": {same} [{card}]")
        _check(same, f"request {key}: launches {launches[key]} are not the "
               f"DDIM request's {ddim_text} for {steps_run} steps")
    print(f"samplers: phase {time.perf_counter() - t_phase:.1f} s [{card}]")
    return {k: sum(v[k] for v in launches.values())
            for k in ("group_norm", "flash_attention")}


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
    kernels' launch counts during the fit and the replayed steps' time
    (s): step 0 runs eagerly, step 1 captures the step's CUDA graph."""
    import torch

    from diffusion_torch.algorithms.ema import EMA
    from diffusion_torch.ops import groupnorm as gn
    from diffusion_torch.train.optim import adamw, multi_step_with_warmup
    from diffusion_torch.train.trainer import Trainer
    from diffusion_torch.utils.profiler import step_graph

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
    record = ComposedRecord()
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
    graph0 = (step_graph.captures, step_graph.replays,
              sum(step_graph.eager.values()))
    t0 = time.perf_counter()
    trainer.fit()
    torch.cuda.synchronize()
    graph = (step_graph.captures - graph0[0], step_graph.replays - graph0[1],
             sum(step_graph.eager.values()) - graph0[2])
    _check(graph == (1, TRAIN_STEPS - 1, 1),
           f"the step's CUDA graph: (captures, replays, eager steps) "
           f"{graph}, not (1, {TRAIN_STEPS - 1}, 1)")
    launches = {name: c.value for name, c in counters.items()}
    copies = gn.contiguity_copies.value
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    ts = trainer.train_state
    _check_steps("train", record, TRAIN_STEPS, card)
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
    # step 1 captures the step's CUDA graph
    times, step_s, _ = record.step_times(skip=(1,))
    print(f"train: SD-2-base {TRAIN_SIZE}px, global batch {TRAIN_BATCH} "
          f"({TRAIN_BATCH // TRAIN_MICRO} microbatches of {TRAIN_MICRO}), "
          f"{TRAIN_STEPS} steps in {time.perf_counter() - t0:.2f} s (step 0 "
          f"eager, 1 capturing the CUDA graph, 2-{TRAIN_STEPS - 1} "
          f"replaying it): replayed step time {step_s * 1e3:.1f} ms (steps "
          f"1-{TRAIN_STEPS - 1}: "
          f"{', '.join(f'{x * 1e3:.1f}' for x in times)} ms), "
          f"{TRAIN_BATCH / step_s:.2f} samples/s, peak device memory "
          f"{peak:.2f} GiB [{card}]")
    print(f"train: kernel launches during the fit {json.dumps(launches)} "
          f"(a replay counts the nodes it launched); per step " + json.dumps(
              {k: v / TRAIN_STEPS for k, v in launches.items()})
          + f"; GroupNorm cotangents copied to contiguous: {copies} "
          f"({copies / TRAIN_STEPS:.1f} per step)")
    for name, n in launches.items():
        _check(n > 0, f"{name} kernel was not launched during the fit")
    trainer.close()     # frees the step's CUDA graph's memory pool
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
    """The step record of every training run here (a yaml's names it by a
    `_target_` override): per step the metrics (synchronised), the step's
    end, the lr, the step's own time and the wait on the dataloader; per
    eval its wall time (synchronised) and the kernels' launches inside it.
    `_yaml_run` hands it the run's train loader (`loader`) when it builds
    the trainer."""

    loader = None

    def __init__(self):
        self.steps, self.waits, self.evals = [], [], []
        self._t = self._got = self._launches = None

    def note(self, i: int) -> str:
        """What step i's line adds: nothing here; a subclass's own record."""
        return ""

    def step_times(self, skip=()) -> tuple:
        """(the step times, one step's end to the next's, from step 1 on;
        their mean over the steps not in `skip`; the mean wait on the
        loader after the first step's)."""
        times = [b[1] - a[1] for a, b in zip(self.steps, self.steps[1:])]
        kept = [t for i, t in enumerate(times, 1) if i not in skip]
        return (times, sum(kept) / len(kept),
                sum(self.waits[1:]) / len(self.waits[1:]))

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


def _check_steps(label: str, record, steps: int, card: str) -> None:
    """Print each step's line (loss, grad norm, lr, the wait on the loader,
    the step's own time and the record's `note`) and check that `steps`
    steps ran, every metric finite."""
    for i, (m, _, lr, own) in enumerate(record.steps):
        print(f"{label}: step {i}: loss {m['loss/train/total']:.6f}, grad "
              f"norm {m['grad/global_norm']:.6f}, lr {lr:.3e}, waited "
              f"{record.waits[i] * 1e3:.1f} ms on the loader, then "
              f"{own * 1e3:.1f} ms to the step's metrics{record.note(i)} "
              f"[{card}]")
    _check(len(record.steps) == steps, f"{label}: {len(record.steps)} "
           f"steps, {steps} expected")
    _check(all(math.isfinite(v) for m, *_ in record.steps
               for v in m.values()),
           f"{label}: a loss or grad norm is not finite")


@contextlib.contextmanager
def _patch(owner, name: str, wrap):
    """`owner.name` replaced by `wrap(owner.name)` inside the block."""
    real = getattr(owner, name)
    setattr(owner, name, wrap(real))
    try:
        yield
    finally:
        setattr(owner, name, real)


def _shape_spy(shapes: list):
    """A `_patch` wrap for a flash entry point `f(q, k, v)` that appends
    each call's (q shape, k shape) to `shapes`."""
    def wrap(real):
        def spy(q, k, v):
            shapes.append((tuple(q.shape), tuple(k.shape)))
            return real(q, k, v)
        return spy
    return wrap


def _yaml_run(label: str, yaml_name: str, overrides: list, steps: int,
              card: str, patches=(), cli: bool = False) -> tuple:
    """Compose yamls/`yaml_name` with the dotted `overrides` (printed) and
    run it by `train(config)`, or with `cli` by `diffusion_torch.run.main`
    (the launch code of a torchrun rank), inside the context managers
    `patches`; the launch counters and the peak memory reset right before.
    The overrides name the run's ComposedRecord, which gets the train
    loader when the trainer is built. Prints every step's line and checks
    that `steps` steps ran, finite. Returns (trainer, record, the five
    kernels' launches, wall s, peak GiB, the FileLogger's records where
    the yaml logs to a file)."""
    import torch

    from diffusion_torch import run
    from diffusion_torch.config import load_config, select
    from diffusion_torch.train import train as train_mod

    config = load_config(os.path.join(_ROOT, "yamls", yaml_name), overrides)
    print(f"{label}: yamls/{yaml_name} with {len(overrides)} dotted "
          f"overrides: {' '.join(overrides)}")
    # WandBLogger is a no-op without wandb; with it, it stays offline
    os.environ.setdefault("WANDB_MODE", "disabled")
    built = []

    def hand_over(real):
        def build(cfg):
            built.append(real(cfg))
            for c in built[-1].engine.callbacks:
                if isinstance(c, ComposedRecord):
                    c.loader = built[-1].train_dataloader
            return built[-1]
        return build

    counters = _counters()
    for c in counters.values():
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        for p in (_patch(train_mod, "build_trainer", hand_over), *patches):
            stack.enter_context(p)
        t0 = time.perf_counter()
        if cli:
            run.main(["--config-path", os.path.join(_ROOT, "yamls"),
                      "--config-name", yaml_name, *overrides])
        else:
            train_mod.train(config)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {name: c.value for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    trainer = built[-1]
    record = next(c for c in trainer.engine.callbacks
                  if isinstance(c, ComposedRecord))
    logged = []
    metrics_file = select(config, "logger.file.filename")
    if metrics_file:
        with open(metrics_file) as f:
            logged = [json.loads(line) for line in f]
    _check_steps(label, record, steps, card)
    return trainer, record, launches, wall, peak, logged


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


def _composed_overrides(tmp: str, phase: str, metrics_file: str,
                        coco_eval: bool = False) -> list:
    """Write the composed run's LAION training shards under `tmp` (the same
    bytes on every call: a numpy seed) and its eval shards, and return the
    dotted overrides that point yamls/SD-2-base-256.yaml at them: global
    batch 32, 6 batches, an eval after batch 3, a FileLogger and the
    ComposedRecord callback. With `coco_eval` the eval set is the
    recipe's own COCO reader over COCO MDS shards (raw JPEGs, encoded by
    the VAE, so the model builds its frozen towers); else the LAION
    reader over precomputed latents."""
    import numpy as np
    t0 = time.perf_counter()
    rng = np.random.default_rng(6)
    train_dir, eval_dir = (os.path.join(tmp, d) for d in ("train", "eval"))
    nbytes = _write_laion_shards(train_dir, COMPOSED_TRAIN, rng)
    if coco_eval:
        eval_bytes = _write_coco_shards(eval_dir, COMPOSED_EVAL, rng)
        eval_overrides = ["+model.init_frozen_towers=true"]
    else:
        eval_bytes = _write_laion_shards(eval_dir, COMPOSED_EVAL, rng)
        eval_overrides = [
            "dataset.eval_dataset._target_="
            "diffusion_tpu.data.laion.build_streaming_laion_dataloader",
            "+dataset.eval_dataset.precomputed_latents=true"]
    print(f"{phase}: wrote {COMPOSED_TRAIN} training LAION samples and "
          f"{COMPOSED_EVAL} eval {'COCO' if coco_eval else 'LAION'} samples "
          f"({nbytes / 1e6:.1f} + {eval_bytes / 1e6:.1f} MB of MDS shards) "
          f"in {time.perf_counter() - t0:.1f} s")
    return [
        f"batch_size={TRAIN_BATCH}",
        f"dataset.train_dataset.remote={train_dir}",
        f"dataset.train_dataset.local={train_dir}",
        "dataset.train_dataset.num_workers=2",
        *eval_overrides,
        f"dataset.eval_dataset.remote={eval_dir}",
        f"dataset.eval_dataset.local={eval_dir}",
        f"dataset.eval_dataset.batch_size={TRAIN_BATCH}",
        f"dataset.eval_batch_size={TRAIN_BATCH}",
        "dataset.eval_dataset.num_workers=2",
        f"trainer.max_duration={TRAIN_STEPS}ba",
        f"trainer.eval_interval={COMPOSED_EVAL_AT}ba",
        "+logger.file._target_=diffusion_tpu.utils.logging.FileLogger",
        f"+logger.file.filename={metrics_file}",
        f"+callbacks.chip_smoke._target_={__name__}.ComposedRecord"]


def _composed_phase(card: str, train_step_s: float):
    """yamls/SD-2-base-256.yaml composed by the port's loader and run by
    its `train(config)` over MDS shards written here; returns the five
    kernels' launch counts during the run and each step's metrics."""
    import tempfile

    from diffusion_torch.data import native
    from diffusion_torch.utils.profiler import step_graph

    with tempfile.TemporaryDirectory(prefix="chip_smoke_laion_") as tmp:
        overrides = _composed_overrides(tmp, "composed", os.path.join(
            tmp, "metrics.jsonl"), coco_eval=True)
        graph0 = (step_graph.captures, step_graph.replays)
        trainer, record, launches, wall, peak, records = _yaml_run(
            "composed", "SD-2-base-256.yaml", overrides, TRAIN_STEPS, card)
        graph = (step_graph.captures - graph0[0],
                 step_graph.replays - graph0[1])

    model = trainer.model
    eval_set = type(trainer.evaluators[0].dataloader.dataset).__name__
    _check(eval_set == "StreamingCOCOCaption" and model.vae is not None,
           f"the eval set is {eval_set}, not the recipe's COCO reader, or "
           f"the towers were not built")
    print(f"composed: model {type(model).__module__}.{type(model).__name__}, "
          f"UNet {sum(p.numel() for p in model.unet.parameters()) / 1e6:.1f}M"
          f" params, compute {model.unet.dtype}; loaders "
          f"{type(trainer.train_dataloader).__module__} ({len(trainer.train_dataloader)}"
          f" batches an epoch, {trainer.train_dataloader.worker_type} workers);"
          f" algorithms {[type(a).__name__ for a in trainer.engine.algorithms]};"
          f" libdataio: {native.build_info()}")
    # the batch after the eval carries the eval, step 1 the CUDA graph's
    # capture (where it engaged): leave them out
    times, step_s, wait_s = record.step_times(
        skip=(COMPOSED_EVAL_AT, 1) if graph[0] else (COMPOSED_EVAL_AT,))
    owns = [st[3] for i, st in enumerate(record.steps)
            if i and i != COMPOSED_EVAL_AT]
    own_s = sum(owns) / len(owns)
    print(f"composed: SD-2-base {TRAIN_SIZE}px from MDS shards, global batch "
          f"{TRAIN_BATCH}: run {wall:.2f} s (composition and the model's "
          f"build included); step time after the first {step_s * 1e3:.1f} ms"
          f" (steps: {', '.join(f'{x * 1e3:.1f}' for x in times)} ms, the "
          f"one after the eval and the capture left out; the step's CUDA "
          f"graph: {graph[0]} capture(s), {graph[1]} replays), "
          f"{TRAIN_BATCH / step_s:.2f} "
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
    print(f"composed: eval after batch {COMPOSED_EVAL_AT} on the recipe's "
          f"COCO reader ({eval_set}; its [0, 1] images encoded as they come, "
          f"as the reference encodes them, ROADMAP.md queue 3 fault 8): MSE "
          f"{mse:.6f}, bin 0-1 {mse_bin:.6f}, {COMPOSED_EVAL // TRAIN_BATCH} "
          f"batches of {TRAIN_BATCH} in {eval_s * 1e3:.1f} ms [{card}]")
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
    return launches, [m for m, *_ in record.steps], {
        "step_s": step_s, "wait_s": wait_s, "peak": peak}


class OnlineRecord(ComposedRecord):
    """ComposedRecord for the online-encode run, and: the captions of each
    training batch; the frozen VAE and CLIP parameters when the fit starts,
    held against themselves (torch.equal) and their `.grad` when it ends;
    and the span of the towers' encode on the stream inside each training
    step (CUDA events around the model's `encode_images` and
    `encode_text`: the device's gaps while the host launches count)."""

    def __init__(self):
        super().__init__()
        self.captions, self.encode_ms = [], []
        self.towers = {}
        self.towers_unchanged = self.towers_no_grad = None
        self._events, self._in_step = [], False

    def note(self, i: int) -> str:
        return (f"; the towers' encode spans {self.encode_ms[i]:.1f} ms of "
                f"the stream")

    def _timed(self, fn):
        import torch

        def timed(*args, **kwargs):
            if not self._in_step:
                return fn(*args, **kwargs)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self._events.append((start, end))
            return out
        return timed

    def run_event(self, event, state, logger) -> None:
        import torch
        name = event.value
        model = state.model
        if name == "fit_start":
            self.towers = {f"{part}.{n}": p.detach().clone()
                           for part in ("vae", "text_encoder")
                           for n, p in getattr(model, part).named_parameters()}
            for attr in ("encode_images", "encode_text"):
                setattr(model, attr, self._timed(getattr(model, attr)))
        elif name == "after_dataloader":
            self.captions.append(state.batch["captions"].cpu().numpy())
        elif name == "batch_start":
            self._events, self._in_step = [], True
        elif name == "batch_end":
            torch.cuda.synchronize()
            self.encode_ms.append(sum(a.elapsed_time(b)
                                      for a, b in self._events))
            self._in_step = False
        elif name == "fit_end":
            for attr in ("encode_images", "encode_text"):
                delattr(model, attr)
            live = {f"{part}.{n}": p for part in ("vae", "text_encoder")
                    for n, p in getattr(model, part).named_parameters()}
            self.towers_unchanged = sorted(live) == sorted(self.towers) and \
                all(torch.equal(p, self.towers[n]) for n, p in live.items())
            self.towers_no_grad = all(p.grad is None and not p.requires_grad
                                      for p in live.values())
            self.towers = {}
        super().run_event(event, state, logger)


def _online_overrides(tmp: str, metrics_file: str, card: str) -> tuple:
    """Write the online run's webdataset shards and filter strategy under
    `tmp` (a numpy seed) and return (the dotted overrides that point
    yamls/SD-2-base-256-wds.yaml at them, the training manifest, the
    strategy file, the flagged keys): global batch 32 in microbatches of
    16, 6 batches, an eval of 64 samples after batch 3, a FileLogger and
    the OnlineRecord callback."""
    import numpy as np
    t0 = time.perf_counter()
    rng = np.random.default_rng(8)
    train, flagged, nb_train = _write_wds_shards(
        os.path.join(tmp, "train"), ONLINE_TRAIN, rng,
        flag_every=ONLINE_FLAG_EVERY)
    evals, _, nb_eval = _write_wds_shards(
        os.path.join(tmp, "eval"), ONLINE_EVAL, rng, start=ONLINE_TRAIN)
    strategy = os.path.join(tmp, "filter_strategy.json")
    with open(strategy, "w") as f:
        json.dump({"punsafe": {"max": 0.5, "default": True}}, f)
    print(f"online: wrote {ONLINE_TRAIN} training samples ({len(flagged)} "
          f"flagged punsafe 0.9) and {ONLINE_EVAL} eval samples, JPEGs of "
          f"{', '.join(f'{w}x{h}' for w, h in _WDS_SIZES)} with .txt and "
          f".json ({nb_train / 1e6:.1f} + {nb_eval / 1e6:.1f} MB of tar "
          f"shards) in {time.perf_counter() - t0:.1f} s on the host [{card}]")
    return [
        f"batch_size={TRAIN_BATCH}",
        f"trainer.device_train_microbatch_size={TRAIN_MICRO}",
        f"dataset.train_dataset.meta_json={train}",
        f"dataset.train_dataset.filter_strategy={strategy}",
        f"dataset.eval_dataset.meta_json={evals}",
        f"dataset.eval_dataset.batch_size={TRAIN_BATCH}",
        f"dataset.eval_batch_size={TRAIN_BATCH}",
        f"trainer.max_duration={TRAIN_STEPS}ba",
        f"trainer.eval_interval={COMPOSED_EVAL_AT}ba",
        "+logger.file._target_=diffusion_tpu.utils.logging.FileLogger",
        f"+logger.file.filename={metrics_file}",
        f"+callbacks.chip_smoke._target_={__name__}.OnlineRecord"], \
        train, strategy, flagged


def _online_phase(card: str, composed: dict):
    """Phase 8b: the unedited yamls/SD-2-base-256-wds.yaml (raw images from
    tar shards, encoded online by the frozen VAE and CLIP) through the
    port's loader and `train(config)`; returns the five kernels' launches
    during the run."""
    import tempfile

    import numpy as np

    from diffusion_torch.data.datapipes import (filter_samples, list_shards,
                                                tar_samples)
    from diffusion_torch.data.filters import load_filter_strategy
    from diffusion_torch.text.tokenizer import tiny_tokenizer

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_wds_") as tmp:
        overrides, manifest, strategy, flagged = _online_overrides(
            tmp, os.path.join(tmp, "metrics.jsonl"), card)
        # what the filter keeps, read straight from the shards
        kept = {s["__key__"] for s in filter_samples(
            tar_samples(list_shards([], manifest=manifest)),
            load_filter_strategy(strategy))}
        trainer, record, launches, wall, peak, records = _yaml_run(
            "online", "SD-2-base-256-wds.yaml", overrides, TRAIN_STEPS, card)
    model = trainer.model
    print(f"online: model {type(model).__module__}.{type(model).__name__}, "
          f"precomputed_latents {model.precomputed_latents}, VAE "
          f"{sum(p.numel() for p in model.vae.parameters()) / 1e6:.1f}M and "
          f"CLIP text {sum(p.numel() for p in model.text_encoder.parameters()) / 1e6:.1f}M"
          f" frozen, UNet compute {model.unet.dtype}; train loader "
          f"{type(trainer.train_dataloader).__module__}."
          f"{type(trainer.train_dataloader).__name__}")
    evals = [r for r in records if "metrics/eval/MeanSquaredError" in r]
    _check(len(evals) == 1 and evals[0]["step"] == COMPOSED_EVAL_AT
           and math.isfinite(evals[0]["metrics/eval/MeanSquaredError"]),
           f"expected one finite eval after batch {COMPOSED_EVAL_AT}: {evals}")

    # the filter dropped exactly the flagged samples
    every = {f"{i:06d}" for i in range(ONLINE_TRAIN)}
    tok = tiny_tokenizer()
    ids = {key: tuple(tok(f"wds sample {int(key)}")["input_ids"][0])
           for key in every}
    seen = {tuple(r) for batch in record.captions for r in batch}
    flagged_ids = {ids[k] for k in flagged}
    print(f"online: filter strategy punsafe <= 0.5: the shards' "
          f"{ONLINE_TRAIN} samples, {len(flagged)} flagged, {len(kept)} kept;"
          f" the run's {len(record.captions)} batches hold {len(seen)} "
          f"distinct captions, none flagged: {not seen & flagged_ids}")
    _check(kept == every - flagged
           and len(flagged) == ONLINE_TRAIN // ONLINE_FLAG_EVERY
           and seen <= {ids[k] for k in kept} and not seen & flagged_ids
           and len(seen) == TRAIN_STEPS * TRAIN_BATCH,
           "the filter did not drop exactly the flagged samples")

    times, step_s, wait_s = record.step_times(skip=(COMPOSED_EVAL_AT,))
    enc_ms = float(np.mean([e for i, e in enumerate(record.encode_ms) if i]))
    own_s = float(np.mean([st[3] for i, st in enumerate(record.steps)
                           if i and i != COMPOSED_EVAL_AT]))
    eval_mse = evals[0]["metrics/eval/MeanSquaredError"]
    _, eval_s, eval_launches = record.evals[0]
    print(f"online: SD-2-base {TRAIN_SIZE}px from raw images, global batch "
          f"{TRAIN_BATCH} in microbatches of {TRAIN_MICRO}: run {wall:.2f} s "
          f"(composition and build included); step time after the first "
          f"{step_s * 1e3:.1f} ms (steps: {', '.join(f'{x * 1e3:.1f}' for x in times)}"
          f" ms, the one after the eval left out), {TRAIN_BATCH / step_s:.2f} "
          f"samples/s, against phase 8's {composed['step_s'] * 1e3:.1f} ms and"
          f" {TRAIN_BATCH / composed['step_s']:.2f} samples/s from latents; "
          f"the towers' encode spans {enc_ms:.1f} ms of the stream (CUDA "
          f"events around it, the device's gaps while the host launches "
          f"included; {enc_ms / (step_s * 1e3):.3f} of the step); loader wait "
          f"{wait_s * 1e3:.1f} ms a step after the first "
          f"({wait_s / step_s:.3f} of the step; phase 8's "
          f"{composed['wait_s'] * 1e3:.1f} ms), the step's own time "
          f"{own_s * 1e3:.1f} ms; eval MSE {eval_mse:.6f} over "
          f"{ONLINE_EVAL} samples in {eval_s * 1e3:.1f} ms; peak device "
          f"memory {peak:.2f} GiB (phase 8's {composed['peak']:.2f}) "
          f"[{card}]")
    fit_launches = {k: launches[k] - eval_launches[k] for k in launches}
    print(f"online: kernel launches during the fit "
          f"{json.dumps(fit_launches)}, during the eval "
          f"{json.dumps(eval_launches)}; frozen towers bit-unchanged "
          f"{record.towers_unchanged}, without gradients "
          f"{record.towers_no_grad}; phase {time.perf_counter() - t_phase:.1f}"
          f" s [{card}]")
    for name in launches:
        _check(fit_launches[name] > 0,
               f"{name} kernel was not launched during the online fit")
    _check(record.towers_unchanged and record.towers_no_grad,
           "the frozen VAE or CLIP changed or got a gradient")
    del trainer, model
    return launches, {"step_s": step_s, "peak": peak}


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


class Preempt:
    """A callback for the checkpoint phase's first run: sends this process
    a SIGTERM at the end of batch `at`, as a scheduler does ahead of a
    preemption."""

    def __init__(self, at: int):
        self.at = int(at)

    def run_event(self, event, state, logger) -> None:
        if event.value == "batch_end" and state.timestamp.batch == self.at:
            import signal
            os.kill(os.getpid(), signal.SIGTERM)

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, d: dict) -> None:
        pass


class ResumeCheck:
    """A callback for the checkpoint phase's second run: when its fit
    starts, right after the restore and before any step, the restored
    parameters, moments, count, step and timestamp must equal `live`'s
    (the first run's trainer, still on the card) exactly."""

    live = None      # set by the phase, cleared after the run
    result = None

    def run_event(self, event, state, logger) -> None:
        import torch
        if event.value != "fit_start":
            return
        live = type(self).live.train_state
        ts = state.train_state
        t0 = time.perf_counter()
        bad = [n for n, p in live.params.items()
               if not torch.equal(p, ts.params[n])]
        for key in ("mu", "nu"):
            bad += [f"{key}[{i}]" for i, (a, b) in enumerate(zip(
                getattr(live.optimizer, key), getattr(ts.optimizer, key)))
                if a.dtype != b.dtype or not torch.equal(a, b)]
        type(self).result = {
            "tensors": len(live.params) * 3, "unequal": bad,
            "step": (ts.step, live.step),
            "count": (ts.optimizer.count, live.optimizer.count),
            "timestamp": (state.timestamp.state_dict(),
                          type(self).live.state.timestamp.state_dict()),
            "seconds": time.perf_counter() - t0}

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, d: dict) -> None:
        pass


def _sd2_sizes() -> tuple:
    """Parameter counts of the full-width UNet, VAE and CLIP text
    tower, from modules on the meta device (no memory, no weights)."""
    import torch

    from diffusion_torch.models.clip import SD2_TEXT_CONFIG, CLIPTextModel
    from diffusion_torch.models.unet import SD2_BASE_UNET, UNet2DCondition
    from diffusion_torch.models.vae import SD2_VAE, AutoencoderKL
    with torch.device("meta"):
        return tuple(sum(p.numel() for p in m.parameters()) for m in (
            UNet2DCondition(SD2_BASE_UNET), AutoencoderKL(SD2_VAE),
            CLIPTextModel(SD2_TEXT_CONFIG)))


def _checkpoint_disk_need(n_unet: int, n_vae: int, n_text: int,
                          shard_bytes: int = 60 * 10 ** 6) -> dict:
    """Bytes the checkpoint phase holds on disk at its peak: two
    checkpoints (fp32 params, mu and nu of the UNet; the yaml has no EMA)
    until the newer one is marked and the older pruned, the fp16
    pretrained directory (UNet, VAE, CLIP text) and the MDS
    shards."""
    ckpt = 3 * 4 * n_unet
    pretrained = 2 * (n_unet + n_vae + n_text)
    return {"checkpoint": ckpt, "pretrained": pretrained,
            "shards": shard_bytes, "need": 2 * ckpt + pretrained + shard_bytes}


def _check_disk(path: str, need: int) -> int:
    """The free bytes under `path`; fails, naming the need, below it."""
    free = shutil.disk_usage(path).free
    _check(free >= need, f"the checkpoint phase needs {need / 1e9:.1f} GB "
           f"free under {path} (two SD-2-base checkpoints and an fp16 "
           f"pretrained directory); {free / 1e9:.1f} GB are free")
    return free


def _determinism_report(card: str) -> None:
    """Run each backward op of the training step twice on the same inputs
    and say which ones do not give the same bits: the three backward
    kernels, and cuDNN's convolution and cuBLAS's GEMM backward."""
    import torch
    import torch.nn.functional as F

    from diffusion_torch.ops.flash_attention import flash_attention
    from diffusion_torch.ops.groupnorm import group_norm
    gen = torch.Generator(device=DEVICE).manual_seed(11)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=DEVICE,
                           dtype=torch.float32).to(dtype)

    def grads(fn, *inputs):
        leaves = [x.detach().requires_grad_(True) for x in inputs]
        out = fn(*leaves)
        g = torch.randn(out.shape, generator=torch.Generator(
            device=DEVICE).manual_seed(5), device=DEVICE).to(out.dtype)
        return torch.autograd.grad(out, leaves, g)

    x = randn(16, 320, 32, 32).contiguous(memory_format=torch.channels_last)
    q, k, v = (randn(16, 1024, 5, 64) for _ in range(3))
    cases = {
        "GroupNorm backward kernel": (     # channels last, as the UNet's
            lambda x, s, b: group_norm(x, s, b, 32, act="silu"),
            (randn(16, 32, 32, 320), randn(320, dtype=torch.float32),
             randn(320, dtype=torch.float32))),
        "flash dQ and dK/dV kernels": (
            lambda q, k, v: flash_attention(q, k, v)[0], (q, k, v)),
        "cuDNN conv backward (320->320, 3x3)": (
            lambda x, w: F.conv2d(x, w, padding=1),
            (x, randn(320, 320, 3, 3))),
        "cuBLAS linear backward (16384x320 @ 320x1280)": (
            F.linear, (randn(16384, 320), randn(1280, 320))),
    }
    for name, (fn, inputs) in cases.items():
        a, b = grads(fn, *inputs), grads(fn, *inputs)
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        print(f"checkpoint: determinism: {name}: "
              f"{'bit-equal' if same else 'NOT bit-equal'} over two runs "
              f"on the same inputs [{card}]")


def _checkpoint_phase(card: str, composed_steps: list) -> dict:
    """Phase 10: save, preempt, resume and serve at full width (see the
    module docstring). Returns the five kernels' launches in the phase."""
    import tempfile
    build = os.path.join(_ROOT, "build")
    os.makedirs(build, exist_ok=True)
    sizes = _sd2_sizes()
    disk = _checkpoint_disk_need(*sizes)
    free = _check_disk(build, disk["need"])
    print(f"checkpoint: disk: {free / 1e9:.2f} GB free under build/; the "
          f"phase needs {disk['need'] / 1e9:.2f} GB at its peak (two "
          f"checkpoints of {disk['checkpoint'] / 1e9:.2f} GB, the fp16 "
          f"pretrained directory of {disk['pretrained'] / 1e9:.2f} GB, "
          f"{disk['shards'] / 1e6:.0f} MB of shards) [{card}]")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=build)
    try:
        return _checkpoint_runs(tmp, card, composed_steps, sizes)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _checkpoint_runs(tmp: str, card: str, composed_steps: list,
                     sizes: tuple) -> dict:
    import gc

    import torch

    from diffusion_torch.train import checkpoint as ckpt
    from diffusion_torch.utils import safetensors

    folder = os.path.join(tmp, "ckpt")
    base = _composed_overrides(tmp, "checkpoint", os.path.join(
        tmp, "metrics.jsonl")) + [
        f"trainer.save_folder={folder}",
        f"trainer.save_interval={COMPOSED_EVAL_AT}ba",
        "+trainer.save_num_checkpoints_to_keep=1"]
    first = base + [f"+callbacks.preempt._target_={__name__}.Preempt",
                    f"+callbacks.preempt.at={COMPOSED_EVAL_AT}"]
    run1, _, launches, wall1, _, _ = _yaml_run(
        "checkpoint run 1", "SD-2-base-256.yaml", first, COMPOSED_EVAL_AT,
        card)
    save = ckpt.last_save_stats()
    ba3 = os.path.join(folder, f"ba{COMPOSED_EVAL_AT}")
    _check(run1.state.timestamp.batch == COMPOSED_EVAL_AT
           and sorted(os.listdir(folder)) == [os.path.basename(ba3)]
           and os.path.exists(os.path.join(ba3, "meta.json")),
           f"the SIGTERM after batch {COMPOSED_EVAL_AT} did not leave fit() "
           f"with {ba3} complete: {os.listdir(folder)}")
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(ba3) for f in fs)
    print(f"checkpoint: run 1: SIGTERM after batch {COMPOSED_EVAL_AT}: fit() "
          f"returned at batch {run1.state.timestamp.batch} with "
          f"ba{COMPOSED_EVAL_AT} complete, {wall1:.2f} s with the build and "
          f"the eval; checkpoint {size / 1e9:.3f} GB ({size} bytes; tensors "
          f"{save['bytes']} bytes: fp32 params, mu, nu of "
          f"{sizes[0] / 1e6:.1f}M parameters) [{card}]")
    print(f"checkpoint: async save: pinned host buffer allocated in "
          f"{save['pin_alloc_s']:.3f} s (once; {save['bytes'] / 1e9:.2f} GB),"
          f" device-to-host copy {save['d2h_s']:.3f} s "
          f"({save['bytes'] / save['d2h_s'] / 1e9:.2f} GB/s), "
          f"save_checkpoint returned after {save['call_s']:.3f} s, the "
          f"thread wrote the files in {save['write_s']:.3f} s "
          f"({save['bytes'] / save['write_s'] / 1e9:.2f} GB/s) [{card}]")
    with open(os.path.join(ba3, "meta.json")) as f:
        meta = json.load(f)
    live_loader = run1.train_dataloader.state_dict()
    _check(meta["dataloader"] == live_loader,
           f"the checkpoint's loader position {meta['dataloader']} is not "
           f"the live one {live_loader}")

    ResumeCheck.live = run1
    second = base + ["trainer.autoresume=true",
                     f"+callbacks.resume._target_={__name__}.ResumeCheck"]
    run2, rec2, launches2, wall2, _, _ = _yaml_run(
        "checkpoint run 2", "SD-2-base-256.yaml", second,
        TRAIN_STEPS - COMPOSED_EVAL_AT, card)
    launches = {k: launches[k] + launches2[k] for k in launches}
    check = ResumeCheck.result
    ResumeCheck.live = ResumeCheck.result = None
    del run1
    gc.collect()
    torch.cuda.empty_cache()
    _check(check is not None, "the resumed run's fit did not start")
    print(f"checkpoint: run 2 (trainer.autoresume=true): restored "
          f"{check['tensors']} tensors, {len(check['unequal'])} of them "
          f"unequal to run 1's live state (torch.equal); step "
          f"{check['step'][0]} (live {check['step'][1]}), count "
          f"{check['count'][0]} (live {check['count'][1]}), timestamp "
          f"{json.dumps(check['timestamp'][0])}, loader position "
          f"{json.dumps(meta['dataloader'])}")
    _check(not check["unequal"] and check["step"][0] == check["step"][1]
           and check["count"][0] == check["count"][1]
           and check["timestamp"][0] == check["timestamp"][1],
           f"the restored state differs from the live one: {check}")
    end_loader = run2.train_dataloader.state_dict()
    _check(end_loader["epoch"] == live_loader["epoch"]
           and end_loader["batch_in_epoch"]
           == live_loader["batch_in_epoch"] + TRAIN_STEPS - COMPOSED_EVAL_AT,
           f"the resumed loader did not continue from {live_loader}: "
           f"{end_loader}")
    got = [m for m, *_ in rec2.steps]
    want = composed_steps[COMPOSED_EVAL_AT:]
    _check(len(got) == len(want) == TRAIN_STEPS - COMPOSED_EVAL_AT,
           f"the resumed run took {len(got)} steps")
    bit_equal = True
    for i, (g, w) in enumerate(zip(got, want)):
        rel = {k: abs(g[k] - w[k]) / abs(w[k]) for k in
               ("loss/train/total", "grad/global_norm")}
        bit_equal = bit_equal and all(g[k] == w[k] for k in rel)
        print(f"checkpoint: resumed step {COMPOSED_EVAL_AT + i}: loss "
              f"{g['loss/train/total']!r} (phase 8: {w['loss/train/total']!r}"
              f", rel {rel['loss/train/total']:.3e}), grad norm "
              f"{g['grad/global_norm']!r} (phase 8: "
              f"{w['grad/global_norm']!r}, rel "
              f"{rel['grad/global_norm']:.3e}); bound 1e-3")
        _check(all(r <= 1e-3 for r in rel.values()),
               f"resumed step {COMPOSED_EVAL_AT + i} differs from phase 8's "
               f"by more than 1e-3: {rel}")
    print(f"checkpoint: resumed losses and grad norms "
          f"{'ARE' if bit_equal else 'are NOT'} bit-equal to phase 8's "
          f"(cudnn.deterministic={torch.backends.cudnn.deterministic}, "
          f"cudnn.benchmark={torch.backends.cudnn.benchmark})")
    if not bit_equal:
        _determinism_report(card)
    ba6 = os.path.join(folder, f"ba{TRAIN_STEPS}")
    _check(sorted(os.listdir(folder)) == [os.path.basename(ba6)]
           and os.path.exists(os.path.join(ba6, "meta.json")),
           f"expected ba{TRAIN_STEPS} complete and ba{COMPOSED_EVAL_AT} "
           f"pruned: {os.listdir(folder)}")
    save6 = ckpt.last_save_stats()
    print(f"checkpoint: run 2: {wall2:.2f} s with the build and the "
          f"restore; ba{TRAIN_STEPS} complete and ba{COMPOSED_EVAL_AT} pruned "
          f"(save_num_checkpoints_to_keep=1); its save: device-to-host "
          f"{save6['d2h_s']:.3f} s, returned after {save6['call_s']:.3f} s, "
          f"written in {save6['write_s']:.3f} s, pinned buffer reused "
          f"({save6['pin_alloc_s']:.3f} s) [{card}]")

    # a step right after an async save, beside one without: run 2's next
    # batch three times (the first warms the allocator, emptied above),
    # saving into a directory of its own
    batches = run2._device_batches()
    batch, n = next(batches)
    steps = {}
    for label in ("warm-up", "without a save in flight",
                  "right after an async save"):
        if label.startswith("right"):
            run2.save_folder = os.path.join(tmp, "ckpt_timing")
            t0 = time.perf_counter()
            run2.save_checkpoint()
            steps["save returned"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run2._train_step(batch, n)
        torch.cuda.synchronize()
        steps[label] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ckpt.finalize_pending()
    steps["then finalize waited"] = time.perf_counter() - t0
    shutil.rmtree(os.path.join(tmp, "ckpt_timing"))
    own = [st[3] for st in rec2.steps[1:]]
    print(f"checkpoint: training step (one batch of 32, the same batch each "
          f"time) {steps['warm-up'] * 1e3:.1f} ms first, "
          f"{steps['without a save in flight'] * 1e3:.1f} ms without a save "
          f"in flight, "
          f"{steps['right after an async save'] * 1e3:.1f} ms right after an "
          f"async save that returned in {steps['save returned'] * 1e3:.1f} "
          f"ms (the write then took {steps['then finalize waited']:.2f} s "
          f"more); the resumed run's own steps "
          f"{', '.join(f'{x * 1e3:.1f}' for x in own)} ms [{card}]")

    # restore alone: read plus host-to-device, into run 2's live state
    t0 = time.perf_counter()
    ckpt.load_checkpoint(ba6, run2.train_state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    print(f"checkpoint: restore of ba{TRAIN_STEPS} (read and host-to-device"
          f" of {save6['bytes'] / 1e9:.2f} GB; the files were just written, "
          f"so the read may come from the page cache) {restore_s:.3f} s "
          f"({save6['bytes'] / restore_s / 1e9:.2f} GB/s) [{card}]")
    del run2, batches, batch
    gc.collect()
    torch.cuda.empty_cache()
    return _pretrained_serving(tmp, card, ba6, launches, safetensors)


def _write_pretrained_dir(pre: str, card: str, phase: str) -> tuple:
    """Write a full-width fp16 diffusers directory (unet/, vae/ with its
    encoder, text_encoder/) at `pre` from seeded random modules with the
    port's safetensors writer; returns (bytes, the towers' fp16 state
    dicts on the host)."""
    import gc

    import torch

    from diffusion_torch.models.models import stable_diffusion_2
    from diffusion_torch.utils import safetensors

    source = stable_diffusion_2(device=DEVICE, seed=1)
    t0 = time.perf_counter()
    towers, nbytes = {}, 0
    for name, fname in (("unet", "diffusion_pytorch_model.safetensors"),
                        ("vae", "diffusion_pytorch_model.safetensors"),
                        ("text_encoder", "model.safetensors")):
        half = {k: v.half().cpu() for k, v in
                getattr(source, name).state_dict().items()}
        os.makedirs(os.path.join(pre, name))
        nbytes += safetensors.save_file(half, os.path.join(pre, name, fname))
        if name != "unet":
            towers[name] = half
    write_s = time.perf_counter() - t0
    del source
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{phase}: pretrained directory (diffusers layout, fp16: unet/,"
          f" vae/ encoder and decoder, text_encoder/) "
          f"{nbytes / 1e9:.3f} GB written in {write_s:.2f} s [{card}]")
    return nbytes, towers


def _pretrained_serving(tmp: str, card: str, ba6: str, launches: dict,
                        safetensors) -> dict:
    """Write a full-width fp16 diffusers directory from seeded random
    modules, build the endpoint from it with the checkpoint's UNet, and
    serve one 512px request over HTTP."""
    import gc

    import torch

    from diffusion_torch.inference.inference_model import \
        StableDiffusionInference

    pre = os.path.join(tmp, "sd2_fp16")
    nbytes, towers = _write_pretrained_dir(pre, card, "checkpoint")

    t0 = time.perf_counter()
    endpoint = StableDiffusionInference(
        model_name=pre, pretrained=True, checkpoint_path=ba6,
        default_size=SIZE, device=DEVICE, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    model = endpoint.model
    want = safetensors.load_file(os.path.join(ba6, "state",
                                              "params.safetensors"))
    unet_bad = [n for n, p in model.unet.named_parameters()
                if not torch.equal(p, want[n].to(p.device))]
    tower_bad = [f"{name}.{k}" for name, half in towers.items()
                 for k, v in getattr(model, name).state_dict().items()
                 if v.dtype != torch.float32
                 or not torch.equal(v, half[k].to(v.device).float())]
    print(f"checkpoint: endpoint from the pretrained directory and "
          f"ba{TRAIN_STEPS} built in {build_s:.2f} s (the load of "
          f"{nbytes / 1e9:.2f} GB of fp16 weights and the checkpoint's UNet "
          f"included); UNet tensors unequal to the checkpoint's: "
          f"{len(unet_bad)} of {len(want)}; tower tensors unequal to the "
          f"fp16 values in fp32: {len(tower_bad)} [{card}]")
    _check(not unet_bad and len(want) == len(
        list(model.unet.parameters())) and not tower_bad,
           f"the endpoint does not serve the checkpoint's UNet and the "
           f"pretrained towers: {unet_bad[:5]} {tower_bad[:5]}")

    seconds, served, latents = _serve_once(endpoint)
    print(f"checkpoint: served one {SIZE}px request ({STEPS} steps) from the "
          f"checkpoint: HTTP 200, {SIZE}x{SIZE} PNG, latents {latents} "
          f"finite before the decode, {seconds:.3f} s end to end; kernel "
          f"launches {json.dumps(served)} [{card}]")
    for name in ("group_norm", "flash_attention"):
        _check(served[name] > 0, f"{name} kernel was not launched while "
               f"serving the checkpoint")
    free = shutil.disk_usage(tmp).free
    print(f"checkpoint: disk free at the phase's end (before its directory "
          f"is deleted) {free / 1e9:.2f} GB")
    del endpoint, model
    gc.collect()
    torch.cuda.empty_cache()
    return {k: launches[k] + served[k] for k in launches}


# ---------------- phases 12-14: LoRA, the readers, pixel diffusion --------

LORA_TRAIN, LORA_EVAL = 256, 64          # raw JPEG + caption MDS samples
READER_STEPS = 4                         # batches of the reader runs
PEXELS_SAMPLES = 160                     # records of the Pexels manifest
PEXELS_MISSING_EVERY = 32                # records that also name a lost file
PIXEL_SIZE, PIXEL_BATCH, PIXEL_MICRO, PIXEL_STEPS = 64, 16, 8, 3


def _write_raw_shards(path: str, n: int, rng) -> int:
    """The image-caption reader's MDS columns (`image` JPEG bytes of the
    wds sizes, `caption` "raw sample <i>") with the port's MDSWriter;
    returns the bytes written."""
    from diffusion_torch.data.mds import MDSWriter
    with MDSWriter(path, {"image": "bytes", "caption": "str"},
                   size_limit=1 << 23) as w:
        for i in range(n):
            width, height = _WDS_SIZES[i % len(_WDS_SIZES)]
            w.write({"image": _jpeg(_smooth_image(rng, height, width)),
                     "caption": f"raw sample {i}"})
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


class LoraRecord(ComposedRecord):
    """ComposedRecord for the LoRA run, and: the UNet's base and adapter
    parameters when the fit starts (copies on the card), held against the
    live ones when it ends; the first training batch."""

    def __init__(self):
        super().__init__()
        self.first_batch = None
        self.base = self.adapters = None
        self.base_unchanged = self.adapters_changed = None
        self.trainable = 0

    def run_event(self, event, state, logger) -> None:
        import torch

        from diffusion_torch.models.lora import is_lora_key
        name = event.value
        unet = state.model.unet
        if name == "fit_start":
            self.base = {n: p.detach().clone()
                         for n, p in unet.named_parameters()
                         if not is_lora_key(n)}
            self.adapters = {n: p.detach().clone()
                             for n, p in unet.named_parameters()
                             if is_lora_key(n)}
            self.trainable = sum(p.numel() for p in
                                 state.train_state.params.values())
        elif name == "after_dataloader" and self.first_batch is None:
            self.first_batch = {k: v.clone() for k, v in state.batch.items()}
        elif name == "fit_end":
            live = dict(unet.named_parameters())
            self.base_unchanged = all(torch.equal(live[n], p)
                                      for n, p in self.base.items())
            self.adapters_changed = sum(
                not torch.equal(live[n], p) for n, p in self.adapters.items())
            self.base = None
        super().run_event(event, state, logger)


def _serve_once(endpoint) -> tuple:
    """One 512px 20-step request to `endpoint` over HTTP on localhost:
    HTTP 200, a 512x512 RGB PNG, finite latents before the decode.
    Returns (seconds, the five kernels' launches, the decoded latents'
    shape)."""
    import torch
    from PIL import Image

    from diffusion_torch.inference.serve import make_server
    decoded = []
    hook = endpoint.model.vae.post_quant_conv.register_forward_pre_hook(
        lambda mod, inp: decoded.append(
            (tuple(inp[0].shape), bool(torch.isfinite(inp[0]).all()))))
    server = make_server(endpoint, "127.0.0.1", 0, max_batch_size=1,
                         batch_wait_ms=0.0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    counters, results = _counters(), {}
    try:
        for c in counters.values():
            c.reset()
        _post(server.server_address[1], {
            "prompt": "a lighthouse on a cliff at dusk",
            "num_inference_steps": STEPS, "guidance_scale": 7.5, "seed": 0,
            "height": SIZE, "width": SIZE}, results, "request")
        torch.cuda.synchronize()
        launches = {name: c.value for name, c in counters.items()}
    finally:
        hook.remove()
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    _check("request" in results, "the request got no response")
    status, body, seconds = results["request"]
    _check(status == 200, f"HTTP {status} {body}")
    img = Image.open(io.BytesIO(base64.b64decode(body["images"][0])))
    img.load()
    _check(img.size == (SIZE, SIZE) and img.mode == "RGB",
           f"PNG {img.size} {img.mode}")
    _check(len(decoded) == 1 and decoded[0][1],
           f"latents before the decode not finite: {decoded}")
    return seconds, launches, decoded[0][0]


def _lora_overrides(pre: str, raw: str, coco: str, save: str,
                    metrics_file: str) -> list:
    """The dotted overrides of phase 12's run of
    yamls/SD-2-base-256-lora.yaml: global batch 32 in microbatches of 16,
    the pretrained directory `pre`, raw JPEG + caption MDS shards `raw`,
    the COCO eval over `coco`, 6 batches with an eval and a save every 3
    into `save`, a FileLogger and the LoraRecord callback."""
    return [
        f"batch_size={TRAIN_BATCH}",
        f"trainer.device_train_microbatch_size={TRAIN_MICRO}",
        "model.pretrained=true", f"model.model_name={pre}",
        f"dataset.train_dataset.remote={raw}",
        f"dataset.train_dataset.local={raw}",
        "dataset.train_dataset.num_workers=2",
        f"dataset.eval_dataset.remote={coco}",
        f"dataset.eval_dataset.local={coco}",
        "dataset.eval_dataset.num_workers=2",
        f"dataset.eval_dataset.batch_size={TRAIN_BATCH}",
        f"dataset.eval_batch_size={TRAIN_BATCH}",
        f"trainer.max_duration={TRAIN_STEPS}ba",
        f"trainer.eval_interval={COMPOSED_EVAL_AT}ba",
        f"trainer.save_folder={save}",
        f"trainer.save_interval={COMPOSED_EVAL_AT}ba",
        "+logger.file._target_=diffusion_tpu.utils.logging.FileLogger",
        f"+logger.file.filename={metrics_file}",
        f"+callbacks.chip_smoke._target_={__name__}.LoraRecord"]


def _pexels_overrides(manifest: str, traces: str) -> list:
    """Phase 13's overrides of yamls/SD-2-base-256-pexels.yaml: global
    batch 32 in microbatches of 16 over the Pexels `manifest`, 4 batches,
    `log_traces`, a TorchProfiler of batches 1-2 into `traces`, the
    ReaderRecord callback."""
    return [
        f"batch_size={TRAIN_BATCH}",
        f"trainer.device_train_microbatch_size={TRAIN_MICRO}",
        f"dataset.train_dataset.meta_json={manifest}",
        f"dataset.eval_dataset.meta_json={manifest}",
        f"trainer.max_duration={READER_STEPS}ba",
        "trainer.log_traces=true",
        "+callbacks.trace._target_="
        "diffusion_torch.utils.profiler.TorchProfiler",
        f"+callbacks.trace.trace_dir={traces}",
        "+callbacks.trace.start_batch=1",
        "+callbacks.trace.num_batches=2",
        f"+callbacks.chip_smoke._target_={__name__}.ReaderRecord"]


def _mix_overrides(manifest: str, sources: dict, coco: str) -> list:
    """Phase 13's overrides of yamls/SD-2-base-256-mixdata.yaml: global
    batch 32 (its microbatch is 16), the Pexels `manifest` and the tar
    shard directories of `sources` (laion, coyo, cc), the COCO eval over
    `coco` after batch 2 of 4, the ReaderRecord callback."""
    return [
        f"batch_size={TRAIN_BATCH}",
        f"dataset.train_dataset.datapipes.pexels.meta_json={manifest}",
        *[f"dataset.train_dataset.datapipes.{name}.urls={path}"
          for name, path in sources.items()],
        f"dataset.eval_dataset.remote={coco}",
        f"dataset.eval_dataset.local={coco}",
        "+dataset.eval_dataset.num_workers=2",
        f"dataset.eval_dataset.batch_size={TRAIN_BATCH}",
        f"dataset.eval_batch_size={TRAIN_BATCH}",
        f"trainer.max_duration={READER_STEPS}ba",
        "trainer.eval_interval=2ba",
        f"+callbacks.chip_smoke._target_={__name__}.ReaderRecord"]


def _lora_phase(card: str, online: dict) -> dict:
    """Phase 12: yamls/SD-2-base-256-lora.yaml unedited through the port's
    loader and `train(config)` over a pretrained directory, then an
    endpoint serving the adapter checkpoint, then the folded adapter;
    returns the five kernels' launches in the phase."""
    import gc
    import tempfile

    import numpy as np
    import torch

    from diffusion_torch.inference.inference_model import \
        StableDiffusionInference
    from diffusion_torch.models.lora import (fold_lora, is_lora_key,
                                             lora_parameters)
    from diffusion_torch.models.models import stable_diffusion_2
    from diffusion_torch.models.unet import SD2_BASE_UNET, UNet2DCondition
    from diffusion_torch.train import checkpoint as ckpt
    from diffusion_torch.utils import safetensors

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lora_",
                                     dir=os.path.join(_ROOT, "build")) as tmp:
        pre = os.path.join(tmp, "sd2_fp16")
        _write_pretrained_dir(pre, card, "lora")
        rng = np.random.default_rng(12)
        t0 = time.perf_counter()
        raw, coco = os.path.join(tmp, "raw"), os.path.join(tmp, "coco")
        nb = _write_raw_shards(raw, LORA_TRAIN, rng)
        nb_eval = _write_coco_shards(coco, LORA_EVAL, rng)
        print(f"lora: wrote {LORA_TRAIN} raw JPEG + caption samples and "
              f"{LORA_EVAL} COCO samples ({nb / 1e6:.1f} + "
              f"{nb_eval / 1e6:.1f} MB of MDS shards) in "
              f"{time.perf_counter() - t0:.1f} s on the host [{card}]")
        save = os.path.join(tmp, "ckpt")
        trainer, record, launches, wall, peak, records = _yaml_run(
            "lora", "SD-2-base-256-lora.yaml", _lora_overrides(
                pre, raw, coco, save, os.path.join(tmp, "metrics.jsonl")),
            TRAIN_STEPS, card)
        save_stats = ckpt.last_save_stats()
        model = trainer.model
        ba6 = os.path.join(save, f"ba{TRAIN_STEPS}")
        ckpt_bytes = sum(os.path.getsize(os.path.join(r, f))
                         for r, _, fs in os.walk(ba6) for f in fs)
        n_adapter = sum(p.numel() for p in lora_parameters(model.unet).values())
        print(f"lora: model {type(model).__name__}, UNet lora_rank "
              f"{model.unet.config.lora_rank} (alpha "
              f"{model.unet.config.lora_alpha}), train_lora_only "
              f"{model.train_lora_only}; trainable parameters "
              f"{record.trainable:,} ({len(trainer.train_state.params)} "
              f"tensors; the adapters hold {n_adapter:,}) of "
              f"{sum(p.numel() for p in model.unet.parameters()):,} in the "
              f"UNet; optimizer moments {len(trainer.train_state.optimizer.mu)}"
              f" tensors")
        _check(record.trainable == n_adapter and all(
            is_lora_key(n) for n in trainer.train_state.params),
            "the trainer trains more than the adapters")
        print(f"lora: base parameters bit-unchanged after the run "
              f"{record.base_unchanged}; adapter tensors changed "
              f"{record.adapters_changed} of {len(record.adapters)}")
        _check(record.base_unchanged and record.adapters_changed > 0,
               "the base changed or the adapters did not")
        evals = [r for r in records if "metrics/eval/MeanSquaredError" in r]
        _check(len(evals) == 1 and math.isfinite(
            evals[0]["metrics/eval/MeanSquaredError"]),
            f"expected one finite eval: {evals}")

        # step 1's loss against the pretrained model without adapters, on
        # the same batch and the Trainer's draws for step 0
        batch, n_accum = record.first_batch, TRAIN_BATCH // TRAIN_MICRO
        gen = trainer._generator(trainer.seed, 0)
        del trainer, model
        gc.collect()
        plain = stable_diffusion_2(pretrained=True, model_name=pre,
                                   device=DEVICE)
        with torch.no_grad():
            loss0 = sum(float(plain.loss_fn(
                {k: v[i * TRAIN_MICRO:(i + 1) * TRAIN_MICRO]
                 for k, v in batch.items()}, gen)) for i in range(n_accum))
        loss0 /= n_accum
        got0 = record.steps[0][0]["loss/train/total"]
        rel0 = abs(got0 - loss0) / abs(loss0)
        print(f"lora: step 1's loss {got0!r} beside the pretrained model's "
              f"without adapters on the same batch and draws {loss0!r}: "
              f"relative difference {rel0:.3e} (bound 1e-3; bit-equal "
              f"{got0 == loss0})")
        _check(rel0 < 1e-3, "a fresh adapter is not the pretrained model")
        del plain, batch
        record.first_batch = None
        gc.collect()
        torch.cuda.empty_cache()

        times, step_s, wait_s = record.step_times(skip=(COMPOSED_EVAL_AT,))
        _, eval_s, eval_launches = record.evals[0]
        fit_launches = {k: launches[k] - eval_launches[k] for k in launches}
        print(f"lora: SD-2-base {TRAIN_SIZE}px from raw images, adapters "
              f"only, global batch {TRAIN_BATCH} in microbatches of "
              f"{TRAIN_MICRO}: run {wall:.2f} s (the build and the "
              f"pretrained load included); step time after the first "
              f"{step_s * 1e3:.1f} ms (steps: "
              f"{', '.join(f'{x * 1e3:.1f}' for x in times)} ms, the one "
              f"after the eval and its save left out), "
              f"{TRAIN_BATCH / step_s:.2f} samples/s, against phase 8b's "
              f"{online['step_s'] * 1e3:.1f} ms and "
              f"{TRAIN_BATCH / online['step_s']:.2f} samples/s; loader wait "
              f"{wait_s * 1e3:.1f} ms a step; peak device memory {peak:.2f} "
              f"GiB against phase 8b's {online['peak']:.2f} GiB "
              f"({online['peak'] - peak:.2f} GiB less) [{card}]")
        print(f"lora: checkpoint ba{TRAIN_STEPS} (adapter params, mu, nu) "
              f"{ckpt_bytes / 1e6:.2f} MB; its save: "
              f"{json.dumps(save_stats)} [{card}]")
        _check(ckpt_bytes < 50e6, "the adapter checkpoint is not small")
        print(f"lora: kernel launches during the fit "
              f"{json.dumps(fit_launches)} (per step " + json.dumps(
                  {k: v / TRAIN_STEPS for k, v in fit_launches.items()})
              + f"); during the eval {json.dumps(eval_launches)} in "
              f"{eval_s * 1e3:.1f} ms [{card}]")
        for name in launches:
            _check(fit_launches[name] > 0,
                   f"{name} kernel was not launched during the LoRA fit")

        # serve the adapter checkpoint over the pretrained base
        t0 = time.perf_counter()
        endpoint = StableDiffusionInference(
            model_name=pre, pretrained=True, checkpoint_path=ba6,
            lora_rank=8, train_lora_only=True, default_size=SIZE,
            device=DEVICE, seed=0)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        unet = endpoint.model.unet
        want = safetensors.load_file(os.path.join(ba6, "state",
                                                  "params.safetensors"))
        bad = [n for n, p in lora_parameters(unet).items()
               if not torch.equal(p, want[n].to(p.device))]
        print(f"lora: endpoint (lora_rank 8, the pretrained directory, "
              f"ba{TRAIN_STEPS}) built in {build_s:.2f} s; adapter tensors "
              f"unequal to the checkpoint's: {len(bad)} of {len(want)} "
              f"[{card}]")
        _check(not bad and sorted(want) == sorted(lora_parameters(unet)),
               f"the endpoint does not serve the checkpoint's adapters: "
               f"{bad[:5]}")
        seconds, served, latents = _serve_once(endpoint)
        print(f"lora: served one {SIZE}px request ({STEPS} steps) with the "
              f"adapter: HTTP 200, {SIZE}x{SIZE} PNG, latents {latents} "
              f"finite before the decode, {seconds:.3f} s end to end; kernel "
              f"launches {json.dumps(served)} [{card}]")
        for name in ("group_norm", "flash_attention"):
            _check(served[name] > 0, f"{name} kernel was not launched while "
                   f"serving the adapter")

        # fold the adapter into a rank-0 UNet: one CFG step against the
        # adapter UNet's, for the trained adapter and for one whose B is
        # redrawn (a few warm-up steps leave the trained B near zero); in
        # bf16 (the served dtype, held to phase 4's bf16 bound: a 1-ulp
        # change anywhere moves this random-weight UNet's output by about
        # 2e-2) and in fp32 (TF32 off: the fold's own error)
        gen = torch.Generator(device=DEVICE).manual_seed(5)
        lat = torch.randn((2, 4, SIZE // 8, SIZE // 8), generator=gen,
                          device=DEVICE).contiguous(
                              memory_format=torch.channels_last)
        t = torch.full((2,), 500, device=DEVICE, dtype=torch.int64)
        ctx = torch.randn((2, 77, 1024), generator=gen, device=DEVICE)
        with torch.device(DEVICE):
            folded_unet = UNet2DCondition(SD2_BASE_UNET,
                                          dtype=torch.bfloat16).eval()
        b_params = {n: p for n, p in lora_parameters(unet).items()
                    if n.endswith("_lora_b.weight")}
        trained_b = {n: p.detach().clone() for n, p in b_params.items()}
        bounds = {torch.bfloat16: 5e-2, torch.float32: 1e-4}

        def cfg_step(module, dtype):
            module.dtype = dtype         # the compute dtype; weights stay fp32
            try:
                with torch.inference_mode():
                    return module(lat, t, ctx).float()
            finally:
                module.dtype = torch.bfloat16

        with torch.no_grad():
            for p in b_params.values():
                p.zero_()
        base_out = {d: cfg_step(unet, d) for d in bounds}
        for label in ("trained", "B redrawn ~ N(0, 0.02)"):
            with torch.no_grad():
                for n, p in b_params.items():
                    if label == "trained":
                        p.copy_(trained_b[n])
                    else:
                        p.normal_(0.0, 0.02, generator=gen)
            folded_unet.load_state_dict(fold_lora(unet, config=unet.config))
            for dtype, bound in bounds.items():
                want_out = cfg_step(unet, dtype)
                err = _rel_l2(cfg_step(folded_unet, dtype), want_out)
                print(f"lora: folded rank-0 UNet vs the adapter UNet, one "
                      f"CFG step at {SIZE}px batch 2, {dtype}, adapter "
                      f"{label}: relative L2 {err:.3e} (bound {bound:g}; "
                      f"the adapter moves the output by "
                      f"{_rel_l2(want_out, base_out[dtype]):.3e} from the "
                      f"base's) [{card}]")
                _check(err < bound,
                       "the folded UNet disagrees with the adapter UNet")
        del endpoint, unet, folded_unet, b_params, trained_b
        gc.collect()
        torch.cuda.empty_cache()
    print(f"lora: phase {time.perf_counter() - t_phase:.1f} s [{card}]")
    return {k: launches[k] + served[k] for k in launches}


def _write_pexels_manifest(path: str, n: int, rng) -> tuple:
    """JPEGs of the wds sizes under `path` and a JSON manifest of per-sample
    records (`local_paths`, two `prompts`, up to 7 `tags`); every
    PEXELS_MISSING_EVERY-th record also names a file that does not exist,
    so the reader's random choice among `local_paths` drops it about half
    the time (after its retries). Returns (manifest, bytes)."""
    os.makedirs(path, exist_ok=True)
    records, nbytes = [], 0
    for i in range(n):
        w, h = _WDS_SIZES[i % len(_WDS_SIZES)]
        jpg = os.path.join(path, f"{i:06d}.jpg")
        with open(jpg, "wb") as f:
            f.write(_jpeg(_smooth_image(rng, h, w)))
        nbytes += os.path.getsize(jpg)
        paths = [jpg]
        if i % PEXELS_MISSING_EVERY == 7:
            paths.append(os.path.join(path, f"missing-{i:06d}.jpg"))
        records.append({"local_paths": paths,
                        "prompts": [f"pexels photo {i}", f"pexels shot {i}"],
                        "tags": [f"tag{j}" for j in range(i % 8)]})
    manifest = os.path.join(path, "manifest.json")
    with open(manifest, "w") as f:
        json.dump({"samples": records}, f)
    return manifest, nbytes


class ReaderRecord(ComposedRecord):
    """ComposedRecord for the reader runs, and, for a mixture loader, the
    samples each source yields (counted where the multiplexer pulls
    them)."""

    def __init__(self):
        super().__init__()
        self.drawn = {}

    def run_event(self, event, state, logger) -> None:
        if event.value == "fit_start":
            for child in getattr(self.loader, "pipes_to_weights", {}):
                self.drawn[child.name] = 0
                child.pipe = _Counted(child.pipe, self.drawn, child.name)
        super().run_event(event, state, logger)


class _Counted:
    """An iterable that counts what it yields into `counts[name]`."""

    def __init__(self, pipe, counts: dict, name: str):
        self.pipe, self.counts, self.name = pipe, counts, name

    def __iter__(self):
        for item in self.pipe:
            self.counts[self.name] += 1
            yield item


def _reader_summary(label: str, run: tuple, card: str, skip=()) -> None:
    """A reader run's line (`_yaml_run`'s `run`): step times, loader waits,
    peak memory and launches, all five kernels launched."""
    _, record, launches, wall, peak, _ = run
    times, step_s, _ = record.step_times(skip)
    waits = record.waits[1:]
    print(f"{label}: SD-2-base {TRAIN_SIZE}px, global batch {TRAIN_BATCH} in "
          f"microbatches of {TRAIN_MICRO}: run {wall:.2f} s (build "
          f"included); step time after the first {step_s * 1e3:.1f} ms "
          f"(steps: {', '.join(f'{x * 1e3:.1f}' for x in times)} ms), "
          f"{TRAIN_BATCH / step_s:.2f} samples/s; loader wait a step after "
          f"the first {', '.join(f'{w * 1e3:.1f}' for w in waits)} ms "
          f"(first {record.waits[0] * 1e3:.1f} ms); peak device memory "
          f"{peak:.2f} GiB; kernel launches {json.dumps(launches)} [{card}]")
    for name in launches:
        _check(launches[name] > 0,
               f"{name} kernel was not launched during the {label} run")


def _readers_phase(card: str) -> dict:
    """Phase 13: yamls/SD-2-base-256-pexels.yaml (with `log_traces` and a
    profiler callback from batch 1) and yamls/SD-2-base-256-mixdata.yaml,
    unedited, over data written here; returns the five kernels' launches
    in the phase."""
    import gc
    import tempfile

    import numpy as np
    import torch

    from diffusion_torch.utils.profiler import TorchProfiler

    t_phase = time.perf_counter()
    total = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_readers_") as tmp:
        rng = np.random.default_rng(13)
        t0 = time.perf_counter()
        manifest, nb = _write_pexels_manifest(os.path.join(tmp, "pexels"),
                                              PEXELS_SAMPLES, rng)
        sources = {}
        for k, name in enumerate(("laion", "coyo", "cc")):
            sources[name], _, nb_src = _write_wds_shards(
                os.path.join(tmp, name), ONLINE_TRAIN, rng,
                start=10000 * (k + 1))
            nb += nb_src
        coco = os.path.join(tmp, "coco")
        nb += _write_coco_shards(coco, COMPOSED_EVAL, rng)
        print(f"readers: wrote a Pexels manifest of {PEXELS_SAMPLES} "
              f"records (1 in {PEXELS_MISSING_EVERY} also names a missing "
              f"file), three tar-shard sources of {ONLINE_TRAIN} samples "
              f"each and {COMPOSED_EVAL} COCO samples ({nb / 1e6:.1f} MB) "
              f"in {time.perf_counter() - t0:.1f} s on the host [{card}]")

        # the Pexels run, with log_traces and a trace of batches 1-2
        traces = os.path.join(tmp, "traces")
        run = _yaml_run("pexels", "SD-2-base-256-pexels.yaml",
                        _pexels_overrides(manifest, traces), READER_STEPS,
                        card)
        _reader_summary("pexels", run, card)
        trainer, launches = run[0], run[2]
        profs = [c for c in trainer.engine.callbacks
                 if isinstance(c, TorchProfiler)]
        default = [p for p in profs if p.start_batch == 10]
        ours = [p for p in profs if p.start_batch == 1]
        _check(len(default) == 1 and default[0].trace_path is None
               and len(ours) == 1 and ours[0].trace_path,
               "log_traces did not add the default profiler, or the "
               "batch-1 profiler wrote no trace")
        path = ours[0].trace_path
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        ours_k = sum(1 for e in kernels
                     if any(k in e["name"] for k in ("gn_fwd", "gn_bwd",
                                                     "flash_")))
        print(f"pexels: log_traces added TorchProfiler(start_batch=10, "
              f"num_batches=3), which a {READER_STEPS}-batch run never "
              f"starts; TorchProfiler(start_batch=1, num_batches=2) wrote "
              f"{os.path.relpath(path, tmp)} ({os.path.getsize(path) / 1e6:.2f}"
              f" MB, {len(events)} events, {len(kernels)} CUDA kernel "
              f"events, {ours_k} of them the GroupNorm and flash kernels); "
              f"the traced steps 2-3 carry the profiler's own cost and the "
              f"trace's export [{card}]")
        _check(ours_k > 0, "the trace holds none of the port's kernels")
        total = dict(launches)
        del trainer, run
        gc.collect()
        torch.cuda.empty_cache()

        # the mixture run: the manifest and the three tar sources
        run = _yaml_run("mixdata", "SD-2-base-256-mixdata.yaml",
                        _mix_overrides(manifest, {
                            k: os.path.dirname(m)
                            for k, m in sources.items()}, coco),
                        READER_STEPS, card)
        _reader_summary("mixdata", run, card, skip=(2,))
        trainer, record, launches = run[:3]
        weights = {child.name: w for child, w in
                   trainer.train_dataloader.pipes_to_weights.items()}
        drawn = record.drawn
        n = sum(drawn.values())
        print(f"mixdata: samples drawn per source "
              + ", ".join(f"{k} {drawn[k]} ({drawn[k] / max(n, 1):.4f})"
                          for k in weights)
              + f" of {n}, beside the normalized weights "
              + ", ".join(f"{k} {w:.4f}" for k, w in weights.items()))
        _check(n >= READER_STEPS * TRAIN_BATCH and drawn["laion"] > 0
               and abs(sum(weights.values()) - 1.0) < 1e-9,
               f"the mixture drew too few samples: {drawn}")
        _check(len(record.evals) == 1, "expected one eval on COCO")
        total = {k: total[k] + launches[k] for k in total}
        del trainer, record, run
        gc.collect()
        torch.cuda.empty_cache()
    print(f"readers: phase {time.perf_counter() - t_phase:.1f} s [{card}]")
    return total


def _pixel_phase(card: str) -> dict:
    """Phase 14: both pixel-space models at full width and 64x64 pixels:
    3 training steps each through `Trainer.fit()`, then 2 prompts sampled
    at 20 steps (DDIM; the SDE and the ODE); returns the five kernels'
    launches in the phase."""
    import dataclasses
    import gc

    import torch

    from diffusion_torch.models.models import (continuous_pixel_diffusion,
                                               discrete_pixel_diffusion)
    from diffusion_torch.ops import attention as attn_mod
    from diffusion_torch.schedulers import ContinuousTimeScheduler
    from diffusion_torch.train.optim import adamw
    from diffusion_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    total = {}
    flash_shapes = []
    with _patch(attn_mod, "flash_attention", _shape_spy(flash_shapes)):
        for label, build in (("discrete", discrete_pixel_diffusion),
                             ("continuous", continuous_pixel_diffusion)):
            t0 = time.perf_counter()
            model = build(device=DEVICE, seed=0)
            n_unet = sum(p.numel() for p in model.unet.parameters())
            n_text = sum(p.numel() for p in model.text_encoder.parameters())
            print(f"pixel {label}: built in {time.perf_counter() - t0:.1f} s:"
                  f" UNet {n_unet / 1e6:.1f}M ({model.unet.config.in_channels}"
                  f" channels, cross-attention "
                  f"{model.unet.config.cross_attention_dim}), CLIP ViT-L/14 "
                  f"text {n_text / 1e6:.1f}M, compute {model.unet.dtype}; "
                  f"schedulers {type(model.noise_scheduler).__name__} / "
                  f"{type(model.inference_scheduler).__name__} [{card}]")
            gen = torch.Generator(device=DEVICE).manual_seed(14)
            prompts = [f"a pixel-space photo number {i}"
                       for i in range(PIXEL_BATCH)]
            ids = torch.from_numpy(
                model.tokenizer(prompts)["input_ids"]).to(DEVICE)
            batches = [{"image": torch.rand(
                (PIXEL_BATCH, PIXEL_SIZE, PIXEL_SIZE, 3), generator=gen,
                device=DEVICE) * 2 - 1, "captions": ids}
                for _ in range(PIXEL_STEPS)]
            record = ComposedRecord()
            trainer = Trainer(model=model, train_dataloader=batches,
                              optimizers=adamw(lr=1e-4, weight_decay=0.01),
                              callbacks=[record],
                              max_duration=f"{PIXEL_STEPS}ba",
                              device_train_microbatch_size=PIXEL_MICRO,
                              seed=17, image_size=PIXEL_SIZE, device=DEVICE)
            counters = _counters()
            for c in counters.values():
                c.reset()
            flash_shapes.clear()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            trainer.fit()
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            launches = {name: c.value for name, c in counters.items()}
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            top = sorted({q[1] for q, _ in flash_shapes})
            _check_steps(f"pixel {label}", record, PIXEL_STEPS, card)
            _, step_s, _ = record.step_times()
            print(f"pixel {label}: {PIXEL_SIZE}x{PIXEL_SIZE} pixels, batch "
                  f"{PIXEL_BATCH} in microbatches of {PIXEL_MICRO}: "
                  f"{PIXEL_STEPS} steps in {fit_s:.2f} s, step time after "
                  f"the first {step_s * 1e3:.1f} ms "
                  f"({PIXEL_BATCH / step_s:.2f} samples/s), peak device "
                  f"memory {peak:.2f} GiB; kernel launches "
                  f"{json.dumps(launches)}; flash query lengths {top} "
                  f"[{card}]")
            for name in launches:
                _check(launches[name] > 0, f"pixel {label}: {name} kernel "
                       f"was not launched during the fit")
            _check(PIXEL_SIZE * PIXEL_SIZE in top,
                   f"pixel {label}: no flash call at S = 4096: {top}")
            total = {k: total.get(k, 0) + v for k, v in launches.items()}
            del trainer, batches
            gc.collect()

            samplers = [("ddim" if label == "discrete" else "sde", model)]
            if label == "continuous":
                sched = model.inference_scheduler
                samplers.append(("ode", dataclasses.replace(
                    model, inference_scheduler=ContinuousTimeScheduler(
                        t_max=sched.t_max,
                        prediction_type=sched.prediction_type,
                        use_ode=True))))
            model.unet.eval()
            for name, m in samplers:
                m.generate(ids[:2], height=PIXEL_SIZE, width=PIXEL_SIZE,
                           num_inference_steps=1, seed=0)     # warm-up
                for c in counters.values():
                    c.reset()
                flash_shapes.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                images = m.generate(ids[:2], height=PIXEL_SIZE,
                                    width=PIXEL_SIZE, guidance_scale=3.0,
                                    num_inference_steps=STEPS, seed=0)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                served = {k: c.value for k, c in counters.items()}
                ok = bool(torch.isfinite(images).all()) and float(
                    images.min()) >= 0.0 and float(images.max()) <= 1.0
                print(f"pixel {label} {name}: 2 prompts, {STEPS} steps, "
                      f"guidance 3.0: {tuple(images.shape)} images, finite "
                      f"in [0, 1] {ok}, {seconds:.3f} s; kernel launches "
                      f"{json.dumps(served)}, flash at S = "
                      f"{sorted({q[1] for q, _ in flash_shapes})} [{card}]")
                _check(ok and images.shape == (2, PIXEL_SIZE, PIXEL_SIZE, 3),
                       f"pixel {label} {name}: bad images")
                _check(served["group_norm"] > 0 and
                       served["flash_attention"] > 0,
                       f"pixel {label} {name}: a forward kernel was not "
                       f"launched")
                total = {k: total[k] + v for k, v in served.items()}
            del model, samplers, m
            gc.collect()
            torch.cuda.empty_cache()
    print(f"pixel: phase {time.perf_counter() - t_phase:.1f} s [{card}]")
    return total


# ---------------- phase 15: the main recipe end to end ----------------

RECIPE_RAW = 128          # raw JPEG + caption samples, short sides >= 512
RECIPE_COCO = 16          # COCO images of phase 2's 512px eval
RECIPE_SIDES = ((512, 512), (640, 512), (512, 704), (768, 576))
RECIPE_JOB_BATCH = 32     # the precompute job's --batch-size (its default)
RECIPE_P1_STEPS = 3       # phase 1 (256px) batches, saved after the last
RECIPE_P2_BATCH = 16      # phase 2's global batch (2048 cut); microbatch 8
RECIPE_P2_STEPS = 4
RECIPE_P2_EVAL_AT = 2
RECIPE_P2_EVAL_BATCH = 8  # the 512 yaml's COCO reader batch


def _write_recipe_sources(tmp: str, rng) -> dict:
    """The recipe's inputs under `tmp`: a LAION-style MDS of raw JPEGs and
    captions (`jpg`, `caption`; every short side >= 512, the bucket the
    recipe precomputes) and a COCO-style `captions_val2014.json` with its
    image directory. Returns their paths and sizes."""
    from diffusion_torch.data.mds import MDSWriter
    raw = os.path.join(tmp, "raw")
    with MDSWriter(raw, {"jpg": "bytes", "caption": "str"},
                   size_limit=1 << 23) as w:
        for i in range(RECIPE_RAW):
            width, height = RECIPE_SIDES[i % len(RECIPE_SIDES)]
            w.write({"jpg": _jpeg(_smooth_image(rng, height, width)),
                     "caption": f"a photo of recipe sample {i}"})
    images = os.path.join(tmp, "val2014")
    os.makedirs(images)
    anns = {"images": [], "annotations": []}
    for i in range(RECIPE_COCO):
        name = f"COCO_val2014_{i:012d}.jpg"
        width, height = RECIPE_SIDES[i % len(RECIPE_SIDES)]
        with open(os.path.join(images, name), "wb") as f:
            f.write(_jpeg(_smooth_image(rng, height, width)))
        anns["images"].append({"id": i, "file_name": name})
        anns["annotations"] += [{"id": 5 * i + k, "image_id": i,
                                 "caption": f"coco image {i}, caption {k}"}
                                for k in range(5)]
    annotations = os.path.join(tmp, "captions_val2014.json")
    with open(annotations, "w") as f:
        json.dump(anns, f)
    return {"raw": raw, "images": images, "annotations": annotations,
            "raw_bytes": _dir_bytes(raw), "coco_bytes": _dir_bytes(images)}


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(path) for f in fs)


def _precompute_args(src: dict, tmp: str, pre: str) -> list:
    """`python -m diffusion_torch.scripts.precompute_latents`'s arguments:
    the raw shards through a local cache (released as consumed), the 256
    and 512 sizes, the towers from the pretrained directory `pre`."""
    return ["--remote", src["raw"], "--local", os.path.join(tmp, "cache"),
            "--out", os.path.join(tmp, "latents"), "--sizes", "256", "512",
            "--batch-size", str(RECIPE_JOB_BATCH), "--model-name", pre]


def _recipe_overrides(phase: int, shards: str, ckpt_dir: str, coco: str,
                      metrics_file: str) -> list:
    """The dotted overrides of phase 15's two runs. Phase 1
    (yamls/SD-2-base-256.yaml): global batch 32 over the job's shards, 3
    batches, no eval, a save after the last into `ckpt_dir`. Phase 2
    (yamls/SD-2-base-512.yaml): global batch 16 in the yaml's microbatches
    of 8, warm-started from `ckpt_dir`/ba3 (the yaml's
    `load_weights_only: true`), 4 batches, the yaml's COCO eval (batch 8)
    over the convert_coco shards `coco` after batch 2, with
    `+model.init_frozen_towers=true`: the yaml's precomputed latents and
    `val_guidance_scales: []` build no VAE (reference fault 9). Both log
    to `metrics_file` and record through a callback."""
    common = [f"dataset.train_dataset.remote={shards}",
              f"dataset.train_dataset.local={shards}",
              "dataset.train_dataset.num_workers=2",
              "+logger.file._target_=diffusion_tpu.utils.logging.FileLogger",
              f"+logger.file.filename={metrics_file}"]
    if phase == 1:
        return common + [
            f"batch_size={TRAIN_BATCH}", "~dataset.eval_dataset",
            f"trainer.max_duration={RECIPE_P1_STEPS}ba",
            f"trainer.save_folder={ckpt_dir}",
            f"trainer.save_interval={RECIPE_P1_STEPS}ba",
            f"+callbacks.chip_smoke._target_={__name__}.ComposedRecord"]
    return common + [
        f"batch_size={RECIPE_P2_BATCH}",
        f"trainer.load_path={os.path.join(ckpt_dir, f'ba{RECIPE_P1_STEPS}')}",
        "+model.init_frozen_towers=true",
        f"dataset.eval_dataset.remote={coco}",
        f"dataset.eval_dataset.local={coco}",
        "dataset.eval_dataset.num_workers=2",
        f"dataset.eval_batch_size={RECIPE_P2_EVAL_BATCH}",
        f"trainer.max_duration={RECIPE_P2_STEPS}ba",
        f"trainer.eval_interval={RECIPE_P2_EVAL_AT}ba",
        f"+callbacks.chip_smoke._target_={__name__}.RecipeRecord",
        f"+callbacks.chip_smoke.load_path="
        f"{os.path.join(ckpt_dir, f'ba{RECIPE_P1_STEPS}')}"]


class RecipeRecord(ComposedRecord):
    """ComposedRecord for phase 2, and, when the fit starts: whether the
    UNet holds `load_path`'s saved parameters bit for bit, the optimizer's
    count and moments are fresh, the clock is at 0 and the EMA equals the
    loaded weights; after each batch, whether the EMA equals the weights
    (it copies them until `ema_start`)."""

    def __init__(self, load_path: str = None):
        super().__init__()
        self.load_path = load_path
        self.warm = {}
        self.ema_tracks = []

    def run_event(self, event, state, logger) -> None:
        import torch
        name = event.value
        ts = state.train_state
        if name == "fit_start" and self.load_path:
            from diffusion_torch.utils import safetensors
            saved = safetensors.load_file(os.path.join(
                self.load_path, "state", "params.safetensors"))
            self.warm = {
                "params_equal_saved": sorted(saved) == sorted(ts.params)
                and all(torch.equal(p, saved[n].to(p.device, p.dtype))
                        for n, p in ts.params.items()),
                "count": ts.optimizer.count,
                "moments_zero": all(not m.any() for m in
                                    ts.optimizer.mu + ts.optimizer.nu),
                "batch": state.timestamp.batch, "step": ts.step,
                "ema_equal_params": ts.ema_params is not None and all(
                    torch.equal(ts.ema_params[n], p)
                    for n, p in ts.params.items())}
            del saved
        elif name == "batch_end":
            self.ema_tracks.append(all(
                torch.equal(ts.ema_params[n], p)
                for n, p in ts.params.items()))
        super().run_event(event, state, logger)


def _recipe_job(src: dict, tmp: str, pre: str, card: str) -> dict:
    """Run the precompute job in a subprocess and return its summary."""
    args = _precompute_args(src, tmp, pre)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "diffusion_torch.scripts.precompute_latents",
         *args], cwd=_ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    tail = "\n".join(proc.stdout.strip().splitlines()[-3:])
    _check(proc.returncode == 0, f"the precompute job failed "
           f"({proc.returncode}): {proc.stderr[-3000:]}")
    m = re.search(r"rank 0: wrote (\d+) samples to (\S+) in ([\d.]+) s "
                  r"\(([\d.]+) images/s, (\w+) towers, (\d+) GroupNorm "
                  r"kernel launches\)", proc.stdout)
    _check(m is not None, f"no summary line from the precompute job: {tail}")
    out = {"samples": int(m.group(1)), "out": m.group(2),
           "loop_s": float(m.group(3)), "images_per_s": float(m.group(4)),
           "towers": m.group(5), "group_norm": int(m.group(6)),
           "wall_s": wall}
    out["bytes"] = _dir_bytes(out["out"])
    cache = os.path.join(tmp, "cache")
    left = [f for f in os.listdir(cache) if f.endswith(".mds")] \
        if os.path.isdir(cache) else []
    print(f"recipe: python -m diffusion_torch.scripts.precompute_latents "
          f"{' '.join(args)}: {out['samples']} samples at 256 and 512 px in "
          f"{wall:.2f} s of process wall time ({out['samples'] / wall:.2f} "
          f"images/s, start-up and the model's build included); the "
          f"encode loop {out['loop_s']:.2f} s ({out['images_per_s']:.2f} "
          f"images/s, decode, crops, encode and writes); {out['towers']} "
          f"towers; {out['group_norm']} GroupNorm kernel launches; output "
          f"{out['bytes'] / 1e6:.2f} MB of MDS shards; cached input shards "
          f"left {len(left)} [{card}]")
    _check(out["samples"] == RECIPE_RAW and out["towers"] == "loaded"
           and out["group_norm"] > 0 and not left,
           f"the precompute job's summary is off: {out}, {left} left")
    return out


def _recipe_encode_check(src: dict, job: dict, pre: str, card: str) -> None:
    """The job's encode in this process: its time per size (CUDA events,
    batch 32) and GroupNorm launches per encode; then two written samples'
    `latents_256` and `caption_latents` against an fp32 CPU encode of the
    same weights with the job's eps."""
    import copy
    import types

    import numpy as np
    import torch
    from PIL import Image

    from diffusion_torch.data.streaming import StreamingDataset
    from diffusion_torch.data.transforms import (LargestCenterSquare,
                                                 sd_normalize)
    from diffusion_torch.models.models import stable_diffusion_2
    from diffusion_torch.ops import groupnorm as gn
    from diffusion_torch.scripts.precompute_latents import (encode_batch,
                                                            load_towers,
                                                            posterior_eps)

    model = stable_diffusion_2(model_name=pre, init_frozen_towers=True,
                               device=DEVICE)
    _check(load_towers(model, pre), "the towers did not load")
    towers = types.SimpleNamespace(vae=model.vae,
                                   text_encoder=model.text_encoder,
                                   latent_scale=model.latent_scale)
    tokenizer = model.tokenizer
    del model
    gc.collect()
    torch.cuda.empty_cache()
    source = StreamingDataset(remote=src["raw"], shuffle=False)
    raws = [source.get_sample(i) for i in range(RECIPE_JOB_BATCH)]
    pils = [Image.open(io.BytesIO(r["jpg"])).convert("RGB") for r in raws]
    images = {s: torch.from_numpy(np.stack(
        [sd_normalize(LargestCenterSquare(s)(p)) for p in pils]))
        for s in (256, 512)}
    ids = torch.from_numpy(np.asarray(tokenizer(
        [r["caption"] for r in raws])["input_ids"]))
    eps = posterior_eps(0, 0, RECIPE_JOB_BATCH, (256, 512))
    gpu = {s: x.to(DEVICE) for s, x in images.items()}
    before = gn.launches.value
    encode_batch(towers, gpu, ids, eps)
    torch.cuda.synchronize()
    per_encode = gn.launches.value - before
    times = {s: _time_ms(lambda s=s: encode_batch(
        towers, {s: gpu[s]}, ids, {s: eps[s]}), iters=5, warmup=2)
        for s in (256, 512)}
    text_ms = _time_ms(lambda: encode_batch(towers, {}, ids, {}),
                       iters=5, warmup=2)
    print(f"recipe: the job's encode_batch at batch {RECIPE_JOB_BATCH}: "
          f"VAE 256px + CLIP text {times[256]:.2f} ms "
          f"({RECIPE_JOB_BATCH / times[256] * 1e3:.1f} images/s), VAE 512px"
          f" + CLIP text {times[512]:.2f} ms ({RECIPE_JOB_BATCH / times[512] * 1e3:.1f}"
          f" images/s), CLIP text alone {text_ms:.2f} ms; "
          f"{per_encode} GroupNorm wrapper calls per two-size encode "
          f"(22 a size) [{card}]")
    _check(per_encode == 44, f"GroupNorm calls per encode {per_encode}")
    # two written samples against an fp32 CPU encode of the same weights
    cpu = types.SimpleNamespace(
        vae=copy.deepcopy(towers.vae).to("cpu"),
        text_encoder=copy.deepcopy(towers.text_encoder).to("cpu"),
        latent_scale=towers.latent_scale)
    cpu.vae.dtype = cpu.text_encoder.dtype = torch.float32
    want = encode_batch(cpu, {256: images[256][:2]}, ids[:2],
                        {256: eps[256][:2]}, dtype=torch.float32)
    written = StreamingDataset(remote=job["out"], shuffle=False)
    for i in range(2):
        row = written.get_sample(i)
        _check(row["jpg"] == raws[i]["jpg"] and
               row["caption"] == raws[i]["caption"],
               f"sample {i} of the output is not the source's")
        for key, shape, ref in (
                ("latents_256", (4, 32, 32),
                 want["latents_256"][i].permute(2, 0, 1)),
                ("caption_latents", (77, 1024), want["caption_latents"][i])):
            got = torch.from_numpy(np.frombuffer(
                row[key], np.float16).reshape(shape).copy())
            err = _rel_l2(got, ref)
            finite = bool(torch.isfinite(got).all())
            print(f"recipe: sample {i} {key} {shape} written fp16 (bf16 "
                  f"encode on the card) vs fp32 on the CPU, same weights and"
                  f" eps: relative L2 error {err:.3e} (bound 5e-2), finite "
                  f"{finite} [{card}]")
            _check(finite and err <= 5e-2,
                   f"sample {i} {key} disagrees with the CPU encode")
    del towers, cpu, gpu
    gc.collect()
    torch.cuda.empty_cache()


def _recipe_phase(card: str) -> dict:
    """Phase 15: the main recipe end to end (see the module docstring);
    returns the five kernels' launches in the phase, the precompute job's
    GroupNorm launches (counted by its own process) included."""
    import tempfile

    import numpy as np
    import torch

    from diffusion_torch.ops import attention as attn_mod
    from diffusion_torch.train import checkpoint as ckpt
    from diffusion_torch.utils.profiler import step_graph

    t_phase = time.perf_counter()
    build = os.path.join(_ROOT, "build")
    os.makedirs(build, exist_ok=True)
    sizes = _sd2_sizes()
    disk = _checkpoint_disk_need(*sizes)
    need = disk["checkpoint"] + disk["pretrained"] + disk["shards"]
    free = _check_disk(build, need)
    print(f"recipe: disk: {free / 1e9:.2f} GB free under build/; the phase "
          f"needs {need / 1e9:.2f} GB (one checkpoint of "
          f"{disk['checkpoint'] / 1e9:.2f} GB, the fp16 pretrained "
          f"directory, shards) [{card}]")
    flash_shapes, loads = [], []

    def timed(real):
        def load(*args, **kwargs):
            t0 = time.perf_counter()
            out = real(*args, **kwargs)
            torch.cuda.synchronize()
            loads.append(time.perf_counter() - t0)
            return out
        return load

    with tempfile.TemporaryDirectory(prefix="chip_smoke_recipe_",
                                     dir=build) as tmp:
        pre = os.path.join(tmp, "sd2_fp16")
        _write_pretrained_dir(pre, card, "recipe")
        t0 = time.perf_counter()
        src = _write_recipe_sources(tmp, np.random.default_rng(15))
        print(f"recipe: wrote {RECIPE_RAW} raw JPEG + caption samples "
              f"(short sides >= 512; {src['raw_bytes'] / 1e6:.1f} MB of MDS "
              f"shards) and {RECIPE_COCO} COCO JPEGs with their captions "
              f"json ({src['coco_bytes'] / 1e6:.1f} MB) in "
              f"{time.perf_counter() - t0:.1f} s on the host [{card}]")
        coco = os.path.join(tmp, "coco")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "diffusion_torch.scripts.convert_coco",
             "--annotations", src["annotations"], "--image-dir",
             src["images"], "--out", coco, "--num-samples", str(RECIPE_COCO)],
            cwd=_ROOT, capture_output=True, text=True, timeout=300)
        _check(proc.returncode == 0 and
               f"wrote {RECIPE_COCO} samples" in proc.stdout,
               f"convert_coco failed: {proc.stdout[-500:]} "
               f"{proc.stderr[-2000:]}")
        print(f"recipe: python -m diffusion_torch.scripts.convert_coco: "
              f"{proc.stdout.strip()} in {time.perf_counter() - t0:.2f} s "
              f"({_dir_bytes(coco) / 1e6:.2f} MB) [{card}]")
        job = _recipe_job(src, tmp, pre, card)
        _recipe_encode_check(src, job, pre, card)

        # phase 1 at 256px on the job's shards, saved after its last batch
        ckpt_dir = os.path.join(tmp, "ckpt")
        trainer, record, launches1, wall1, peak1, _ = _yaml_run(
            "recipe phase 1", "SD-2-base-256.yaml", _recipe_overrides(
                1, job["out"], ckpt_dir, coco, os.path.join(tmp, "p1.jsonl")),
            RECIPE_P1_STEPS, card)
        ba = os.path.join(ckpt_dir, f"ba{RECIPE_P1_STEPS}")
        _check(os.path.exists(os.path.join(ba, "meta.json")),
               f"phase 1 did not save {ba}")
        steps1 = [m for m, *_ in record.steps]
        print(f"recipe phase 1: {RECIPE_P1_STEPS} batches of {TRAIN_BATCH} "
              f"at 256px on the job's latents in {wall1:.2f} s (build and "
              f"the save included), peak {peak1:.2f} GiB; checkpoint "
              f"{_dir_bytes(ba) / 1e9:.2f} GB at {ba} [{card}]")
        del trainer, record
        gc.collect()
        torch.cuda.empty_cache()

        # phase 2 at 512px, warm-started from phase 1's checkpoint
        captures = step_graph.captures
        trainer, record, launches2, wall2, peak2, records = _yaml_run(
            "recipe phase 2", "SD-2-base-512.yaml", _recipe_overrides(
                2, job["out"], ckpt_dir, coco, os.path.join(tmp, "p2.jsonl")),
            RECIPE_P2_STEPS, card, patches=(
                _patch(ckpt, "load_checkpoint", timed),
                _patch(attn_mod, "flash_attention", _shape_spy(flash_shapes))))
        model = trainer.model
        _check(model.vae is not None and trainer.max_batches ==
               RECIPE_P2_STEPS and trainer.micro_size == 8
               and trainer.state.ema_start_batch == 800000
               and trainer.train_dataloader.dataset.image_size == 512,
               "phase 2 did not compose as the 512 yaml says")
        warm = record.warm
        print(f"recipe phase 2: warm start from {ba}: weights-only load "
              f"{', '.join(f'{s:.2f}' for s in loads)} s; before step 1 the "
              f"UNet equals the saved parameters bit for bit "
              f"{warm.get('params_equal_saved')}, optimizer count "
              f"{warm.get('count')} with zero moments "
              f"{warm.get('moments_zero')}, batch {warm.get('batch')}, step "
              f"{warm.get('step')}, EMA equal to the loaded weights "
              f"{warm.get('ema_equal_params')}; phase 1's last loss "
              f"{steps1[-1]['loss/train/total']:.6f} [{card}]")
        _check(len(loads) == 1 and warm.get("params_equal_saved")
               and warm.get("count") == 0 and warm.get("moments_zero")
               and warm.get("batch") == 0 and warm.get("step") == 0
               and warm.get("ema_equal_params"),
               f"the warm start is off: {warm}, loads {loads}")
        _check(all(record.ema_tracks),
               f"phase 2: the EMA tracking the weights before ema_start: "
               f"{record.ema_tracks}")
        # the batch after the eval carries the eval, step 1 the CUDA
        # graph's capture (where it engaged): leave them out
        captured = step_graph.captures > captures
        times, step_s, wait_s = record.step_times(
            skip=(RECIPE_P2_EVAL_AT, 1) if captured else (RECIPE_P2_EVAL_AT,))
        evals = [r for r in records if "metrics/eval/MeanSquaredError" in r]
        _check(len(evals) == 1 and len(record.evals) == 1
               and evals[0]["step"] == RECIPE_P2_EVAL_AT,
               f"expected one eval after batch {RECIPE_P2_EVAL_AT}: {evals}")
        mse = evals[0]["metrics/eval/MeanSquaredError"]
        _, eval_s, eval_launches = record.evals[0]
        fit = {k: launches2[k] - eval_launches[k] for k in launches2}
        top = sorted({q for q, _ in flash_shapes if q[1] == 4096})
        print(f"recipe phase 2: SD-2-base 512px, global batch "
              f"{RECIPE_P2_BATCH} in microbatches of {trainer.micro_size}: "
              f"run {wall2:.2f} s (build and load included); step time "
              f"after the first {step_s * 1e3:.1f} ms (steps: "
              f"{', '.join(f'{x * 1e3:.1f}' for x in times)} ms, the one "
              f"after the eval{' and the capture' if captured else ''} "
              f"left out), {RECIPE_P2_BATCH / step_s:.2f} "
              f"samples/s; dataloader wait {wait_s * 1e3:.1f} ms a step "
              f"after the first; peak device memory {peak2:.2f} GiB; eval "
              f"after batch {RECIPE_P2_EVAL_AT} on COCO at 512px "
              f"({RECIPE_COCO // RECIPE_P2_EVAL_BATCH} batches of "
              f"{RECIPE_P2_EVAL_BATCH}): MSE {mse:.6f} in {eval_s:.2f} s; "
              f"flash query shapes at S = 4096 {top} [{card}]")
        _check(math.isfinite(mse), "phase 2's eval MSE is not finite")
        _check((trainer.micro_size, 4096, 5, 64) in top,
               f"no flash call at ({trainer.micro_size}, 4096, 5, 64): {top}")
        print(f"recipe phase 2: kernel launches during the fit "
              f"{json.dumps(fit)} (per step " + json.dumps(
                  {k: v / RECIPE_P2_STEPS for k, v in fit.items()})
              + f"); during the eval {json.dumps(eval_launches)} [{card}]")
        for name in fit:
            _check(fit[name] > 0, f"{name} kernel was not launched during "
                   f"phase 2's fit")
            _check(launches1[name] > 0, f"{name} kernel was not launched "
                   f"during phase 1's fit")
        del trainer, record, model
        gc.collect()
        torch.cuda.empty_cache()
    total = {k: launches1[k] + launches2[k] for k in launches1}
    total["group_norm"] += job["group_norm"]
    print(f"recipe: phase {time.perf_counter() - t_phase:.1f} s; kernel "
          f"launches {json.dumps(total)} (the job's "
          f"{job['group_norm']} GroupNorm launches counted in its own "
          f"process) [{card}]")
    return total


EVAL_SAMPLES = 64      # COCO samples of the eval job (phase 8's count)
EVAL_BATCH, EVAL_BATCHES = 16, 2
TOWER_BOUND = 1e-3     # relative L2, fp32 card vs fp32 CPU, TF32 off


# ---------------- phase 16: remat and the process mesh ----------------

SP_YAML = "SD-2-base-1024-sp.yaml"
SP_SIZE, SP_BATCH, SP_STEPS = 1024, 8, 4     # the yaml's microbatch: 4
SP_TRAIN, SP_EVAL, SP_EVAL_AT = 64, 8, 2
SP_FLASH_SHAPE = (4, 16384, 5, 64)           # level 0 at 1024px, batch 4
SP_SHARDS = 4


class SpRecord(ComposedRecord):
    """ComposedRecord for phase 16's runs, with each step's kernel
    launches and peak memory, the device memory each training UNet
    forward leaves held for its backward (what remat trades), and, at the
    fit's start, the frozen VAE's encode of one microbatch (CUDA events),
    which every rank of an sp group runs whole."""

    def __init__(self):
        super().__init__()
        self.step_launches, self.step_peaks, self.held = [], [], []
        self._at = self._before = None
        self.encode_ms, self.encode_launches = None, {}

    def note(self, i: int) -> str:
        return f"; launches {self.step_launches[i]}"

    def _time_encode(self, model) -> None:
        import torch
        gen = torch.Generator(device=model.device).manual_seed(16)
        images = torch.rand((4, SP_SIZE, SP_SIZE, 3), generator=gen,
                            device=model.device) * 2 - 1
        self.encode_ms = _time_ms(lambda: model.encode_images(
            images, generator=gen), iters=3, warmup=1)

    def _pre(self, module, args) -> None:
        import torch
        if torch.is_grad_enabled():
            self._before = torch.cuda.memory_allocated()

    def _post(self, module, args, out) -> None:
        import torch
        if torch.is_grad_enabled():
            self.held.append(torch.cuda.memory_allocated() - self._before)

    def run_event(self, event, state, logger) -> None:
        import torch
        name = event.value
        if name == "fit_start":
            state.model.unet.register_forward_pre_hook(self._pre)
            state.model.unet.register_forward_hook(self._post)
            before = {k: c.value for k, c in _counters().items()}
            self._time_encode(state.model)
            # a measurement, not the run's: `_sp_run` takes them off
            self.encode_launches = {k: c.value - before[k]
                                    for k, c in _counters().items()}
        elif name == "batch_start":
            self._at = {k: c.value for k, c in _counters().items()}
            torch.cuda.reset_peak_memory_stats()
        elif name == "batch_end":
            self.step_launches.append({k: c.value - self._at[k]
                                       for k, c in _counters().items()})
            self.step_peaks.append(torch.cuda.max_memory_allocated())
        super().run_event(event, state, logger)


def _sp_overrides(raw: str, coco: str, metrics_file: str,
                  remat: bool) -> list:
    """Phase 16's dotted overrides of yamls/SD-2-base-1024-sp.yaml: one
    rank's mesh (fsdp inferred 1), global batch 8 (the yaml's microbatches
    of 4), 4 batches over `raw`, the yaml's COCO eval over `coco` (8
    images, one batch) after batch 2."""
    out = [f"batch_size={SP_BATCH}", "trainer.mesh_config.data=1",
           "trainer.mesh_config.sp=1", f"trainer.max_duration={SP_STEPS}ba",
           f"trainer.eval_interval={SP_EVAL_AT}ba", "~logger",
           f"dataset.train_dataset.remote={raw}",
           f"dataset.train_dataset.local={raw}",
           "dataset.train_dataset.num_workers=2",
           f"dataset.eval_dataset.remote={coco}",
           f"dataset.eval_dataset.local={coco}",
           "dataset.eval_dataset.num_workers=2",
           f"dataset.eval_batch_size={SP_EVAL}",
           "+logger.file._target_=diffusion_tpu.utils.logging.FileLogger",
           f"+logger.file.filename={metrics_file}",
           f"+callbacks.chip_smoke._target_={__name__}.SpRecord"]
    return out + ([] if remat else ["model.remat=false"])


def _sp_run(card: str, label: str, overrides: list) -> dict:
    """One run of the 1024-sp yaml through `diffusion_torch.run.main`, the
    counters at 0 right before it."""
    from diffusion_torch.ops import flash_attention as fa

    shapes = []
    _, record, launches, wall, _, _ = _yaml_run(
        f"sp {label}", SP_YAML, overrides, SP_STEPS, card,
        patches=(_patch(fa, "flash_attention_cuda", _shape_spy(shapes)),),
        cli=True)
    # the encode's launches are a measurement, not the run's
    launches = {name: n - record.encode_launches.get(name, 0)
                for name, n in launches.items()}
    # the training steps' peak (the eval's batch-8 encode is not a step's)
    peak = max(record.step_peaks) / 2 ** 30
    held = max(record.held) / 2 ** 30
    _check(len(record.evals) == 1, f"sp {label}: no eval after batch "
                                   f"{SP_EVAL_AT}")
    # steps after the first (warm-up: cuDNN's algorithm search)
    step_s = sorted(own for *_, own in record.steps[1:])[
        (SP_STEPS - 1) // 2]
    per_step = record.step_launches[-1]
    flash_big = sum(q == SP_FLASH_SHAPE for q, _ in shapes)
    print(f"sp {label}: SD-2-base {SP_SIZE}px, global batch {SP_BATCH} in "
          f"microbatches of 4: step {step_s * 1e3:.1f} ms (median after the "
          f"first), {SP_BATCH / step_s:.2f} samples/s, a step's peak "
          f"{peak:.2f} GiB, a microbatch's UNet forward holds {held:.2f} "
          f"GiB for its backward, run {wall:.1f} s; eval after batch "
          f"{record.evals[0][0]} {record.evals[0][1]:.2f} s; flash launches "
          f"at {SP_FLASH_SHAPE}: {flash_big} in the run "
          f"({flash_big / (SP_STEPS * 2):.1f} a training microbatch's "
          f"forward; the eval's are at batch 8); GroupNorm launches per step "
          f"{per_step['group_norm']} forward, {per_step['group_norm_bwd']} "
          f"backward [{card}]")
    print(f"sp {label}: the frozen VAE's encode of a microbatch (4 x "
          f"{SP_SIZE}px) {record.encode_ms:.2f} ms; every rank of an sp "
          f"group of n runs it whole (the towers are not sharded, JAX's "
          f"shard=False), n x that a microbatch where one rank's share "
          f"would be 1 / n [{card}]")
    for name, n in launches.items():
        _check(n > 0, f"sp {label}: {name} was not launched")
    _check(flash_big > 0, f"sp {label}: no flash call at {SP_FLASH_SHAPE}")
    return {"launches": launches, "step_s": step_s, "peak": peak,
            "held": held, "per_step": per_step}


def _sp_fsdp_check(card: str) -> None:
    """(b) One 256px step (batch 4) of the full-width UNet under FSDP2 on
    the one-rank mesh against the plain step, the AdamW over each's
    parameters (the sharded one's local shards)."""
    import torch

    from diffusion_torch.models.models import stable_diffusion_2
    from diffusion_torch.parallel.mesh import create_mesh
    from diffusion_torch.parallel.sharding import fsdp_mesh, shard_unet
    from diffusion_torch.train.optim import adamw, build_optimizer

    gen = torch.Generator(device=DEVICE).manual_seed(16)
    batch = {"image_latents": torch.randn((4, 32, 32, 4), generator=gen,
                                          device=DEVICE),
             "caption_latents": torch.randn((4, 77, 1024), generator=gen,
                                            device=DEVICE)}
    noise = torch.randn((4, 32, 32, 4), generator=gen, device=DEVICE)
    t = torch.tensor([3, 250, 600, 990], device=DEVICE)
    after = []
    for sharded in (False, True):
        model = stable_diffusion_2(precomputed_latents=True, device=DEVICE,
                                   seed=0)
        if sharded:
            shard_unet(model.unet, fsdp_mesh(create_mesh(fsdp=-1)))
        params = [p for p in model.unet.parameters() if p.requires_grad]
        local = [p.to_local() if sharded else p for p in params]
        opt = build_optimizer(local, adamw(lr=1e-4))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = model.loss_fn(batch, None, noise, t)
        loss.backward()
        grads = [p.grad.to_local() if sharded else p.grad for p in params]
        kept = [g.clone() for g in grads]
        opt.step(grads=grads)
        torch.cuda.synchronize()
        after.append(([p.detach().clone() for p in local], kept, float(loss),
                      time.perf_counter() - t0))
        del model, params, local, opt, grads
        gc.collect()
        torch.cuda.empty_cache()
    (plain, g_plain, loss_p, s_p), (fsdp, g_fsdp, loss_f, s_f) = after
    # the gradients: bf16 compute, so one bf16 ulp of each tensor's
    # largest element, doubled, should the two backwards sum differently
    g_err = max(((a - b).abs().max() / (2.0 ** -6 * b.abs().max()
                                        + 1e-30)).item()
                for a, b in zip(g_fsdp, g_plain))
    g_equal = all(torch.equal(a, b) for a, b in zip(g_fsdp, g_plain))
    diff = max((a - b).abs().max().item() for a, b in zip(plain, fsdp))
    same = sum(int((a == b).sum()) for a, b in zip(plain, fsdp))
    total = sum(a.numel() for a in plain)
    # Adam's first update is g / (|g| + eps): gradients dg apart move it by
    # at most 2 |dg| / (|g| + eps) (and never more than 2), times lr 1e-4,
    # plus 4 ulp of the parameter (the tests' `adam_bound` at k = 1)
    excess = max(((a - b).abs() - 1e-4 * torch.clamp(
        2 * (gf - gp).abs() / (gp.abs() + 1e-8), max=2.0)
        - 4 * torch.finfo(torch.float32).eps * b.abs()).max().item()
        for a, b, gf, gp in zip(fsdp, plain, g_fsdp, g_plain))
    print(f"sp fsdp: one 256px step (batch 4) under fully_shard on the "
          f"one-rank mesh against the plain step: loss {loss_f:.6f} vs "
          f"{loss_p:.6f}; gradients within {g_err:.3f} of their bf16 bound "
          f"(bit-equal {g_equal}); parameters after AdamW max_abs_err "
          f"{diff:.3e}, {same / total:.6f} of them bit-equal, within the "
          f"update bound the gradients imply (excess {excess:.3e} <= 0); "
          f"step {s_f * 1e3:.1f} ms vs {s_p * 1e3:.1f} ms (first steps) "
          f"[{card}]")
    _check(loss_f == loss_p and g_err <= 1.0 and excess <= 0,
           "the FSDP step disagrees with the plain step")


def _sp_kernel_work(card: str) -> None:
    """(c) The ring's per-step body over 4 local shards and the sp
    GroupNorm stages over 4 row shards, on the kernels, against the
    whole-tensor kernels."""
    import torch

    from diffusion_torch.ops import flash_attention as fa
    from diffusion_torch.ops import groupnorm as gn
    from diffusion_torch.ops.ring_attention import (
        ring_attention_shards, ring_attention_shards_bwd)

    gen = torch.Generator(device=DEVICE).manual_seed(17)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)

    n = SP_SHARDS
    q, k, v, do = (randn(2, 16384, 5, 64) for _ in range(4))
    qs, ks, vs, dos = ([c.contiguous() for c in t.chunk(n, dim=1)]
                       for t in (q, k, v, do))
    out, lse = fa.flash_attention_cuda(q, k, v)
    dq, dk, dv = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do)
    outs, lses = ring_attention_shards(qs, ks, vs)
    grads = ring_attention_shards_bwd(qs, ks, vs, outs, lses, dos)
    # the ring merges the blocks' partial softmaxes in fp32 and rounds the
    # output once; the whole kernel rounds once too: two bf16 ulps of the
    # largest element (the kernel phase's bound)
    errs = []
    for name, got, want in (("out", torch.cat(outs, 1), out),
                            ("dq", torch.cat(grads[0], 1), dq),
                            ("dk", torch.cat(grads[1], 1), dk),
                            ("dv", torch.cat(grads[2], 1), dv)):
        err = (got.float() - want.float()).abs().max().item()
        errs.append((name, err, 2.0 ** -6 * want.float().abs().max().item()))
    lse_err = (torch.cat(lses, 2) - lse).abs().max().item()
    b, s, h, d = q.shape
    fwd_ms = _time_ms(lambda: ring_attention_shards(qs, ks, vs), 10, 2)
    whole_ms = _time_ms(lambda: fa.flash_attention_cuda(q, k, v), 10, 2)
    bwd_ms = _time_ms(lambda: ring_attention_shards_bwd(
        qs, ks, vs, outs, lses, dos), 10, 2)
    whole_bwd_ms = _time_ms(lambda: fa.flash_attention_bwd_cuda(
        q, k, v, out, lse, do), 10, 2)
    bms, by = _least_ms(4 * b * h * s * s * d, 4 * _nbytes(q) + _nbytes(lse))
    bbms, bby = _least_ms(10 * b * h * s * s * d, 8 * _nbytes(q))
    print(f"sp ring: {n} local shards of ({b}, {s // n}, {h}, {d}) bf16, "
          f"{n * n} blocks through the flash kernels: "
          + ", ".join(f"{nm} max_abs_err {e:.3e} (bound {bd:.3e})"
                      for nm, e, bd in errs)
          + f", lse max_abs_err {lse_err:.3e} (bound 1e-3); forward "
          f"{fwd_ms:.3f} ms vs the whole sequence's kernel {whole_ms:.3f} ms"
          f" (bound {bms:.3f} ms, {by}); backward {bwd_ms:.3f} ms vs "
          f"{whole_bwd_ms:.3f} ms (bound {bbms:.3f} ms, {bby}) [{card}]")
    _check(all(e <= bd for _, e, bd in errs) and lse_err <= 1e-3,
           "the ring's blocks disagree with the whole-sequence kernels")

    # GroupNorm: scale near 1 and a cotangent whose per-group mean runs
    # along the rows (an offset per group times a ramp over the sequence),
    # so the per-group sums that stage 2 merges are of order 1 and each
    # shard's own differ from the whole's
    rows, c = 16384, 320
    x = randn(4, rows, c)
    ramp = torch.linspace(-1.0, 2.0, rows, device=DEVICE)[None, :, None]
    offset = randn(1, 1, 32, dtype=torch.float32).repeat_interleave(
        c // 32, -1)
    g = (randn(4, rows, c, dtype=torch.float32)
         + offset * ramp).to(torch.bfloat16)
    scale = 1 + 0.1 * randn(c, dtype=torch.float32)
    bias = 0.1 * randn(c, dtype=torch.float32)
    xs, gs = ([t.contiguous() for t in u.chunk(n, dim=1)] for u in (x, g))
    y, mean, rstd = gn.group_norm_cuda(x, scale, bias, 32, 1e-5, "silu")
    dx, dscale, dbias = gn.group_norm_bwd_cuda(x, scale, bias, mean, rstd, g,
                                               32, "silu")

    def forward():
        parts = torch.stack([gn.group_norm_partials_cuda(t, 32) for t in xs])
        return [gn.group_norm_apply_cuda(t, scale, bias, parts, 32, 1e-5,
                                         "silu") for t in xs]

    def backward(own_only=False):
        sums = [gn.group_norm_bwd_partials_cuda(t, scale, bias, mean, rstd,
                                                gt, 32, "silu")
                for t, gt in zip(xs, gs)]
        gparts = torch.stack([gp for _, gp in sums])
        return [gn.group_norm_bwd_apply_cuda(
            t, scale, bias, mean, rstd, gt, cp,
            gparts[r:r + 1].contiguous() if own_only else gparts, 32, "silu")
            for r, (t, gt, (cp, _)) in enumerate(zip(xs, gs, sums))]

    # each shard's dx from the plain stages in fp32 on the same inputs (the
    # whole forward's mean and rstd), and T = rstd (|scale dz| + |m1| +
    # |x-hat m2|), the size of the terms the fp32 dx adds
    xf, gf = [t.float() for t in xs], [t.float() for t in gs]
    sums = [gn.group_norm_bwd_partials_reference(a, scale, bias, mean, rstd,
                                                 b_, 32, "silu")
            for a, b_ in zip(xf, gf)]
    gparts = torch.stack([gp for _, gp in sums])
    m = gparts.sum(dim=(0, 2)) / (rows * (c // 32))          # (B, G, 2)
    refs, terms = [], []
    for a, b_, (cp, _) in zip(xf, gf, sums):
        refs.append(gn.group_norm_bwd_apply_reference(
            a, scale, bias, mean, rstd, b_, cp, gparts, 32, "silu")[0])
        dz, xhat, sc = gn._dz_xhat(a, scale, bias, mean, rstd, b_, 32,
                                   "silu")
        terms.append((rstd[:, None, :, None] * (
            (dz * sc).abs() + m[:, None, :, None, 0].abs()
            + (xhat * m[:, None, :, None, 1]).abs())).reshape(a.shape))
    ref, term = torch.cat(refs, 1), torch.cat(terms, 1)
    del xf, gf, sums, refs, terms

    def dx_excess(got):
        # the largest error over its bound: bf16 rounding of dx (2^-8 of
        # it), plus twice 2^-14 of the terms for fp32 per-group sums taken
        # in another order
        tol = 2.0 ** -8 * ref.abs() + 2.0 ** -13 * term
        return ((got.float() - ref).abs() / tol).max().item()

    ys = forward()
    dxs = backward()
    y_err = (torch.cat([a for a, _, _ in ys], 1).float()
             - y.float()).abs().max().item()
    stat_err = max(max((m_ - mean).abs().max().item(),
                       ((r - rstd).abs() / rstd).max().item())
                   for _, m_, r in ys)
    sp_excess = dx_excess(torch.cat([a for a, _, _ in dxs], 1))
    one_excess = dx_excess(dx)
    own_excess = dx_excess(torch.cat([a for a, _, _ in backward(True)], 1))
    merge = m.abs().amax(dim=(0, 1))
    p_err = max(((sum(t[i] for t in dxs) - w).abs().max()
                 / w.abs().max()).item()
                for i, w in ((1, dscale), (2, dbias)))
    y_bound = 2.0 ** -6 * y.float().abs().max().item()
    f_ms = _time_ms(forward, 10, 2)
    one_ms = _time_ms(lambda: gn.group_norm_cuda(x, scale, bias, 32, 1e-5,
                                                 "silu"), 10, 2)
    b_ms = _time_ms(backward, 10, 2)
    one_b_ms = _time_ms(lambda: gn.group_norm_bwd_cuda(
        x, scale, bias, mean, rstd, g, 32, "silu"), 10, 2)
    fb, fby = _least_ms(10 * x.numel(), 2 * _nbytes(x) + 3 * 320 * 4)
    bb, bby = _least_ms(20 * x.numel(), 3 * _nbytes(x) + 7 * 320 * 4)
    print(f"sp group_norm: {n} row shards of (4, {rows // n}, {c}) bf16 "
          f"act=silu, two stages a direction around the partials' merge: y "
          f"max_abs_err {y_err:.3e} (bound {y_bound:.3e}), stats err "
          f"{stat_err:.3e} (bound 1e-4); dx against the plain fp32 stages "
          f"(merged per-group means up to |m1| {merge[0].item():.3f}, |m2| "
          f"{merge[1].item():.3f}): error over its bound {sp_excess:.3f} "
          f"(<= 1; the one-call kernel's {one_excess:.3f}; stage 2 fed only "
          f"its own shard's sums {own_excess:.1f}, must be > 1); "
          f"dscale/dbias relative err {p_err:.3e} (bound 1e-4); forward "
          f"{f_ms:.4f} ms ({2 * n} launches) vs one call {one_ms:.4f} ms "
          f"(bound {fb:.4f} ms, {fby}); backward {b_ms:.4f} ms vs one call "
          f"{one_b_ms:.4f} ms (bound {bb:.4f} ms, {bby}) [{card}]")
    _check(y_err <= y_bound and stat_err <= 1e-4 and sp_excess <= 1
           and p_err <= 1e-4,
           "the sp GroupNorm stages disagree with the one-call kernels")
    _check(own_excess > 1, "the backward check cannot tell a merge over "
                           "the shards from each shard's own sums")


def _sp_dispatch_check(card: str) -> None:
    """The dispatcher ops the Trainer calls under sp, on a one-rank NCCL
    group: `group_norm(shard=)` (its stage kernels around the NCCL
    all-gather of the partials, the autograd wiring, the cotangent's
    contiguity copy) and `ring_attention` (the ring's loop, one step on one
    rank), forward and backward, against the stage kernels and the
    whole-tensor kernels. A one-rank group moves no data between cards;
    the ranks' transport runs in the CPU tests over gloo."""
    import torch
    import torch.distributed as dist

    from diffusion_torch.ops import flash_attention as fa
    from diffusion_torch.ops import groupnorm as gn
    from diffusion_torch.ops.ring_attention import ring_attention
    from diffusion_torch.parallel.mesh import MESH_AXES, create_mesh
    from diffusion_torch.parallel.sharding import RowShard, register_group

    mesh = create_mesh(fsdp=-1)
    shard = RowShard(register_group(mesh.get_group(MESH_AXES.index("sp"))),
                     0, 1)
    gen = torch.Generator(device=DEVICE).manual_seed(18)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)

    counters = _counters()

    def launched(before):
        return {k: c.value - before[k] for k, c in counters.items()
                if c.value != before[k]}

    x = randn(4, 16384, 320).requires_grad_(True)
    scale = (1 + 0.1 * randn(320, dtype=torch.float32)).requires_grad_(True)
    bias = (0.1 * randn(320, dtype=torch.float32)).requires_grad_(True)
    # the cotangent in NCHW order: the op's backward copies it once
    g = randn(4, 320, 16384).transpose(1, 2)
    before = {k: c.value for k, c in counters.items()}
    copies = gn.contiguity_copies.value
    y = gn.group_norm(x, scale, bias, 32, 1e-5, "silu", shard=shard)
    y.backward(g)
    torch.cuda.synchronize()
    gn_launches = launched(before)
    copies = gn.contiguity_copies.value - copies
    xd, sd, bd, gd = x.detach(), scale.detach(), bias.detach(), g.contiguous()
    y_st, mean, rstd = gn.group_norm_apply_cuda(
        xd, sd, bd, gn.group_norm_partials_cuda(xd, 32)[None], 32, 1e-5,
        "silu")
    cp, gp = gn.group_norm_bwd_partials_cuda(xd, sd, bd, mean, rstd, gd, 32,
                                             "silu")
    dx_st, ds_st, db_st = gn.group_norm_bwd_apply_cuda(
        xd, sd, bd, mean, rstd, gd, cp, gp[None], 32, "silu")
    p_err = max(((a - w).abs().max() / w.abs().max()).item()
                for a, w in ((scale.grad, ds_st), (bias.grad, db_st)))
    y_one, mean1, rstd1 = gn.group_norm_cuda(xd, sd, bd, 32, 1e-5, "silu")
    dx_one = gn.group_norm_bwd_cuda(xd, sd, bd, mean1, rstd1, gd, 32,
                                    "silu")[0]
    gn_errs = [(nm, (a.float() - w.float()).abs().max().item(),
                2.0 ** -6 * w.float().abs().max().item())
               for nm, a, w in (("y", y.detach(), y_one),
                                ("dx", x.grad, dx_one))]
    gn_same = torch.equal(y.detach(), y_st) and torch.equal(x.grad, dx_st)
    print(f"sp dispatch: group_norm(shard=) over a one-rank "
          f"{dist.get_backend()} group at (4, 16384, 320) bf16 act=silu, forward "
          f"and backward: launches {gn_launches}, cotangent copies {copies}; "
          f"y and dx bit-equal to the stage kernels' {gn_same}, dscale/dbias "
          f"relative err {p_err:.3e} (bound 1e-5); against the one-call "
          f"kernels "
          + ", ".join(f"{nm} max_abs_err {e:.3e} (bound {bd_:.3e})"
                      for nm, e, bd_ in gn_errs) + f" [{card}]")
    _check(gn_launches == {"group_norm": 2, "group_norm_bwd": 2}
           and copies == 1 and gn_same and p_err <= 1e-5
           and all(e <= bd_ for _, e, bd_ in gn_errs),
           "group_norm(shard=) on the card disagrees with its kernels")

    q, k, v = (randn(2, 16384, 5, 64).requires_grad_(True) for _ in range(3))
    do = randn(2, 16384, 5, 64)
    before = {kk: c.value for kk, c in counters.items()}
    o = ring_attention(q, k, v, shard)
    o.backward(do)
    torch.cuda.synchronize()
    ring_launches = launched(before)
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    out, lse = fa.flash_attention_cuda(qd, kd, vd)
    want = (out, *fa.flash_attention_bwd_cuda(qd, kd, vd, out, lse, do))
    got = (o.detach(), q.grad, k.grad, v.grad)
    errs = [(nm, (a.float() - w.float()).abs().max().item(),
             2.0 ** -6 * w.float().abs().max().item())
            for nm, a, w in zip(("out", "dq", "dk", "dv"), got, want)]
    print(f"sp dispatch: ring_attention over the one-rank group at (2, "
          f"16384, 5, 64) bf16, forward and backward: launches "
          f"{ring_launches}; against the whole-sequence kernels "
          + ", ".join(f"{nm} max_abs_err {e:.3e} (bound {bd_:.3e})"
                      for nm, e, bd_ in errs)
          + f" (bit-equal {[torch.equal(a, w) for a, w in zip(got, want)]})"
            f" [{card}]")
    _check(ring_launches == {"flash_attention": 1,
                             "flash_attention_bwd_dq": 1,
                             "flash_attention_bwd_dkv": 1}
           and all(e <= bd_ for _, e, bd_ in errs),
           "ring_attention on the card disagrees with the flash kernels")


def _sp_phase(card: str) -> dict:
    """Phase 16 (see the module docstring); returns the five kernels'
    launches in (a)'s two runs."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    rng = np.random.default_rng(16)
    tmp = os.path.join(_ROOT, "build", "chip_smoke_sp")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    raw, coco = os.path.join(tmp, "raw"), os.path.join(tmp, "coco")
    t0 = time.perf_counter()
    from diffusion_torch.data.mds import MDSWriter
    with MDSWriter(raw, {"image": "bytes", "caption": "str"},
                   size_limit=1 << 24) as w:
        for i in range(SP_TRAIN):
            w.write({"image": _jpeg(_smooth_image(rng, SP_SIZE, SP_SIZE)),
                     "caption": f"a 1024px sample {i}"})
    _write_coco_shards(coco, SP_EVAL, rng)
    print(f"sp: {SP_TRAIN} seeded {SP_SIZE}px JPEG + caption samples and "
          f"{SP_EVAL} COCO ones written in {time.perf_counter() - t0:.1f} s")
    # the launch code of a torchrun rank: a one-rank NCCL process group
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
           "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        runs = {}
        for label, remat in (("remat", True), ("no remat", False)):
            runs[label] = _sp_run(card, label, _sp_overrides(
                raw, coco, os.path.join(tmp, f"metrics_{remat}.jsonl"),
                remat))
            gc.collect()
            torch.cuda.empty_cache()
        print(f"sp: process group {dist.get_backend()} over "
              f"{dist.get_world_size()} rank(s); remat costs "
              f"{(runs['remat']['step_s'] - runs['no remat']['step_s']) * 1e3:.1f}"
              f" ms a step ({runs['remat']['step_s'] / runs['no remat']['step_s']:.3f}x)"
              f" and saves {runs['no remat']['held'] - runs['remat']['held']:.2f}"
              f" GiB of the forward's held activations ({runs['remat']['held']:.2f}"
              f" vs {runs['no remat']['held']:.2f} GiB), "
              f"{runs['no remat']['peak'] - runs['remat']['peak']:.2f} GiB of "
              f"a step's peak ({runs['remat']['peak']:.2f} vs "
              f"{runs['no remat']['peak']:.2f} GiB); GroupNorm launches a "
              f"step {runs['remat']['per_step']['group_norm']} vs "
              f"{runs['no remat']['per_step']['group_norm']} (the forward "
              f"recomputed in the backward) [{card}]")
        _sp_fsdp_check(card)
        _sp_dispatch_check(card)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    _sp_kernel_work(card)
    if torch.cuda.device_count() >= 2:
        print("sp: two cards present; the 2-rank NCCL sp step is not run "
              "by this script (one card is its contract)")
    else:
        print(f"sp: one card ({torch.cuda.device_count()}): ranks talking "
              f"to each other (P2P ring, halo rows, merged GroupNorm "
              f"statistics, FSDP's collectives) ran on the CPU only, over "
              f"gloo (tests/test_torch_ring_attention.py, "
              f"tests/test_torch_mesh_trainer.py)")
    return {name: runs["remat"]["launches"][name]
            + runs["no remat"]["launches"][name] for name in _counters()}

# ---------------- phase 17: Megatron tensor parallelism ----------------

TP_YAML = "SD-2-base-512-tp.yaml"
TP_BATCH, TP_STEPS, TP_TRAIN = 16, 3, 48     # the 2048 cut; microbatch 8
TP_RANKS = 2                                 # the yaml's tp
# the flash calls of a microbatch's forward, 5 self-attention calls a
# level: on a tp rank level 0 (5 heads) whole, level 1 5 of its 10 heads
TP_FLASH = {(8, 4096, 5, 64): 5, (8, 1024, 5, 64): 5}
TP_FLASH_ONE = {(8, 4096, 5, 64): 5, (8, 1024, 10, 64): 5}
TP_RANK_TIMEOUT = 900
# the ranks against tp 1, a few times what the card measured (losses
# 4.0e-5 and grad norms 3.8e-4 relative at most; gradients 0.0225 relative
# L2 at worst a tensor, 0.0026 whole; NVIDIA H100 80GB HBM3, 700 W): a
# planted fault (tp_copy's backward not summing, `_tp_rank_main`'s
# control) must miss them
TP_LOSS_REL, TP_NORM_REL = 1e-4, 1e-3
TP_GRAD_REL, TP_GRAD_WHOLE_REL = 5e-2, 1e-2


def _tp_sum(shards, dims: dict):
    """One layer's tp shards in one process (no LoRA): their partial
    outputs (each shard's row-parallel product, without its bias) summed
    where the ranks' `tp_reduce` would sum them, then the bias. The shards
    share their whole parameters, so those gather every shard's gradient,
    as the replicated copies' gradients equal one another over ranks.
    `dims`: the sliced parameters' tp dims, by name in the layer."""
    import torch

    class TpSum(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.shards, self.dims = torch.nn.ModuleList(shards), dims

        def forward(self, x, context=None, shard=None):
            parts = [_tp_partial(s, x, context, shard) for s in self.shards]
            out = sum(p for p, _ in parts)
            return out + parts[0][1].to(out.dtype)
    return TpSum()


def _tp_partial(layer, x, context=None, shard=None):
    """A tp shard's part of its layer's output, the row-parallel product
    before its bias (what `tp_reduce` sums), and that bias."""
    import torch.nn.functional as F

    from diffusion_torch.models.layers import Attention
    if isinstance(layer, Attention):
        h, out = layer._attend(x, context, shard), layer.to_out[0]
    else:
        h, out = layer.net[0](x), layer.net[2]
    return F.linear(h, out.weight.to(h.dtype)), out.bias


def tp_local_twin(module, size: int, head_dim=None):
    """A copy of `module` (a Transformer2D, a block or a layer; no LoRA)
    whose Megatron layers each run as `size` tp shards in this process
    (`parallel/sharding.py::shard_tensor_parallel`'s slices), their
    partials summed where the ranks' `tp_reduce` would: the local twin of
    a tp group, which the tests and phase 17 hold against the whole module
    and the ranks. Shard r's slices are `twin.<layer>.shards.r.<name>`."""
    import copy

    from diffusion_torch.models.layers import Attention, FeedForwardGEGLU
    from diffusion_torch.parallel.sharding import shard_tensor_parallel
    twin = copy.deepcopy(module)
    layers = [(n, m) for n, m in twin.named_modules()
              if isinstance(m, (Attention, FeedForwardGEGLU))]
    for name, layer in layers:
        if getattr(layer, "lora_rank", 0):
            raise ValueError("the local twin runs layers without LoRA")
        shards = [copy.deepcopy(layer) for _ in range(size)]
        dims = shard_tensor_parallel(shards[0], 0, size, head_dim)
        if not dims:
            continue                   # gated: whole on every rank
        for r in range(1, size):
            sliced = shard_tensor_parallel(shards[r], r, size, head_dim)
            for pname, p in shards[0].named_parameters():
                if pname not in sliced:
                    owner, _, leaf = pname.rpartition(".")
                    setattr(shards[r].get_submodule(owner) if owner
                            else shards[r], leaf, p)
        if not name:                   # the module is the layer itself
            return _tp_sum(shards, dims)
        parent, _, child = name.rpartition(".")
        setattr(twin.get_submodule(parent) if parent else twin, child,
                _tp_sum(shards, dims))
    return twin


def tp_twin_grads(twin) -> dict:
    """The gradients of a `tp_local_twin` under the whole module's names:
    each shard's slices joined, each whole parameter (shared by the
    shards) once."""
    from diffusion_torch.parallel.sharding import tp_join
    params = dict(twin.named_parameters(remove_duplicate=False))
    sums = {n: m for n, m in twin.named_modules()
            if type(m).__name__ == "TpSum"}
    got = {}
    lead = {s: f"{s}.shards." if s else "shards." for s in sums}
    for name, p in params.items():
        prefix = next((s for s in sums if name.startswith(lead[s])), None)
        if prefix is None:
            got[name] = p.grad
            continue
        index, _, rest = name[len(lead[prefix]):].partition(".")
        whole = f"{prefix}.{rest}" if prefix else rest
        if whole in got or index != "0":
            continue
        shards = [params[f"{lead[prefix]}{r}.{rest}"]
                  for r in range(len(sums[prefix].shards))]
        if rest not in sums[prefix].dims:
            got[whole] = p.grad
        else:
            got[whole] = tp_join(rest, [s.grad for s in shards],
                                 sums[prefix].dims[rest])
    return got


def bit_checksums(tensors):
    """Two int64 checksums of each tensor's bits, a row a tensor, on the
    host: the bits' sum, and their sum weighted by position (mod 127, plus
    1). Bit-equal tensors give equal rows; a changed bit always changes
    the first."""
    import torch
    as_int = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.uint8}
    rows = []
    for t in tensors:
        flat = t.detach().contiguous().view(-1)
        bits = flat.view(as_int[flat.element_size()]).long()
        weight = torch.arange(bits.numel(), device=bits.device) % 127 + 1
        rows.append(torch.stack([bits.sum(), (bits * weight).sum()]))
    return (torch.stack(rows).cpu() if rows
            else torch.zeros((0, 2), dtype=torch.int64))


def tp_replicas_differ(names, sums, sliced, group=None) -> list:
    """The tensors a tp group must hold bit-equal on every rank (those of
    `names` not in `sliced`) whose `bit_checksums` rows `sums` differ over
    the ranks of `group` (a collective; every rank gets the same list)."""
    import torch
    import torch.distributed as dist
    parts = [torch.empty_like(sums)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, sums, group=group)
    return [n for i, n in enumerate(names) if n not in sliced
            and any(not torch.equal(p[i], parts[0][i]) for p in parts)]


def train_state_checksums(ts):
    """(names, `bit_checksums`) of a train state's parameters, AdamW
    moments and EMA, each under its parameter's name (the moments and the
    EMA prefixed "mu ", "nu ", "ema ")."""
    names = list(ts.params)
    tensors = dict(ts.params)
    for key, values in (("mu", ts.optimizer.mu), ("nu", ts.optimizer.nu),
                        ("ema", (ts.ema_params or {}).values())):
        tensors.update((f"{key} {n}", v) for n, v in zip(names, values))
    return list(tensors), bit_checksums(tensors.values())


def tp_sliced_names(dims) -> set:
    """`train_state_checksums`'s names of a tp rank's slices."""
    return {f"{key}{n}" for n in dims for key in ("", "mu ", "nu ", "ema ")}


class TpRecord:
    """Phase 17's callback (named by a `_target_` override; each instance
    kept in `runs`): the UNet's parameter count on this rank and the
    device memory held at the fit's start; per step the metrics, its end
    (synchronised), its launches and its peak memory; the first step's
    gradients as the optimizer takes them (this rank's parts, fp32 on the
    host), and its microbatches' loss calls (the batch, the generator's
    state and the keywords), which `_tp_replay` runs again; at the fit's
    end the train state's `train_state_checksums`."""

    runs: list = []

    def __init__(self):
        self.steps, self.ends, self.launches, self.peaks = [], [], [], []
        self.grads, self.n_params, self.held = None, None, None
        self.micro, self._at, self.checksums = [], None, None
        TpRecord.runs.append(self)

    def run_event(self, event, state, logger) -> None:
        import torch
        name = event.value
        if name == "fit_start":
            self.n_params = sum(p.numel() for p in
                                state.model.unet.parameters())
            torch.cuda.synchronize()
            self.held = torch.cuda.memory_allocated()
            opt = state.train_state.optimizer
            names, step = list(state.train_state.params), opt.step

            def recording(grad_norm=None, grads=None, **ema):
                if self.grads is None:
                    self.grads = {n: g.detach().float().cpu()
                                  for n, g in zip(names, grads)}
                return step(grad_norm=grad_norm, grads=grads, **ema)
            opt.step = recording
            loss_fn = state.model.loss_fn

            def first_step_calls(batch, generator=None, *draws, **kwargs):
                if self.grads is None:
                    self.micro.append(({k: v.clone() for k, v in
                                        batch.items()},
                                       generator.get_state(), kwargs))
                return loss_fn(batch, generator, *draws, **kwargs)
            state.model.loss_fn = first_step_calls
        elif name == "batch_start":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            self._at = {k: c.value for k, c in _counters().items()}
        elif name == "batch_end":
            metrics = {k: float(v) for k, v in state.metrics.items()}
            torch.cuda.synchronize()
            self.ends.append(time.perf_counter())
            self.steps.append(metrics)
            self.launches.append({k: c.value - self._at[k]
                                  for k, c in _counters().items()})
            self.peaks.append(torch.cuda.max_memory_allocated())
        elif name == "fit_end":
            self.checksums = train_state_checksums(state.train_state)

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, d: dict) -> None:
        pass


def _tp_overrides(shards: str, tp: int, steps: int = TP_STEPS) -> list:
    """Phase 17's dotted overrides of yamls/SD-2-base-512-tp.yaml: no rank
    but tp's (fsdp 1, data 1), global batch 16 (the 2048 cut) in the
    yaml's microbatches of 8, `steps` batches over the 512px latent shards
    `shards`, no eval; with tp 1, the reference run."""
    out = [f"batch_size={TP_BATCH}", "trainer.mesh_config.fsdp=1",
           "trainer.mesh_config.data=1", f"trainer.max_duration={steps}ba",
           "~logger", "~dataset.eval_dataset",
           f"dataset.train_dataset.remote={shards}",
           f"dataset.train_dataset.local={shards}",
           "dataset.train_dataset.num_workers=2",
           f"+callbacks.chip_smoke._target_={__name__}.TpRecord"]
    return out + ([] if tp == TP_RANKS else [f"trainer.mesh_config.tp={tp}"])


def _tp_run(shards: str, tp: int, steps: int = TP_STEPS) -> dict:
    """One run of the tp yaml through `diffusion_torch.run.main` for
    `steps` batches, the counters at 0 right before it: what its TpRecord
    holds, its launches and the flash calls a microbatch by query shape
    (over the steps that call the wrapper: tp 1 replays the step's CUDA
    graph from its third step on)."""
    import torch

    from diffusion_torch import run
    from diffusion_torch.ops import flash_attention as fa
    from diffusion_torch.utils.profiler import step_graph

    shapes = []
    for c in _counters().values():
        c.reset()
    TpRecord.runs.clear()
    graph0 = (step_graph.replays, step_graph.captures)
    with _patch(fa, "flash_attention_cuda", _shape_spy(shapes)):
        t0 = time.perf_counter()
        run.main(["--config-path", os.path.join(_ROOT, "yamls"),
                  "--config-name", TP_YAML,
                  *_tp_overrides(shards, tp, steps)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    shapes = [q for q, _ in shapes]
    # a replay launches from the graph, not through the wrapper; the
    # capturing step calls it once, and replays too
    called = (steps - (step_graph.replays - graph0[0])
              + (step_graph.captures - graph0[1]))
    record = TpRecord.runs[-1]
    _check(len(record.steps) == steps,
           f"tp {tp}: {len(record.steps)} steps, {steps} expected")
    return {"steps": record.steps, "wall": wall,
            "step_s": [b - a for a, b in zip(record.ends, record.ends[1:])],
            "launches": {k: c.value for k, c in _counters().items()},
            "step_launches": record.launches[-1],
            "peak": max(record.peaks), "held": record.held,
            "n_params": record.n_params, "grads": record.grads,
            "micro": record.micro, "checksums": record.checksums,
            "flash": {str(s): shapes.count(s) / (called * 2)
                      for s in sorted(set(shapes))}}


def _grad_errors(got: dict, want: dict, slicer=None) -> dict:
    """Gradients against a reference: the largest error over phase 16(b)'s
    elementwise bound (one bf16 ulp of the tensor's largest gradient,
    doubled; the tensor), how many tensors exceed it, and phase 6's
    relative L2 errors (the largest tensor's, the whole gradient's).
    `slicer(name, whole)` gives the part of a reference tensor that `got`
    holds."""
    worst, over, num, den, rel = (0.0, None), 0, 0.0, 0.0, (0.0, None)
    for name, g in got.items():
        w = want[name] if slicer is None else slicer(name, want[name])
        _check(g.shape == w.shape, f"{name}: {tuple(g.shape)} against "
               f"the reference's {tuple(w.shape)}")
        d = (g - w).abs()
        ratio = (d.max() / (2.0 ** -6 * w.abs().max() + 1e-30)).item()
        over += ratio > 1
        n, m = d.square().sum().item(), w.square().sum().item()
        num, den = num + n, den + m
        if ratio >= worst[0]:
            worst = (ratio, name)
        if (n / max(m, 1e-30)) ** 0.5 >= rel[0]:
            rel = ((n / max(m, 1e-30)) ** 0.5, name)
    return {"ratio": worst[0], "ratio_at": worst[1], "over": over,
            "tensors": len(got), "rel": rel[0], "rel_at": rel[1],
            "whole_rel": (num / max(den, 1e-30)) ** 0.5}


def _tp_replay(micro: list, twin: bool) -> dict:
    """The tp 1 run's first step again on a fresh model of the same seed,
    from its recorded microbatches and generator states: with `twin`, on
    the UNet's tp local twin (every sliced layer as its 2 shards in this
    process, `tp_local_twin`), the ranks' arithmetic without the ranks.
    The gradients under the whole UNet's names, averaged as the Trainer
    averages them, fp32 on the host."""
    import dataclasses

    import torch

    from diffusion_torch.models.models import stable_diffusion_2
    from diffusion_torch.parallel.sharding import model_tp_head_dim

    model = stable_diffusion_2(precomputed_latents=True, device=DEVICE,
                               seed=0)
    if twin:
        model = dataclasses.replace(model, unet=tp_local_twin(
            model.unet, TP_RANKS, model_tp_head_dim(model)))
    model.unet.train()
    for batch, gen_state, kwargs in micro:
        gen = torch.Generator(device=DEVICE)
        gen.set_state(gen_state)
        model.loss_fn(batch, gen, **kwargs).backward()
    grads = (tp_twin_grads(model.unet) if twin else
             {n: p.grad for n, p in model.unet.named_parameters()})
    out = {n: (g / len(micro)).float().cpu() for n, g in grads.items()}
    del model, grads
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _tp_rank_main(rank: int, port: int, tmp: str) -> int:
    """A tp rank of phase 17(a), in a process of its own: a gloo process
    group over the two ranks, the shared card `cuda:0`, the tp yaml through
    `run.main`, then its first step's gradients against the reference
    runs' (`tmp`/one_grads.pt, `tmp`/twin_grads.pt), sliced as this rank
    holds them, and the whole tensors of its train state against the other
    rank's (`tp_replicas_differ`). Then the control: the yaml again for
    one batch with a planted fault, `tp_copy` without its backward sum (a
    plain copy), whose gradients and replicas are read the same way.
    Writes `tmp`/rank_<rank>.json; where gloo refuses a CUDA tensor, the
    error."""
    import torch
    import torch.distributed as dist

    from diffusion_torch.models.unet import SD2_BASE_UNET, UNet2DCondition
    from diffusion_torch.ops import _build
    from diffusion_torch.parallel import sharding
    from diffusion_torch.parallel.sharding import (model_tp_head_dim,
                                                   tp_placement, tp_slice)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=TP_RANKS, rank=rank)
    out_path = os.path.join(tmp, f"rank_{rank}.json")
    try:
        probe = torch.ones(4, device=DEVICE)
        try:
            dist.all_reduce(probe)
        except RuntimeError as e:        # gloo refusing CUDA tensors
            with open(out_path, "w") as f:
                json.dump({"gloo_cuda_error": " ".join(str(e).split())}, f)
            return 0
        _check(probe.tolist() == [2.0] * 4, f"gloo all_reduce gave {probe}")
        _build.library()
        with torch.device("meta"):
            unet = UNet2DCondition(SD2_BASE_UNET)

        class _Model:
            pass
        model = _Model()
        model.unet = unet
        dims = tp_placement(unet, TP_RANKS, model_tp_head_dim(model))

        def mine(name, whole):
            return (tp_slice(name, whole, dims[name], rank, TP_RANKS)
                    if name in dims else whole)

        def read(got):
            grads = got.pop("grads")
            got.pop("micro")
            got["replicas_differ"] = tp_replicas_differ(
                *got.pop("checksums"), tp_sliced_names(dims))
            got["sliced"] = sum(n in dims for n in grads)
            return grads

        got = _tp_run(os.path.join(tmp, "shards"), TP_RANKS)
        grads = read(got)
        for key in ("one", "twin"):
            ref = torch.load(os.path.join(tmp, f"{key}_grads.pt"))
            got[f"grads_{key}"] = _grad_errors(grads, ref, mine)
            del ref
        del grads
        gc.collect()
        torch.cuda.empty_cache()
        real = sharding.tp_copy
        sharding.tp_copy = lambda x, shard: x.clone()    # the planted fault
        try:
            control = _tp_run(os.path.join(tmp, "shards"), TP_RANKS, 1)
        finally:
            sharding.tp_copy = real
        grads = read(control)
        ref = torch.load(os.path.join(tmp, "one_grads.pt"))
        got["control"] = {"steps": control["steps"],
                          "replicas_differ": control["replicas_differ"],
                          "grads_one": _grad_errors(grads, ref, mine)}
        with open(out_path, "w") as f:
            json.dump(got, f)
    finally:
        dist.destroy_process_group()
    return 0


def _tp_ranks(tmp: str) -> dict:
    """(a)'s two tp ranks: `chip_smoke.py --tp-rank r` processes sharing
    the card, each printing to its log under `tmp`; their results, or
    the one-line error where gloo refused a CUDA tensor."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for r in range(TP_RANKS):
            log = open(os.path.join(tmp, f"rank_{r}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--tp-rank",
                 str(r), "--tp-port", str(port), "--tp-dir", tmp],
                cwd=_ROOT, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + TP_RANK_TIMEOUT
        codes = [p.wait(timeout=max(1.0, deadline - time.monotonic()))
                 for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    wall = time.perf_counter() - t0
    results = []
    for r, code in enumerate(codes):
        if code != 0:
            with open(os.path.join(tmp, f"rank_{r}.log")) as f:
                tail = f.read()[-3000:]
            _check(False, f"tp rank {r} exited {code}: {tail}")
        with open(os.path.join(tmp, f"rank_{r}.json")) as f:
            results.append(json.load(f))
    return {"ranks": results, "wall": wall}


def _tp_yaml_phase(card: str, tmp: str) -> dict:
    """(a) The tp yaml as two tp ranks sharing the card over gloo, against
    the same run with tp 1 in this process; returns the five kernels'
    launches in the three runs."""
    import numpy as np
    import torch

    shards = os.path.join(tmp, "shards")
    t0 = time.perf_counter()
    nbytes = _write_laion_shards(shards, TP_TRAIN, np.random.default_rng(17),
                                 size=512)
    print(f"tp: {TP_TRAIN} seeded 512px latent + caption-latent samples "
          f"({nbytes / 1e6:.1f} MB of MDS shards) in "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"tp yaml: yamls/{TP_YAML} through diffusion_torch.run.main with "
          f"the dotted overrides {' '.join(_tp_overrides(shards, 1))} "
          f"(the tp 1 reference, this process); the tp ranks the same "
          f"without trainer.mesh_config.tp=1")
    torch.cuda.reset_peak_memory_stats()
    one = _tp_run(shards, 1)
    grads, micro = one.pop("grads"), one.pop("micro")
    one.pop("checksums")
    gc.collect()
    torch.cuda.empty_cache()
    # the first step again in this process: on the same UNet (the replay
    # must give the run's gradients), then on its tp local twin
    t0 = time.perf_counter()
    replay = _grad_errors(_tp_replay(micro, twin=False), grads)
    twin = _tp_replay(micro, twin=True)
    twin_err = _grad_errors(twin, grads)
    print(f"tp yaml: the tp 1 run's first step replayed from its "
          f"{len(micro)} recorded microbatches and generator states on a "
          f"fresh model of the seed: against the run's gradients "
          f"{replay}; on the UNet's tp local twin (each sliced layer as "
          f"{TP_RANKS} shards in this process, the partials summed in "
          f"bf16 as tp_reduce sums them), against the tp 1 run's "
          f"{twin_err}; {time.perf_counter() - t0:.1f} s [{card}]")
    _check(replay["ratio"] <= 1.0, "the replay does not give the run's "
                                   "first-step gradients")
    torch.save(grads, os.path.join(tmp, "one_grads.pt"))
    torch.save(twin, os.path.join(tmp, "twin_grads.pt"))
    del grads, twin, micro
    gc.collect()
    ranks = _tp_ranks(tmp)
    launches = dict(one["launches"])
    error = ranks["ranks"][0].get("gloo_cuda_error")
    if error is not None:
        print(f"tp yaml: gloo refused a CUDA tensor, so the two tp ranks "
              f"did not run on the card (no pass): {error}")
        return launches

    def line(label, got):
        m = got["steps"]
        return (f"tp yaml: {label}: losses "
                + ", ".join(f"{s['loss/train/total']:.6f}" for s in m)
                + "; grad norms "
                + ", ".join(f"{s['grad/global_norm']:.6f}" for s in m)
                + f"; UNet parameters {got['n_params']:,}; device memory "
                f"held at the fit's start {got['held'] / 2 ** 30:.2f} GiB, "
                f"a step's peak {got['peak'] / 2 ** 30:.2f} GiB; flash "
                f"calls a microbatch's forward {got['flash']}; a step's "
                f"launches {got['step_launches']}; steps after the first "
                + ", ".join(f"{s * 1e3:.1f}" for s in got["step_s"])
                + f" ms; run {got['wall']:.1f} s [{card}]")

    def off(got, ref, key):
        """The largest relative gap of a metric's steps to tp 1's (over
        the steps both ran)."""
        return max(abs(a[key] - b[key]) / abs(b[key])
                   for a, b in zip(got["steps"], ref["steps"]))

    def misses(got):
        """The limits against tp 1 a rank's run misses."""
        g = got["grads_one"]
        return [name for name, bad in (
            ("loss", off(got, one, "loss/train/total") > TP_LOSS_REL),
            ("grad norm", off(got, one, "grad/global_norm") > TP_NORM_REL),
            ("a tensor's gradient", g["rel"] > TP_GRAD_REL),
            ("the whole gradient", g["whole_rel"] > TP_GRAD_WHOLE_REL),
            ("replicas", bool(got["replicas_differ"]))) if bad]

    limits = (f"losses within {TP_LOSS_REL:g} and grad norms within "
              f"{TP_NORM_REL:g} relative, first-step gradients within "
              f"relative L2 {TP_GRAD_REL:g} a tensor and "
              f"{TP_GRAD_WHOLE_REL:g} whole")
    print(line("tp 1 (one process, the reference)", one))
    for r, got in enumerate(ranks["ranks"]):
        print(line(f"tp rank {r} of {TP_RANKS} (two processes sharing one "
                   f"card: the times are not a tp speed)", got))
        print(f"tp yaml: tp rank {r} against tp 1 ({limits}): losses "
              f"{off(got, one, 'loss/train/total'):.3e}, grad norms "
              f"{off(got, one, 'grad/global_norm'):.3e} relative at most; "
              f"first-step gradients ({got['sliced']} tensors sliced as "
              f"the rank holds them) {got['grads_one']}; against the "
              f"local twin's (phase 16(b)'s ratio <= 1) "
              f"{got['grads_twin']}; whole tensors of the train state "
              f"(parameters, moments, EMA) differing from the other "
              f"rank's: {len(got['replicas_differ'])} "
              f"{got['replicas_differ'][:3]} [{card}]")
        ctl = got["control"]
        print(f"tp yaml: tp rank {r}, control (tp_copy's backward not "
              f"summing, 1 batch): loss "
              f"{off(ctl, one, 'loss/train/total'):.3e}, grad norm "
              f"{off(ctl, one, 'grad/global_norm'):.3e} relative; "
              f"first-step gradients {ctl['grads_one']}; whole "
              f"tensors differing from the other rank's "
              f"{len(ctl['replicas_differ'])}; misses {misses(ctl)} "
              f"[{card}]")
        for k, v in got["launches"].items():
            launches[k] += v
        _check(not misses(got), f"tp rank {r} misses the tp 1 run's "
                                f"limits ({limits}): {misses(got)}")
        _check({"grad norm", "a tensor's gradient", "the whole gradient",
                "replicas"} <= set(misses(ctl)),
               f"tp rank {r}: the control passes limits it must miss: "
               f"{misses(ctl)}")
        _check(got["grads_twin"]["ratio"] <= 1.0, f"tp rank {r}: the first "
               f"step's gradients miss the local twin's "
               f"({got['grads_twin']})")
        _check(got["flash"] == {str(k): float(v)
                                for k, v in sorted(TP_FLASH.items())},
               f"tp rank {r}: flash calls {got['flash']}")
        _check(got["step_launches"]["group_norm"]
               == one["step_launches"]["group_norm"]
               and got["step_launches"]["group_norm_bwd"]
               == one["step_launches"]["group_norm_bwd"],
               f"tp rank {r}: GroupNorm launches a step "
               f"{got['step_launches']} against tp 1's "
               f"{one['step_launches']}")
        _check(got["n_params"] < one["n_params"],
               f"tp rank {r} holds {got['n_params']} parameters")
    _check(one["flash"] == {str(k): float(v)
                            for k, v in sorted(TP_FLASH_ONE.items())},
           f"tp 1: flash calls {one['flash']}")
    n0 = ranks["ranks"][0]["n_params"]
    print(f"tp yaml: each tp rank holds {n0:,} of the UNet's "
          f"{one['n_params']:,} parameters ({n0 / one['n_params']:.4f}); "
          f"the two ranks' processes {ranks['wall']:.1f} s [{card}]")
    for name, n in launches.items():
        _check(n > 0, f"tp yaml: {name} was not launched")
    return launches


def _tp_dispatch_check(card: str) -> None:
    """(b) `tp_copy` and `tp_reduce` on a one-rank NCCL group, forward and
    backward through autograd: fresh outputs equal to their inputs, and
    the cotangents through the NCCL all-reduce."""
    import socket

    import torch
    import torch.distributed as dist

    from diffusion_torch.parallel.mesh import MESH_AXES, create_mesh
    from diffusion_torch.parallel.sharding import (RowShard, register_group,
                                                   tp_copy, tp_reduce)

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        mesh = create_mesh(fsdp=1)
        shard = RowShard(register_group(mesh.get_group(
            MESH_AXES.index("tp"))), 0, 1)
        gen = torch.Generator(device=DEVICE).manual_seed(20)
        x, g = (torch.randn((8, 1024, 640), generator=gen,
                            device=DEVICE).to(torch.bfloat16)
                for _ in range(2))
        ok = {}
        for name, op in (("tp_copy", tp_copy), ("tp_reduce", tp_reduce)):
            xi = x.clone().requires_grad_(True)
            y = op(xi, shard)
            y.backward(g)
            torch.cuda.synchronize()
            ok[name] = (torch.equal(y, x), y.data_ptr() != xi.data_ptr(),
                        torch.equal(xi.grad, g))
        print(f"tp dispatch: tp_copy and tp_reduce over a one-rank "
              f"{dist.get_backend()} group at (8, 1024, 640) bf16, forward "
              f"and backward: (output equal to the input, a fresh tensor, "
              f"cotangent through) {ok} [{card}]")
        _check(all(all(v) for v in ok.values()),
               "the tp dispatcher ops disagree on the card")
    finally:
        dist.destroy_process_group()


def _tp_kernel_work(card: str) -> None:
    """(c) One Transformer2D of the 10-head level (640 channels, 32x32
    tokens) and one of the 5-head level (320, 64x64), batch 8, split into
    their tp = 2 shards by the port's slicing (`tp_local_twin`: the
    partials summed where `tp_reduce` would), forward and backward through
    the kernels against the whole block."""
    import torch

    from diffusion_torch.models.layers import Transformer2D, init_like_flax_
    from diffusion_torch.ops import flash_attention as fa

    for channels, heads, side in ((640, 10, 32), (320, 5, 64)):
        gen = torch.Generator(device=DEVICE).manual_seed(21)
        block = Transformer2D(channels, heads, 1024).to(DEVICE)
        init_like_flax_(block, gen)
        with torch.no_grad():       # nonzero biases and norms
            for p in block.parameters():
                p.add_(0.02 * torch.randn(p.shape, generator=gen,
                                          device=DEVICE))
        twin = tp_local_twin(block, TP_RANKS, 64)
        x = torch.randn((8, channels, side, side), generator=gen,
                        device=DEVICE).to(torch.bfloat16).contiguous(
                            memory_format=torch.channels_last)
        ctx = torch.randn((8, 77, 1024), generator=gen,
                          device=DEVICE).to(torch.bfloat16)
        dy = torch.randn(x.shape, generator=gen, device=DEVICE).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        runs = {}
        for label, m in (("whole", block), ("shards", twin)):
            shapes = []

            def step():
                xi = x.clone().requires_grad_(True)
                y = m(xi, ctx)
                y.backward(dy)
                return y, xi

            with _patch(fa, "flash_attention_cuda", _shape_spy(shapes)):
                m.zero_grad(set_to_none=True)
                y, xi = step()
                torch.cuda.synchronize()
            grads = (tp_twin_grads(m) if m is twin else
                     {n: p.grad for n, p in m.named_parameters()})
            runs[label] = (y.detach(), xi.grad, {
                n: g.clone() for n, g in grads.items()},
                sorted(q for q, _ in shapes))
            runs[label] += (_time_ms(step, iters=5, warmup=2),)
        (y1, dx1, g1, s1, ms1), (y2, dx2, g2, s2, ms2) = (runs["whole"],
                                                          runs["shards"])

        def excess(got, want):
            return ((got.float() - want.float()).abs().max()
                    / (2.0 ** -6 * want.float().abs().max() + 1e-30)).item()
        errs = {"out": excess(y2, y1), "dx": excess(dx2, dx1),
                "grads": max(excess(g2[n], g1[n]) for n in g1)}
        print(f"tp shards: Transformer2D({channels}, {heads} heads) at "
              f"(8, {side * side}) tokens as {TP_RANKS} tp shards summed "
              f"where tp_reduce would, against the whole block: error over "
              f"its bf16 bound {errs} (<= 1; {len(g1)} parameters); flash "
              f"query shapes {s2} (whole: {s1}); forward + backward "
              f"{ms2:.3f} ms against the whole block's {ms1:.3f} ms "
              f"[{card}]")
        _check(sorted(g2) == sorted(g1) and all(e <= 1.0
                                                for e in errs.values()),
               f"the tp shards of Transformer2D({channels}) disagree with "
               f"the whole block")
        want = ([(8, side * side, heads // TP_RANKS, 64)] * TP_RANKS
                if heads % TP_RANKS == 0 else [(8, side * side, heads, 64)])
        _check(s2 == want, f"tp shards: flash calls {s2}, {want} expected")
        del block, twin, runs
        gc.collect()
        torch.cuda.empty_cache()


def _tp_phase(card: str) -> dict:
    """Phase 17 (see the module docstring); returns the five kernels'
    launches in (a)'s three runs."""
    import torch

    tmp = os.path.join(_ROOT, "build", "chip_smoke_tp")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    t0 = time.perf_counter()
    try:
        launches = _tp_yaml_phase(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    _tp_dispatch_check(card)
    _tp_kernel_work(card)
    print(f"tp: one card ({torch.cuda.device_count()}): tp ranks ran across "
          f"processes only on the CPU over gloo (tests/"
          f"test_torch_ring_attention.py, tests/test_torch_mesh_trainer.py) "
          f"and as two processes sharing this card over gloo (a); NCCL "
          f"across cards is not run by this script; phase "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    return launches


def _eval_job_args(remote: str, out: str) -> tuple:
    """The argument lists of phase 11's two runs: the port's
    fid_clip_evaluation (yamls/eval.yaml's job, with dpm++2m at 20 steps)
    and coco_eval (two guidance scales, 10 DDIM steps), at full width on
    the card with random towers."""
    common = ["--remote", remote, "--size", str(TRAIN_SIZE), "--batch_size",
              str(EVAL_BATCH), "--allow_random_towers", "--device", DEVICE]
    fid = common + ["--subset_num_batches", str(EVAL_BATCHES),
                    "--guidance_scale", "3.0", "--scheduler", "dpm++2m",
                    "--num_inference_steps", "20", "--out", out]
    coco = common + ["--subset_num_batches", "1", "--guidance_scales", "1.0",
                     "7.0", "--num_inference_steps", "10"]
    return fid, coco


def _tower_reference(card: str) -> tuple:
    """The full-width towers on the card against fp32 CPU copies of
    themselves on 2 images: InceptionV3 features and logits, CLIP image and
    text embeddings. Returns the two towers."""
    import copy

    import torch

    from diffusion_torch.metrics import towers
    from diffusion_torch.models.inception import preprocess_images

    inception = towers.inception_tower(allow_random_weights=True,
                                       device=DEVICE)
    clip = towers.clip_tower(allow_random_weights=True, device=DEVICE)
    gen = torch.Generator().manual_seed(11)
    images = torch.rand((2, TRAIN_SIZE, TRAIN_SIZE, 3), generator=gen)
    ids = torch.randint(1, 49000, (2, 77), generator=gen)
    ids[:, 12] = 49407                           # EOT, the highest id

    def run(inc, cl, dev):
        x = preprocess_images(images.to(dev))
        pixels = towers.clip_pixels(images.to(dev), 224)
        txt, img = cl(ids.to(dev), pixels)
        return {"InceptionV3 features": inc(x),
                "InceptionV3 logits": inc(x, return_logits=True),
                "CLIP image embeddings": img, "CLIP text embeddings": txt}

    with torch.inference_mode():
        got = run(inception, clip, DEVICE)
        want = run(copy.deepcopy(inception).to("cpu"),
                   copy.deepcopy(clip).to("cpu"), "cpu")
    for name, out in got.items():
        err = _rel_l2(out, want[name])
        print(f"eval: {name} {tuple(out.shape)} fp32 on the card vs fp32 on "
              f"the CPU: relative L2 error {err:.3e} (bound {TOWER_BOUND:g},"
              f" TF32 off) [{card}]")
        _check(bool(torch.isfinite(out).all()) and err <= TOWER_BOUND,
               f"{name} disagrees with its fp32 CPU copy")
    return inception, clip


def _eval_job_phase(card: str) -> dict:
    """Phase 11: the offline eval job (see the module docstring). Returns
    the five kernels' launches during its two runs."""
    import tempfile

    import numpy as np
    import torch

    from diffusion_torch.metrics import towers
    from diffusion_torch.metrics.fid import FrechetInceptionDistance
    from diffusion_torch.models.inception import preprocess_images
    from diffusion_torch.models.stable_diffusion import StableDiffusion
    from diffusion_torch.scripts import coco_eval, fid_clip_evaluation
    from diffusion_torch.utils.logging import LoggerCollection

    t_phase = time.perf_counter()
    inception, clip = _tower_reference(card)
    # the towers alone on 32 images (CUDA events)
    with torch.inference_mode():
        x = torch.rand((32, TRAIN_SIZE, TRAIN_SIZE, 3), device=DEVICE)
        ids = torch.randint(1, 49000, (32, 77), device=DEVICE)
        inc_ms = _time_ms(lambda: inception(preprocess_images(x)), iters=3,
                          warmup=1)
        clip_ms = _time_ms(lambda: clip(ids, towers.clip_pixels(x, 224)),
                           iters=3, warmup=1)
    del x, ids
    print(f"eval: towers on 32 {TRAIN_SIZE}px images: InceptionV3 (resize "
          f"to 299 included) {inc_ms:.2f} ms, CLIP ViT-L/14 image and text "
          f"(resize to 224 included) {clip_ms:.2f} ms (CUDA events, 3 after "
          f"1) [{card}]")

    # time each generate, each FID compute and each logged image
    gens, computes, logged = [], [], []
    real_generate = StableDiffusion.generate
    real_compute = FrechetInceptionDistance.compute
    real_log = LoggerCollection.log_images

    def timed_generate(self, prompt_ids, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_generate(self, prompt_ids, **kw)
        torch.cuda.synchronize()
        gens.append((prompt_ids.shape[0], kw.get("num_inference_steps"),
                     type(self.inference_scheduler).__name__,
                     time.perf_counter() - t0))
        return out

    def timed_compute(self):
        t0 = time.perf_counter()
        out = real_compute(self)
        computes.append(time.perf_counter() - t0)
        return out

    def log_images(self, images, name="image", step=None, **kw):
        logged.append((name, tuple(np.asarray(images).shape)))
        return real_log(self, images, name=name, step=step, **kw)

    counters = _counters()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
        remote = os.path.join(tmp, "coco")
        nbytes = _write_coco_shards(remote, EVAL_SAMPLES,
                                    np.random.default_rng(6))
        out = os.path.join(tmp, "eval_metrics.jsonl")
        fid_args, coco_args = _eval_job_args(remote, out)
        print(f"eval: wrote {EVAL_SAMPLES} COCO samples ({nbytes / 1e6:.1f} "
              f"MB of MDS shards, phase 8's writer); python -m "
              f"diffusion_torch.scripts.fid_clip_evaluation "
              f"{' '.join(fid_args)}")
        StableDiffusion.generate = timed_generate
        FrechetInceptionDistance.compute = timed_compute
        LoggerCollection.log_images = log_images
        try:
            for c in counters.values():
                c.reset()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            fid = fid_clip_evaluation.main(fid_args)
            torch.cuda.synchronize()
            fid_wall = time.perf_counter() - t0
            fid_launches = {n: c.value for n, c in counters.items()}
            fid_peak = torch.cuda.max_memory_allocated() / 2 ** 30
            with open(out) as f:
                records = [json.loads(line) for line in f]
            fid_gens, fid_computes = list(gens), list(computes)
            gens.clear()
            computes.clear()
            for c in counters.values():
                c.reset()
            t0 = time.perf_counter()
            multi = coco_eval.main(coco_args)
            torch.cuda.synchronize()
            coco_wall = time.perf_counter() - t0
            coco_launches = {n: c.value for n, c in counters.items()}
        finally:
            StableDiffusion.generate = real_generate
            FrechetInceptionDistance.compute = real_compute
            LoggerCollection.log_images = real_log

    keys = ("metrics/coco-val/FrechetInceptionDistance-scale-3p0",
            "metrics/coco-val/CLIPScore-scale-3p0")
    for key in keys:
        print(f"eval: fid_clip_evaluation {key} = {fid.get(key)!r} (random "
              f"towers)")
        _check(key in fid and math.isfinite(fid[key]), f"{key} not finite")
        _check(any(key in r for r in records), f"{key} not in --out")
    batch_gens = [g for g in fid_gens if g[0] == EVAL_BATCH]
    _check(len(batch_gens) == EVAL_BATCHES
           and all(g[2] == "DPMSolverMultistepScheduler" for g in batch_gens),
           f"the eval's generate calls {fid_gens} are not one dpm++2m batch "
           f"per eval batch")
    _check(len(logged) == 10 and {s for _, s in logged}
           == {(TRAIN_SIZE, TRAIN_SIZE, 3)},
           f"LogDiffusionImages logged {logged}, not ten {TRAIN_SIZE}px "
           f"images")
    print(f"eval: fid_clip_evaluation: {len(records)} record(s) in --out, "
          f"{len(logged)} images of {logged[0][1]} from LogDiffusionImages; "
          f"the job {fid_wall:.2f} s (model and towers built, "
          f"{EVAL_BATCHES} batches of {EVAL_BATCH}); generation "
          f"{', '.join(f'{g[3]:.3f}' for g in batch_gens)} s per batch "
          f"({batch_gens[0][1]} steps of {batch_gens[0][2]}, CFG batch "
          f"{2 * EVAL_BATCH}, decode included); LogDiffusionImages "
          f"{sum(g[3] for g in fid_gens if g[0] != EVAL_BATCH):.3f} s; host "
          f"FID compute() (two 2048x2048 eigh) "
          f"{', '.join(f'{c * 1e3:.1f}' for c in fid_computes)} ms; peak "
          f"device memory {fid_peak:.2f} GiB [{card}]")
    print(f"eval: kernel launches during fid_clip_evaluation "
          f"{json.dumps(fid_launches)}")
    for name in ("group_norm", "flash_attention"):
        _check(fid_launches[name] > 0,
               f"{name} was not launched during the eval job")
    for scale in ("1p0", "7p0"):
        for metric in ("FrechetInceptionDistance", "CLIPScore"):
            key = f"metrics/coco-val/{metric}-scale-{scale}"
            print(f"eval: coco_eval {key} = {multi.get(key)!r}")
            _check(key in multi and math.isfinite(multi[key]),
                   f"coco_eval: {key} missing or not finite")
    print(f"eval: coco_eval {coco_wall:.2f} s (2 scales x 1 batch of "
          f"{EVAL_BATCH}, 10 DDIM steps); kernel launches "
          f"{json.dumps(coco_launches)}; phase "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return {n: fid_launches[n] + coco_launches[n] for n in counters}


# ---------------- phase 18: the FLOP count, MFU and the compile cache -----

CFG_BATCH = 4            # phase 5's CFG step: 2 prompts x 2
FLOPS_YAML_STEPS = 3     # batches of the MFU run of the 256 yaml


class _FlashSpy:
    """Wraps the three flash kernels' wrappers while active: each launch
    adds its formula's FLOPs (`utils/flops.py`) at its own shapes."""

    def __init__(self):
        from diffusion_torch.ops import flash_attention as fa
        from diffusion_torch.utils import flops
        self.flops = {"flash_attention": 0, "flash_attention_bwd_dq": 0,
                      "flash_attention_bwd_dkv": 0}
        self.launches = dict.fromkeys(self.flops, 0)
        self._fa = fa
        self._wrapped = {}
        for name, attr, units in (
                ("flash_attention", "flash_attention_cuda",
                 flops.FLASH_FWD_UNITS),
                ("flash_attention_bwd_dq", "flash_attention_bwd_dq_cuda",
                 flops.FLASH_BWD_DQ_UNITS),
                ("flash_attention_bwd_dkv", "flash_attention_bwd_dkv_cuda",
                 flops.FLASH_BWD_DKV_UNITS)):
            self._wrapped[attr] = self._spy(name, getattr(fa, attr), units,
                                            flops.attention_unit)

    def _spy(self, name, fn, units, unit):
        def wrapper(q, k, *args):
            self.launches[name] += 1
            self.flops[name] += units * unit(q.shape, k.shape)
            return fn(q, k, *args)
        return fn, wrapper

    def __enter__(self):
        for attr, (_, wrapper) in self._wrapped.items():
            setattr(self._fa, attr, wrapper)
        return self

    def __exit__(self, *exc):
        for attr, (fn, _) in self._wrapped.items():
            setattr(self._fa, attr, fn)


def _flops_by_route(count, card_flops: dict, what: str,
                    plain: tuple) -> dict:
    """`count()` on the meta device routed as the card and as the CPU; the
    card's route must equal `card_flops` (counted on the card) in every
    class, and the CPU's must equal it in conv and in dot + p/f of flash,
    `plain` = (p, f): the plain attention's products where the flash ops
    price f units (2 / 2 forward, 6 / 9 with the backward)."""
    from diffusion_torch.utils.device import route_meta_as
    got = {}
    for route in ("cuda", "cpu"):
        with route_meta_as(route):
            got[route] = count()
    print(f"flops: {what}, counted on the meta device (the host, no data) "
          f"routed as the card: {_classes(got['cuda'])}; as the CPU: "
          f"{_classes(got['cpu'])}")
    _check(got["cuda"] == card_flops,
           f"{what}: the card's count {card_flops} differs from the meta "
           f"device's on the card's route {got['cuda']}")
    cpu = got["cpu"]
    p, f = plain
    _check(cpu["flash"] == 0 and cpu["conv"] == card_flops["conv"]
           and f * cpu["dot"] == f * card_flops["dot"]
           + p * card_flops["flash"],
           f"{what}: the CPU route's count {cpu} is not the card's with "
           f"plain attention")
    return got


def _classes(by_class: dict) -> str:
    total = sum(by_class.values())
    return (", ".join(f"{k} {v:.6e}" for k, v in by_class.items())
            + f", total {total:.6e}")


def _flops_count_phase(model, card: str, train_step_s: float,
                       cfg_ms: float) -> tuple:
    """Phase 18 (a) and (b), on phase 7's training model: one 256px
    microbatch of 16 of the recipe's step and one 512px CFG UNet step at
    batch 4 counted on the card, the flash class held to the launches
    times the formulas, dot and conv to the meta device's count; then
    `flops_per_batch` of the recipe's batch of 32 and the MFU of phase 7's
    step and of phase 5's CFG step. Returns (flops_per_batch, the kernels'
    launches while counting)."""
    import torch

    from diffusion_torch.models.models import stable_diffusion_2
    from diffusion_torch.scripts.measure_flops import microbatch_flops
    from diffusion_torch.utils.flops import device_peak_flops, flops_by_class

    t_phase = time.perf_counter()
    unet = model.unet
    counters = _counters()
    for c in counters.values():
        c.reset()
    counts = {}
    with _FlashSpy() as spy:
        t0 = time.perf_counter()
        counts["step"] = microbatch_flops(model, TRAIN_MICRO, TRAIN_SIZE)
        torch.cuda.synchronize()
        step_wall = time.perf_counter() - t0
        unet.zero_grad(set_to_none=True)
        step_spy = dict(spy.flops), dict(spy.launches)
        side = SIZE // 8
        lat = torch.randn((CFG_BATCH, 4, side, side), device=DEVICE
                          ).contiguous(memory_format=torch.channels_last)
        t = torch.full((CFG_BATCH,), 500, device=DEVICE, dtype=torch.int64)
        ctx = torch.randn((CFG_BATCH, 77, unet.config.cross_attention_dim),
                          device=DEVICE)
        with torch.no_grad():
            counts["cfg"] = flops_by_class(unet, lat, t, ctx)
        torch.cuda.synchronize()
    launches = {name: c.value for name, c in counters.items()}
    cfg_spy = ({k: v - step_spy[0][k] for k, v in spy.flops.items()},
               {k: v - step_spy[1][k] for k, v in spy.launches.items()})
    _check(spy.launches == {k: launches[k] for k in spy.launches},
           f"the launch counters {launches} differ from the wrappers' calls "
           f"{spy.launches}")
    for what, by_class, (flops, n) in (
            (f"256px microbatch of {TRAIN_MICRO}, loss and grad",
             counts["step"], step_spy),
            (f"{SIZE}px UNet CFG step, batch {CFG_BATCH}", counts["cfg"],
             cfg_spy)):
        print(f"flops: {what}, counted on the card: {_classes(by_class)}; "
              f"flash launches {json.dumps(n)} x their formulas "
              f"(2 / 3 / 4 units) = {sum(flops.values()):.6e} [{card}]")
        _check(by_class["flash"] == sum(flops.values()) > 0,
               f"{what}: the flash class {by_class['flash']} is not the "
               f"launches times their formulas {flops}")
        _check(by_class["dot"] > 0 and by_class["conv"] > 0,
               f"{what}: no dot or conv FLOPs counted")
    _check(cfg_spy[1]["flash_attention"] > 0
           and not cfg_spy[1]["flash_attention_bwd_dq"],
           f"the CFG step's launches {cfg_spy[1]}")
    t0 = time.perf_counter()
    meta = stable_diffusion_2(precomputed_latents=True, device="meta")
    meta_lat = torch.empty(lat.shape, device="meta").contiguous(
        memory_format=torch.channels_last)
    meta_t = torch.empty(t.shape, device="meta", dtype=torch.int64)
    meta_ctx = torch.empty(ctx.shape, device="meta")

    def meta_cfg():
        with torch.no_grad():
            return flops_by_class(meta.unet, meta_lat, meta_t, meta_ctx)

    _flops_by_route(lambda: microbatch_flops(meta, TRAIN_MICRO, TRAIN_SIZE),
                    counts["step"], "256px microbatch", (6, 9))
    _flops_by_route(meta_cfg, counts["cfg"], f"{SIZE}px CFG step", (2, 2))
    meta_s = time.perf_counter() - t0
    del meta

    peak = device_peak_flops()
    _check(peak is not None, f"no bf16 peak for {torch.cuda.get_device_name(0)}")
    per_batch = TRAIN_BATCH // TRAIN_MICRO * sum(counts["step"].values())
    cfg_flops = sum(counts["cfg"].values())
    train_mfu = per_batch / train_step_s / peak
    cfg_mfu = cfg_flops / (cfg_ms / 1e3) / peak
    print(f"flops: flops_per_batch {per_batch:.6e} for the recipe's batch of "
          f"{TRAIN_BATCH} ({TRAIN_BATCH // TRAIN_MICRO} microbatches of "
          f"{TRAIN_MICRO} at {TRAIN_SIZE}px; the optimizer's and EMA's "
          f"elementwise work not counted), {cfg_flops:.6e} a CFG step")
    print(f"flops: MFU against {peak / 1e12:.0f} TFLOP/s (bf16 dense, "
          f"device_peak_flops) [{card}]: phase 7's step "
          f"{train_step_s * 1e3:.1f} ms -> {per_batch / train_step_s / 1e12:.2f}"
          f" TFLOP/s, MFU {train_mfu:.4f}; phase 5's CFG step {cfg_ms:.2f} ms "
          f"-> {cfg_flops / cfg_ms / 1e9:.2f} TFLOP/s, MFU {cfg_mfu:.4f}")
    print(f"flops: the counted microbatch took {step_wall:.2f} s under the "
          f"counter, the meta counts {meta_s:.2f} s on the host; phase "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    _check(0 < train_mfu < 1 and 0 < cfg_mfu < 1,
           f"MFU outside (0, 1): {train_mfu}, {cfg_mfu}")
    return per_batch, launches


def _flops_yaml_overrides(tmp: str, metrics_file: str,
                          flops_per_batch: float) -> list:
    """Phase 8's shards and overrides for phase 18 (c): 3 batches, no eval,
    the SpeedMonitor given `flops_per_batch` (its peak from the card)."""
    return _composed_overrides(tmp, "flops", metrics_file) + [
        f"trainer.max_duration={FLOPS_YAML_STEPS}ba",
        "trainer.eval_interval=1000ba",
        f"+callbacks.speed_monitor.flops_per_batch={flops_per_batch!r}"]


def _flops_yaml_phase(card: str, flops_per_batch: float) -> dict:
    """Phase 18 (c): yamls/SD-2-base-256.yaml through `train(config)` for 3
    batches with `flops_per_batch` from (a): `throughput/device/mfu` must be
    logged and lie in (0, 1). Returns the kernels' launches."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_flops_") as tmp:
        _, _, launches, wall, _, records = _yaml_run(
            "flops", "SD-2-base-256.yaml", _flops_yaml_overrides(
                tmp, os.path.join(tmp, "metrics.jsonl"), flops_per_batch),
            FLOPS_YAML_STEPS, card)
    mfu = [(r["step"], r["throughput/device/mfu"],
            r["throughput/flops_per_sec"]) for r in records
           if "throughput/device/mfu" in r]
    print(f"flops: yamls/SD-2-base-256.yaml, {FLOPS_YAML_STEPS} batches of "
          f"{TRAIN_BATCH} with callbacks.speed_monitor.flops_per_batch="
          f"{flops_per_batch:.6e}: run {wall:.1f} s; throughput/device/mfu "
          + ", ".join(f"{m:.4f} at batch {s} ({fps / 1e12:.2f} TFLOP/s)"
                      for s, m, fps in mfu) + f" [{card}]")
    _check(mfu and all(0 < m < 1 for _, m, _ in mfu),
           f"throughput/device/mfu not logged or outside (0, 1): {mfu}")
    for name in launches:
        _check(launches[name] > 0, f"{name} was not launched in the MFU run")
    return launches


_CACHE_CHILD = """
import json, sys, time
from diffusion_torch.ops import _build
from diffusion_torch.utils.compile_cache import enable_compile_cache
calls, nvcc = [], _build._nvcc
_build._nvcc = lambda: calls.append(1) or nvcc()
path = enable_compile_cache(sys.argv[1])
t0 = time.perf_counter()
_build.library()
print(json.dumps({"dir": path, "library": _build.library_path(),
                  "nvcc_calls": len(calls),
                  "seconds": time.perf_counter() - t0}))
"""


def _cache_child(cache: str) -> tuple:
    """Start a child process that enables the compile cache on `cache` and
    loads the kernel library; returns (process, start time)."""
    return (subprocess.Popen([sys.executable, "-c", _CACHE_CHILD, cache],
                             cwd=_ROOT, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True),
            time.perf_counter())


def _cache_result(child: tuple) -> tuple:
    proc, t0 = child
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    _check(proc.returncode == 0, f"compile cache child failed: {err[-2000:]}")
    return json.loads(out.strip().splitlines()[-1]), time.perf_counter() - t0


def _compile_cache_phase(card: str, during):
    """Phase 18 (d): two child processes call `enable_compile_cache` on one
    fresh directory and load the kernel library; the first runs nvcc into
    it (while `during()` runs here), the second must not. Returns what
    `during()` returns."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cc_") as cache:
        first = _cache_child(cache)
        try:
            result = during()
        finally:
            runs = [_cache_result(first)]
        runs.append(_cache_result(_cache_child(cache)))
    for i, (r, wall) in enumerate(runs):
        print(f"compile cache: process {i + 1} on {r['dir']}: "
              f"{r['nvcc_calls']} nvcc call(s), library() {r['seconds']:.2f} "
              f"s, process {wall:.1f} s{' (beside (c))' if i == 0 else ''} "
              f"[{card}]")
        _check(os.path.dirname(r["library"]) == r["dir"] == cache,
               f"the library is not under the cache: {r}")
    _check(runs[0][0]["nvcc_calls"] == 1 and runs[1][0]["nvcc_calls"] == 0,
           f"the second process on the cache ran nvcc: {runs}")
    return result


def _profile_serving_step(unet, lat, t, ctx, card: str) -> None:
    """One more UNet CFG step under torch.profiler (CUDA activity), in the
    benchmark's window range, synchronized on both sides, read as the
    benchmark reads a trace (`portbench.trace.read_trace`): the device's
    busy time, its idle share of the window's wall time, and device time
    by kernel category; "not measured" where the profiler recorded no
    device events."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench.trace import WINDOW, category, read_trace

    what = f"serving UNet CFG step (batch {lat.shape[0]}, {SIZE}px, " \
           f"profiler on)"
    with torch.inference_mode():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(WINDOW):
                unet(lat, t, ctx)
                torch.cuda.synchronize()
    trace = read_trace(prof)
    if trace is None:
        print(f"profile: {what}: not measured (the profiler recorded no "
              f"device events) [{card}]")
        return
    kernels = collections.Counter(category(n) for *_, n in trace.ops)
    print(f"profile: {what}: {len(trace.ops)} kernels, device busy "
          f"{trace.busy_s * 1e3:.2f} ms, window {trace.window_s * 1e3:.2f} "
          f"ms, idle share {1 - trace.busy_s / trace.window_s:.3f} [{card}]")
    print(f"profile: {what}: device time by category (ms, kernels): "
          + "; ".join(f"{c} {t * 1e3:.2f} ({kernels[c]})" for c, t in
                      sorted(trace.by_category().items(),
                             key=lambda x: -x[1])))


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
    # phase 17's tp ranks: this script started again, one process a rank
    ap.add_argument("--tp-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--tp-port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--tp-dir", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    if args.tp_rank is not None:
        return _tp_rank_main(args.tp_rank, args.tp_port, args.tp_dir)
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

    # 2. build
    t0 = time.perf_counter()
    _build.library()
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
        # each instance: the flash kernels' whole-tile and tail templates
        # at head dims 64 and 128
        found = _instances(usage, name)
        _check(len(found) == 4 and all(
            u.get("spill_stores") == 0 and u.get("spill_loads") == 0
            for u in found.values()),
            f"ptxas reports spills (or not its four instances) for {name}: "
            f"{found}")
    _check(not any("wgmma_serialized" in u for u in
                   _instances(usage, "flash_bwd_dq_kernel").values()),
           "ptxas serialized the dQ kernel's wgmma pipeline")

    # 3. kernels against their plain versions
    kernels = _kernel_phase(card)
    _unet_group_norm_phase(card)
    # 3b. the fused AdamW (+ EMA) pass
    _adamw_phase(card)
    # 3c. the working copies' cast and gradient passes
    _working_copy_phase(card)

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
        if batch == CFG_BATCH:  # profiled at the end, after every timed phase
            serve_inputs, cfg_ms = (lat, t, ctx), ms
    print(f"times: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card}]")

    # 5b. img2img and inpainting on the same endpoint
    img2img_launches, ddim_text, ddim_s, encoder_calls = _img2img_phase(
        endpoint, card, results["first"][2])
    # 5c. the samplers over HTTP on the same endpoint
    sampler_launches = _sampler_phase(endpoint, card, ddim_text, ddim_s,
                                      encoder_calls)

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
    # 18. the FLOP count and MFU on phase 7's model, the MFU through the
    # 256 yaml, and the kernel library's compile cache
    flops_per_batch, flops_launches = _flops_count_phase(
        train_model, card, train_step_s, cfg_ms)
    del train_model
    gc.collect()
    torch.cuda.empty_cache()
    flops_yaml_launches = _compile_cache_phase(
        card, lambda: _flops_yaml_phase(card, flops_per_batch))
    gc.collect()
    torch.cuda.empty_cache()

    # 8-9. the composed run, and the fp32 UNet
    composed_launches, composed_steps, composed = _composed_phase(
        card, train_step_s)
    gc.collect()
    torch.cuda.empty_cache()
    online_launches, online = _online_phase(card, composed)
    gc.collect()
    torch.cuda.empty_cache()
    _fp32_unet_phase(card)
    gc.collect()
    torch.cuda.empty_cache()
    # 10. checkpoint, preempt, resume, and serve the checkpoint
    checkpoint_launches = _checkpoint_phase(card, composed_steps)
    gc.collect()
    torch.cuda.empty_cache()
    # 11. the offline eval job
    eval_launches = _eval_job_phase(card)
    gc.collect()
    torch.cuda.empty_cache()
    # 12-14. LoRA fine-tuning and serving, the Pexels and mixture readers,
    # pixel-space diffusion
    lora_launches = _lora_phase(card, online)
    gc.collect()
    torch.cuda.empty_cache()
    reader_launches = _readers_phase(card)
    gc.collect()
    torch.cuda.empty_cache()
    pixel_launches = _pixel_phase(card)
    gc.collect()
    torch.cuda.empty_cache()
    # 15. the main recipe: precompute, phase 1, phase 2 warm-started
    recipe_launches = _recipe_phase(card)
    gc.collect()
    torch.cuda.empty_cache()
    # 16. remat and the process mesh: the 1024-sp yaml on one rank
    sp_launches = _sp_phase(card)
    gc.collect()
    torch.cuda.empty_cache()
    # 17. Megatron tensor parallelism: the 512-tp yaml as two tp ranks
    tp_launches = _tp_phase(card)
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
            "launches": (launches.get(name, 0)
                         + img2img_launches.get(name, 0)
                         + sampler_launches.get(name, 0)
                         + eval_launches[name]
                         + train_launches[name] + composed_launches[name]
                         + online_launches[name]
                         + checkpoint_launches[name]
                         + lora_launches[name] + reader_launches[name]
                         + pixel_launches[name] + recipe_launches[name]
                         + sp_launches[name] + tp_launches[name]
                         + flops_launches[name] + flops_yaml_launches[name]),
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
