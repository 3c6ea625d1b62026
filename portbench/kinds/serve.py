"""Serving cells: `POST /predict` to the program's HTTP server
(`inference/serve.py::make_server`) in this process, open-loop arrivals at
the traffic file's fixed rate.

Every seed sends the same set of inter-arrival gaps (the exponential's
quantiles at the rate) and the same set of prompt lengths, in an order the
seed draws, with words the seed draws: the work is the same, its order
differs. All requests carry one generation seed, so they merge. Each
request is timed from when it was due to when its PNG response was read;
those due in the window are the ones measured, and the run waits for them
up to `drain_s` past the window's close. With `--trace 1` a burst of
`trace_requests` requests, one merged dispatch, runs afterwards under
torch.profiler. The program is then freed and the reference generates a
sample of the served requests again from the same weights, prompts and
noise, in float32.
"""

from __future__ import annotations

import base64
import functools
import gc
import io
import json
import os
import threading
import time
from http.client import HTTPConnection
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from portbench.common import HERE, Check, Run
from portbench.reference import ddim
from portbench.reference.clip import CLIPTextModel
from portbench.reference.tokenizer import tiny_tokenizer
from portbench.reference.unet import UNet2DCondition, unet_spec
from portbench.reference.vae import AutoencoderKL, vae_spec
from portbench.trace import WINDOW, read_trace
from portbench.weights import derive_seed, draw_like

__all__ = ["run", "schedule", "endpoint", "reference_images", "compare"]

@functools.lru_cache(maxsize=1)
def _words() -> List[str]:
    """The vocabulary prompts are drawn from (`traffic/words.txt`)."""
    with open(os.path.join(HERE, "traffic", "words.txt")) as f:
        return f.read().split()


def schedule(seed: int, traffic: dict, seconds: float) -> List[dict]:
    """The requests due in a window: [{"due": s after the window opens,
    "prompt": ...}], the same gaps and prompt lengths for every seed."""
    n = max(1, int(round(traffic["rate_per_s"] * seconds)))
    rng = np.random.default_rng(derive_seed(seed, "arrivals"))
    q = (np.arange(n) + 0.5) / n
    gaps = rng.permutation(-np.log1p(-q) / traffic["rate_per_s"])
    lo, hi = traffic["prompt_words"]
    lengths = rng.permutation(np.round(np.linspace(lo, hi, n)).astype(int))
    words = _words()
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return [{"due": float(d), "prompt": " ".join(
        words[i] for i in rng.integers(0, len(words), int(k)))}
        for d, k in zip(due, lengths)]


def request_body(traffic: dict, prompt: str, gen_seed: int) -> dict:
    return {"prompt": prompt, "num_inference_steps": traffic["steps"],
            "guidance_scale": traffic["guidance_scale"],
            "height": traffic["size"], "width": traffic["size"],
            "seed": gen_seed}


def _reference_modules(config: dict):
    with torch.device("meta"):
        return {"unet": UNet2DCondition(unet_spec(config["unet"])),
                "vae": AutoencoderKL(vae_spec(config["vae"])),
                "text_encoder": CLIPTextModel(config["text_encoder"])}


def _weights(config: dict, seed: int, device) -> Dict[str, dict]:
    """{module: {name: tensor}} drawn from the seed (flat buffers kept
    alive by the views)."""
    return {name: draw_like(m, derive_seed(seed, name), device)[1]
            for name, m in _reference_modules(config).items()}


def endpoint(config: dict, seed: int, device):
    """The program's endpoint over the benchmark's weights: the model
    function runs on the meta device (it draws nothing), the modules are laid out
    on `device`, and the weights are copied in."""
    import importlib
    from diffusion_torch.inference.inference_model import \
        StableDiffusionInference
    module, fn = config["model"].rsplit(".", 1)
    make = getattr(importlib.import_module(module), fn)
    weights = _weights(config, seed, device)

    def build(**kwargs):
        model = make(**dict(kwargs, device="meta"))
        for name, state in weights.items():
            mod = getattr(model, name)
            mod.to_empty(device=device)
            mod.load_state_dict(state)
        return model

    return StableDiffusionInference(builder=build, device=device,
                                    default_size=512, seed=0)


def _post(port: int, body: dict, timeout: float) -> tuple:
    conn = HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/predict", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _stats(port: int) -> dict:
    conn = HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", "/stats")
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


class _Client:
    """Sends each request at its due time from a thread of its own and
    records when its response was read."""

    def __init__(self, port: int, traffic: dict, gen_seed: int,
                 timeout: float):
        self.port, self.traffic, self.gen_seed = port, traffic, gen_seed
        self.timeout = timeout
        self.threads: List[threading.Thread] = []
        self.results: List[Dict[str, Any]] = []

    def _one(self, rec: dict) -> None:
        try:
            status, body = _post(self.port, request_body(
                self.traffic, rec["prompt"], self.gen_seed), self.timeout)
            rec["status"], rec["body"] = status, body
        except OSError as e:
            rec["status"], rec["body"] = None, repr(e).encode()
        rec["done"] = time.perf_counter()

    def send(self, reqs: List[dict], t0: float) -> None:
        for r in reqs:
            rec = dict(r, at=t0 + r["due"])
            self.results.append(rec)
            delay = rec["at"] - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            th = threading.Thread(target=self._one, args=(rec,), daemon=True)
            th.start()
            self.threads.append(th)

    def wait(self, until: float) -> None:
        for th in self.threads:
            th.join(max(0.0, until - time.perf_counter()))


def _png(body: bytes, size: int) -> Optional[np.ndarray]:
    """The response's one image as uint8 (H, W, 3), or None where the
    response is not one PNG of the asked size."""
    from PIL import Image
    try:
        images = json.loads(body)["images"]
        if len(images) != 1:
            return None
        img = Image.open(io.BytesIO(base64.b64decode(images[0])))
        img.load()
    except (ValueError, KeyError, OSError):
        return None
    if img.size != (size, size) or img.mode != "RGB":
        return None
    return np.asarray(img)


class _Recorder:
    """Benchmark-side spans around the calls into the endpoint: each
    dispatch's prompts in order, and (with the trace) each UNet and VAE
    decode call's batch."""

    def __init__(self, ep):
        self.dispatches: List[List[str]] = []
        self.unet_batches: List[int] = []
        self.decode_batches: List[int] = []
        self.on = False
        many = ep.predict_many

        def predict_many(requests):
            self.dispatches.append([r["prompt"] for r in requests])
            return many(requests)

        ep.predict_many = predict_many
        unet, vae = ep.model.unet, ep.model.vae
        fwd, dec = unet.forward, vae.decode

        def unet_forward(x, *a, **k):
            if self.on:
                self.unet_batches.append(int(x.shape[0]))
            return fwd(x, *a, **k)

        def decode(z):
            if self.on:
                self.decode_batches.append(int(z.shape[0]))
            return dec(z)

        unet.forward, vae.decode = unet_forward, decode


def _warm(ep, traffic: dict, gen_seed: int) -> None:
    """One dispatch at each padded batch the cell's traffic can form, at
    the cell's size, with 2 steps: every shape of the window is seen."""
    n = 1
    while n <= traffic["max_batch_size"]:
        ep.predict_many([request_body(dict(traffic, steps=2), "warm up",
                                      gen_seed)] * n)
        n *= 2


def run(files: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, plant: Optional[Callable] = None) -> dict:
    from diffusion_torch.inference.serve import make_server
    config, traffic = files["config"], files["traffic"]
    gen_seed = derive_seed(seed, "generation") % 2 ** 31
    ep = endpoint(config, seed, device)
    rec = _Recorder(ep)
    if plant is not None:
        plant(ep)
    _warm(ep, traffic, gen_seed)
    rec.dispatches.clear()
    server = make_server(ep, "127.0.0.1", 0,
                         max_batch_size=traffic["max_batch_size"],
                         batch_wait_ms=traffic["batch_wait_ms"])
    port = server.server_address[1]
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    reqs = schedule(seed, traffic, seconds)
    client = _Client(port, traffic, gen_seed, seconds + traffic["drain_s"])
    try:
        before = _stats(port)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        client.send(reqs, t0)
        client.wait(t0 + seconds + traffic["drain_s"])
        after = _stats(port)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        tr = None
        if trace:
            tr = _traced_burst(port, traffic, gen_seed, rec, device)
    finally:
        server.shutdown()
        server.server_close()
        serving.join(timeout=60)
    size = traffic["size"]
    served, lat = [], []
    for r in client.results:
        img = (_png(r["body"], size) if r.get("status") == 200 else None)
        r["image"] = img
        lat.append(r["done"] - r["at"] if img is not None else float("inf"))
        if img is not None:
            served.append(r)
    failed = len(client.results) - len(served)
    delta = {k: after[k] - before[k] for k in
             ("requests_total", "dispatches_total", "dispatch_seconds_total",
              "errors_total")}
    where = {}
    for d, prompts in enumerate(rec.dispatches):
        for i, p in enumerate(prompts):
            where.setdefault(p, (len(prompts), i))
    del server, ep, rec.dispatches
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    sample = _sample(seed, served, traffic["check_requests"])
    rows = [(r["prompt"], *where[r["prompt"]]) for r in sample]
    want = reference_images(config, traffic, seed, gen_seed, rows, device)
    checks = compare([r["image"] for r in sample], want,
                     files["check"]["limits"])
    lat_a = np.asarray(lat)
    w = {"seconds": seconds, "requests": len(reqs), "stats": delta,
         "unet_batches": rec.unet_batches,
         "decode_batches": rec.decode_batches, "peak_bytes": peak}
    return {
        "end_to_end": {"setup_s": setup_s,
                       "serve_latency_p50_s": float(np.percentile(lat_a, 50)),
                       "serve_latency_p90_s": float(np.percentile(lat_a, 90))},
        "attempted": len(reqs), "failed": failed, "checks": checks,
        "peak_bytes": peak, "trace": tr,
        "run": Run(cell=files["cell"], config=config, traffic=traffic,
                   window=w, trace=tr, stats=delta)}


def _traced_burst(port, traffic, gen_seed, rec, device):
    """`trace_requests` requests at once (one merged dispatch) under the
    profiler, bracketed by synchronizations."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prompts = [f"traced request {i}" for i in range(traffic["trace_requests"])]
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            rec.on = True
            threads = [threading.Thread(target=_post, args=(
                port, request_body(traffic, p, gen_seed), 600))
                for p in prompts]
            for th in threads:
                th.start()
            for th in threads:
                th.join(600)
            rec.on = False
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    return read_trace(prof)


def _sample(seed: int, served: List[dict], k: int) -> List[dict]:
    """k served requests drawn from the seed, the longest prompt among
    them."""
    if not served:
        return []
    longest = max(range(len(served)), key=lambda i: len(served[i]["prompt"]))
    rng = np.random.default_rng(derive_seed(seed, "sample"))
    rest = [i for i in rng.permutation(len(served)) if i != longest]
    return [served[i] for i in [longest] + rest[:max(0, k - 1)]]


@torch.no_grad()
def reference_images(config: dict, traffic: dict, seed: int, gen_seed: int,
                     rows: List[tuple], device, control: bool = False
                     ) -> List[np.ndarray]:
    """The reference's images, float in [0, 1] (H, W, 3), for (prompt,
    padded batch, row) triples: CLIP text of the prompt and of the empty
    prompt, the CFG DDIM loop over the UNet from the noise the endpoint
    drew for that row, and the VAE decode."""
    if not rows:
        return []
    mods = _reference_modules(config)
    weights = _weights(config, seed, device)
    for name, m in mods.items():
        m.to_empty(device=device)
        m.load_state_dict(weights[name])
    del weights
    tok = tiny_tokenizer()
    size, steps = traffic["size"], traffic["steps"]
    side = size // 8
    noise = []
    for _, padded, row in rows:
        n = 1 << (padded - 1).bit_length()
        gen = torch.Generator(device=device).manual_seed(gen_seed)
        noise.append(torch.randn((n, side, side, 4), generator=gen,
                                 device=device)[row])
    x = torch.stack(noise).permute(0, 3, 1, 2)
    ids = torch.from_numpy(tok([p for p, _, _ in rows] + [""])["input_ids"]
                           ).to(device)
    mode = _control_mode(control)
    with mode:
        text = mods["text_encoder"](ids)
        cond, uncond = text[:-1], text[-1:].expand(len(rows), -1, -1)
        ctx = torch.cat([uncond, cond])
        g = traffic["guidance_scale"]
        sched = config["scheduler"]
        for t in ddim.timesteps(sched, steps):
            tt = torch.full((2 * len(rows),), int(t), device=device)
            eps_u, eps_c = mods["unet"](torch.cat([x, x]), tt, ctx).chunk(2)
            x = ddim.step(sched, eps_u + g * (eps_c - eps_u), int(t), steps,
                          x)
        img = mods["vae"].decode(x / config["vae"]["scaling_factor"])
    img = (img * 0.5 + 0.5).clamp(0.0, 1.0).permute(0, 2, 3, 1)
    return list(img.float().cpu().numpy())


def _control_mode(control: bool):
    import contextlib
    if not control:
        return contextlib.nullcontext()
    from portbench.reference.lowp import Fp8Products
    return Fp8Products()


def compare(served: List[np.ndarray], want: List[np.ndarray],
            limits: dict) -> List[Check]:
    """The worst sampled request's RMS pixel difference, in [0, 1] units,
    between the PNG served and the reference's image."""
    gaps = [float(np.sqrt(np.mean((s.astype(np.float64) / 255.0
                                   - w.astype(np.float64)) ** 2)))
            for s, w in zip(served, want)]
    worst = max(gaps) if gaps else float("nan")
    return [Check("image_rms", worst, limits["image_rms"])]
