"""HTTP serving over the port's StableDiffusionInference, with dynamic
batching.

`Batcher` and `make_server` are copies of `diffusion_tpu/inference/serve.py`
(that module imports the JAX endpoint at top level); ROADMAP.md lists
lifting them into a shared framework-free module. Beyond the copy, `Batcher`
has `close()`, which stops its worker thread, and the server's
`server_close()` calls it.

  python -m diffusion_torch.inference.serve --device cuda --port 8000

POST /predict  {"prompt": "...", "guidance_scale": 7.5, ...}
  -> {"images": ["<base64 png>", ...]}
  optional: "scheduler" (ddim|dpm++2m|euler), "guidance_rescale" in
  [0, 1], "image" (base64) + "strength" for img2img, plus "mask"
  (grayscale base64, white = regenerate) for inpainting
GET  /health   -> {"status": "ok"}
GET  /stats    -> batching counters
"""

from __future__ import annotations

import argparse
import collections
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

from diffusion_torch.inference.inference_model import StableDiffusionInference

__all__ = ["make_server", "Batcher", "main"]


class _Ticket:
    __slots__ = ("inputs", "key", "event", "result", "error")

    def __init__(self, inputs: Dict[str, Any], key: tuple):
        self.inputs = inputs
        self.key = key
        self.event = threading.Event()
        self.result: Optional[List[str]] = None
        self.error: Optional[BaseException] = None


class Batcher:
    """Merge concurrent requests into one generate call.

    One worker thread owns the device. It takes the oldest waiting request,
    then collects up to `max_batch_size - 1` more mergeable requests (same
    `batch_key`) that are queued or arrive within `batch_wait_ms`, and runs
    them as one `predict_many` call. Requests that do not merge keep their
    place for the next round (FIFO across batches)."""

    def __init__(self, endpoint: StableDiffusionInference,
                 max_batch_size: int = 8, batch_wait_ms: float = 20.0):
        self.endpoint = endpoint
        self.max_batch_size = max(1, int(max_batch_size))
        self.batch_wait_s = max(0.0, float(batch_wait_ms) / 1e3)
        self._queue: collections.deque[_Ticket] = collections.deque()
        self._cond = threading.Condition()
        self._closed = False
        self.stats = {"requests_total": 0, "errors_total": 0,
                      "dispatches_total": 0, "dispatch_seconds_total": 0.0}
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="serve-batcher")
        self._worker.start()

    def snapshot(self) -> Dict[str, Any]:
        """Counters: average requests per dispatch is the batching win,
        queue_depth the backpressure."""
        with self._cond:
            s = dict(self.stats)
            s["queue_depth"] = len(self._queue)
        d = max(s["dispatches_total"], 1)
        s["avg_batch_size"] = round(s["requests_total"] / d, 3)
        s["avg_dispatch_seconds"] = round(s["dispatch_seconds_total"] / d, 4)
        return s

    def submit(self, inputs: Dict[str, Any]) -> List[str]:
        """Enqueue, wait, return images (raises the handler's error)."""
        key = self.endpoint.batch_key(inputs)  # validates before queueing
        t = _Ticket(inputs, key)
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._queue.append(t)
            self._cond.notify_all()
        t.event.wait()
        if t.error is not None:
            raise t.error
        return t.result or []

    def close(self, timeout: float = 60.0) -> None:
        """Stop taking requests, let the worker finish its batch, join it."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._worker.join(timeout)

    def _take_batch(self) -> List[_Ticket]:
        with self._cond:
            while not self._queue and not self._closed:
                self._cond.wait()
            if not self._queue:
                return []
            head = self._queue.popleft()
        batch = [head]
        deadline = time.monotonic() + self.batch_wait_s
        while len(batch) < self.max_batch_size:
            with self._cond:
                taken = next((t for t in self._queue if t.key == head.key),
                             None)
                if taken is not None:
                    self._queue.remove(taken)
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or self._closed:
                        break
                    self._cond.wait(timeout=remaining)
                    continue
            batch.append(taken)
        return batch

    def _run(self) -> None:
        while True:
            batch = self._take_batch()
            if not batch:
                return                                   # closed and drained
            t0 = time.monotonic()
            failed = False
            try:
                results = self.endpoint.predict_many(
                    [t.inputs for t in batch])
                for t, r in zip(batch, results):
                    t.result = r
            except Exception as e:  # noqa: BLE001 — delivered to the callers
                failed = True
                for t in batch:
                    t.error = e
            finally:
                with self._cond:
                    self.stats["requests_total"] += len(batch)
                    self.stats["dispatches_total"] += 1
                    self.stats["dispatch_seconds_total"] += (
                        time.monotonic() - t0)
                    if failed:
                        self.stats["errors_total"] += len(batch)
                for t in batch:
                    t.event.set()


class _Server(ThreadingHTTPServer):
    batcher: Batcher

    def server_close(self) -> None:
        super().server_close()
        self.batcher.close()


def make_server(endpoint: StableDiffusionInference, host: str = "0.0.0.0",
                port: int = 8000, max_batch_size: int = 8,
                batch_wait_ms: float = 20.0) -> ThreadingHTTPServer:
    batcher = Batcher(endpoint, max_batch_size=max_batch_size,
                      batch_wait_ms=batch_wait_ms)

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._send(200, {"status": "ok"})
            elif self.path == "/stats":
                self._send(200, batcher.snapshot())
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                inputs = json.loads(self.rfile.read(length) or b"{}")
                images = batcher.submit(inputs)
                self._send(200, {"images": images})
            except ValueError as e:
                self._send(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — surface to the client
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):  # quieter default logging
            pass

    server = _Server((host, port), Handler)
    server.batcher = batcher
    return server


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", default=None,
                   help="a Trainer checkpoint directory (ba<N>) or a "
                        "weights-only one, local or s3://, gs://, file://")
    p.add_argument("--model-name", default=None,
                   help="a local diffusers directory; with --pretrained its "
                        "weights are loaded, so the frozen VAE and text "
                        "towers are real")
    p.add_argument("--pretrained", action="store_true",
                   help="load --model-name's weights (a --checkpoint "
                        "restores the UNet only, never the frozen towers)")
    p.add_argument("--allow-random-frozen", action="store_true",
                   help="serve a --checkpoint over RANDOM frozen towers "
                        "(smoke runs only: the images are noise)")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch-size", type=int, default=8)
    p.add_argument("--batch-wait-ms", type=float, default=20.0)
    args = p.parse_args()
    endpoint = StableDiffusionInference(
        checkpoint_path=args.checkpoint, model_name=args.model_name,
        pretrained=args.pretrained,
        allow_random_frozen=args.allow_random_frozen,
        default_size=args.size, device=args.device, seed=args.seed)
    server = make_server(endpoint, args.host, args.port,
                         max_batch_size=args.max_batch_size,
                         batch_wait_ms=args.batch_wait_ms)
    print(f"serving on {args.host}:{args.port}")
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
