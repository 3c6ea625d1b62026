"""The forward and backward of a training step, replayed from one CUDA graph.

`Trainer._train_step` runs its microbatches' forward and backward either
eagerly, each op dispatched from Python, or from a `torch.cuda.CUDAGraph`
captured once, whose replay launches all of the step's kernels in one host
call. The graph covers the forward and backward alone:

- the draws stay eager, on the host's side of the graph: each
  microbatch's `(noise, timesteps)` come from the `noise_hook`, else from
  the step's generator through `StableDiffusion.training_draws` (the
  order `forward` draws them in), and are copied into the graph's inputs
  with the microbatch's latents and caption latents. Nothing random runs
  inside the graph;
- the update stays eager: it reads the graph's gradient buffers, which
  the Trainer hands it as the parameters' `.grad`; the step's loss is a
  graph output, cloned for the step's metrics;
- the hand-written kernels are the ones the graph launches.

`StepGraph.reason` decides, from what the code can see, whether a replay
computes what the eager step would; it names the first thing that stops
it, else None:

- `device`: the model is not on a CUDA device;
- `sharded`: the trainer runs on a process mesh (FSDP's hooks, tp and sp
  keep their collectives eager);
- `dropout`: the UNet drops (the masks come from host-seeded generators);
- `raw_batch`: the batch is not precomputed latents (raw images go
  through the towers' encode);
- `warmup`: no eligible step has run yet. That step runs eagerly, so the
  kernel library, the kernels' plans, cuBLAS's and cuDNN's choices and
  GroupNorm's tickets are made outside the graph's memory pool;
- `shape`: the batch's keys, shapes or dtypes are not the captured ones;
- `storage`: a UNet parameter or buffer no longer lies where the graph
  reads it (an EMA swap-in, a checkpoint load, LoRA); an even number of
  EMA swaps returns to it.

The `warmup` step runs on the stream the graph will be captured on, so
that the state kept per stream (cuBLAS's workspace, GroupNorm's tickets) is
made there, outside the graph's memory pool. The next step with no reason
captures the eager step's own loop over the graph's inputs on that stream,
then replays it, which does the step's work; every later step with no
reason replays. The kernels' `LaunchCounter`s count the launches that ran:
a capture takes back those it recorded, a replay adds them (the captured
nodes), with no host time. `utils.profiler.step_graph` counts captures,
replays and eager steps by reason.
"""

from __future__ import annotations

import contextlib
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from diffusion_torch.ops._build import LaunchCounter
from diffusion_torch.utils.profiler import step_graph as counts

__all__ = ["StepGraph", "LATENTS"]

LATENTS = "image_latents"


def batch_signature(batch: Dict[str, torch.Tensor]) -> tuple:
    return tuple((k, tuple(v.shape), v.dtype, v.device)
                 for k, v in sorted(batch.items()))


def storage_signature(module: torch.nn.Module) -> tuple:
    return tuple(t.data_ptr() for t in itertools.chain(module.parameters(),
                                                       module.buffers()))


class StepGraph:
    """A Trainer's graph of its step's forward and backward (None until
    captured), its static inputs and outputs, and what it was captured
    for."""

    def __init__(self) -> None:
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.warm = False
        self.grads: List[torch.Tensor] = []
        self.loss: Optional[torch.Tensor] = None
        # the microbatches' latents and caption latents, and each one's
        # (noise, timesteps): the graph's inputs
        self.inputs: Dict[str, torch.Tensor] = {}
        self.draws: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self._stream = None
        self._batch = self._storage = None
        self._launches: Dict[LaunchCounter, int] = {}

    def reason(self, trainer, batch: Dict[str, torch.Tensor]
               ) -> Optional[str]:
        """Why `batch`'s step must run eagerly, or None where the graph
        computes it (module docstring)."""
        model = trainer.model
        unet = model.unet
        if trainer.device.type != "cuda":
            return "device"
        if trainer._sharded:
            return "sharded"
        if unet.drops:
            return "dropout"
        if not (getattr(model, "precomputed_latents", False)
                and LATENTS in batch):
            return "raw_batch"
        if not self.warm:
            return "warmup"
        if self.graph is not None:
            if batch_signature(batch) != self._batch:
                return "shape"
            if storage_signature(unet) != self._storage:
                return "storage"
        return None

    @contextlib.contextmanager
    def eager(self, reason: str, device: torch.device):
        """Count a step that runs eagerly for `reason`, and run it: the
        `warmup` step on the stream the graph will be captured on."""
        counts.eager[reason] += 1
        if reason != "warmup":
            yield
            return
        self.warm = True
        # kept: GroupNorm's tickets are cached by the stream's handle
        stream = self._stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            yield
        torch.cuda.current_stream(device).wait_stream(stream)

    def load(self, index: int, rows: slice, micro: Dict[str, torch.Tensor],
             noise: torch.Tensor, timesteps: torch.Tensor,
             batch: Dict[str, torch.Tensor]) -> None:
        """Copy microbatch `index` (the batch's `rows`) and its draws into
        the graph's inputs; before a capture, make the inputs like
        `batch` and the draws."""
        if self.graph is None:
            if index == 0:
                self.inputs = {k: torch.empty_like(v)
                               for k, v in batch.items()}
                self.draws = []
            device = self.inputs[LATENTS].device
            self.draws.append((
                torch.empty(noise.shape, device=device, dtype=torch.float32),
                torch.empty(timesteps.shape, device=device,
                            dtype=timesteps.dtype)))
        for k, v in micro.items():
            self.inputs[k][rows].copy_(v)
        static_noise, static_t = self.draws[index]
        static_noise.copy_(noise)
        static_t.copy_(timesteps)

    def capture(self, forward_backward: Callable[[], torch.Tensor],
                params: Sequence[torch.nn.Parameter],
                unet: torch.nn.Module) -> None:
        """Capture `forward_backward()`, the microbatches' forward and
        backward over `inputs` and `draws`, on the warm-up's stream; the
        gradients (each parameter's `.grad` at the capture's end) and the
        summed loss it returns become the graph's outputs. Replays
        nothing."""
        before = {c: c.value for c in LaunchCounter.counters()}
        graph = torch.cuda.CUDAGraph()
        # thread_local: the loader's threads may touch the device meanwhile
        with torch.cuda.graph(graph, stream=self._stream,
                              capture_error_mode="thread_local"):
            self.loss = forward_backward()
        self.grads = [p.grad for p in params]
        self._launches = {c: c.value - n for c, n in before.items()
                          if c.value != n}
        for c, n in self._launches.items():
            c.add(-n)       # recorded, not run: the replays count them
        self._batch = batch_signature(self.inputs)
        self._storage = storage_signature(unet)
        self.graph = graph
        counts.captures += 1

    def replay(self) -> None:
        self.graph.replay()
        for c, n in self._launches.items():
            c.add(n)
        counts.replays += 1
