"""The single-device Trainer: grad accumulation, AdamW, EMA, events, eval.

Counterpart of `diffusion_tpu/train/trainer.py` (`_init_device_state`,
`_make_train_step`, `fit`, `eval`), with the JAX constructor's names. One
training batch is one step:

- the batch splits into `grad_accum_steps` microbatches (Composer's ceil
  rule: a microbatch never exceeds `device_train_microbatch_size`); each
  microbatch's loss is backpropagated into the parameters' fp32 `.grad`,
  which sums them; grads and loss are then averaged over the microbatches;
- `grad/global_norm` is taken before clipping;
- with `skip_nonfinite_updates`, a step whose loss or grad norm is not
  finite changes nothing: parameters, optimizer moments and the LR
  schedule's count, and the EMA, stay as they were;
- the EMA update follows the optimizer update;
- a batch is precomputed latents or raw images (float32 NHWC `image` and
  int `captions`, encoded by the model's frozen VAE and CLIP towers, which
  get no gradient, optimizer state or checkpoint entry);
- the posterior's eps (raw batches), timesteps and noise come from a
  `torch.Generator` derived from `seed` and the step (all microbatches
  draw from it in turn), unless `noise_hook` hands them over:
  ``noise_hook(step, micro_index, n_accum, microbatch) -> (noise,
  timesteps[, latent_noise])``, which the tests use to give the port
  JAX's draws;
- the metrics are the JAX names: `loss/train/total`, `grad/global_norm`
  and, when skipping is on, `trainer/nonfinite_skipped`; `lr` is logged
  from the schedule at the trainer step, as JAX logs it.

Each batch is a `step` span of `utils/profiler.py`, keyed by the step
index, from BEFORE_DATALOADER to the end of its loop body (events, logging,
eval and checkpoints included). Inside it: `data` (the loader's next batch
on the device); per microbatch `forward` (its draws and `loss_fn`) and
`backward`; `update` (the gradients' average, the global norm, the
non-finite test, and the optimizer's step with the EMA: on the card one
kernel pass in a `fused_update` span inside it, on the CPU the plain
version with the EMA's own `ema` span).

On one CUDA device, with precomputed latents and a UNet that does not
drop, the microbatches' forward and backward are replayed
from one CUDA graph (`train/step_graph.py`) from the second such step on,
while the parameters keep the storage it was captured with: the `forward`
spans then hold the draws and their copy into the graph's inputs, a
`replay` span the replay, and there is no `backward` span (on the first,
a `capture` span holds the captured loop's `forward` and `backward`
spans). The step before the first replay runs eagerly on the graph's
stream. The draws and the update stay eager, as above.

Eval runs after batch `b` when `b % eval_interval == 0` and `b` is not the
last, and on `eval()`. Each evaluator's loader restarts at epoch 0 and is
cut at `eval_subset_num_batches`; under EVAL_START/EVAL_END (the EMA swaps
its weights in and out) and `torch.no_grad()`, each batch's per-example
MSE and the `MeanSquaredError/bin-lo-hi` timestep masks of the model's
`loss_bins` are summed as numerator/denominator pairs and logged as
`metrics/<label>/<name>`. Eval timesteps and noise come from a generator
derived from the model's `val_seed` and the batch index, unless
`eval_noise_hook(batch_index, batch) -> (noise, timesteps[,
latent_noise])` hands them over.

Generation metrics: where the model's `val_guidance_scales` give
guidance scales and its `val_metric_names` name FID, IS or CLIPScore, a
`metrics.generation_metrics.GenerationMetricsHook` in `metric_hooks`
generates one image batch per scale for every eval batch
(`eval_num_inference_steps` steps, at `image_size`) and adds
`metrics/<label>/<Metric>-scale-<g>` to `eval()`'s results. An evaluator
whose metric names name none of the hook's pays for no sampling pass.
`close()` drops the hooks, and with them the metric towers.

Checkpoints (`train/checkpoint.py`), as the JAX Trainer writes them:
with `save_folder`, every `save_interval` batches and at the end of `fit`,
with the EMA weights active (swapped out again after the save), the
timestamp, the algorithms', callbacks' and train loader's state in
`meta.json`; async by default (`async_checkpoint`), keeping
`save_num_checkpoints_to_keep`, mirrored to `save_remote`. A bucket
`save_folder` (s3://, gs://) is staged in a local directory keyed by run
and bucket, and mirrored there. `autoresume` restores the newest complete
checkpoint of `save_folder` (after pulling a newer one from `save_remote`),
else `load_path`; `load_weights_only` takes the parameters alone and
re-seeds the EMA from them. The restore is in place: the `Parameter`s the
optimizer holds stay the ones the model computes with. Restoring the step
restores the noise stream (it is derived from the seed and the step), and
the optimizer's count is restored beside it (a skipped non-finite step
leaves them apart). With `checkpoint_on_preemption`, a SIGTERM during
`fit` (handled where `fit` runs on the main thread) ends the step loop at
the batch's end with a checkpoint of that batch.

Runs on `device` (CUDA unless the caller asks for the CPU; it raises where
CUDA is missing), which must be the model's. `image_size` and `precision`
are recorded. `log_traces` appends a `utils.profiler.TorchProfiler` (a
torch.profiler trace of batches 10-12 into `traces/`), as the JAX Trainer
appends its profiler.

Several processes (one a card, `torchrun`; `parallel/dist.py`): `mesh` (a
`parallel.mesh.create_mesh` DeviceMesh) or `mesh_config` ({dcn, fsdp, data,
sp, tp}, one -1 inferred), else JAX's default: fsdp over every rank where
the model's `fsdp` and `fsdp_config` shard, data otherwise. A mesh of one
rank (or no process group, with a mesh_config whose axes are all 1)
trains as above. On more:

- with `tp` > 1, each rank first keeps its tp slices of the UNet's
  attention and GEGLU layers (`parallel/sharding.py::
  shard_tensor_parallel`, JAX's Megatron table and head gate: SD2's
  5-head stage stays whole at tp = 2), and the step and eval run under
  `ops.attention.tensor_parallel`. A tp rank holds whole examples: the
  microbatch count divides the mesh's size by tp, as JAX's does;
- the UNet is FSDP2-sharded over `fsdp` and replicated over the other axes
  but tp, on each tp rank's parameters (`parallel/sharding.py::
  shard_unet`; `fsdp_config.sharding_strategy` `SHARD_GRAD_OP`, the
  yamls', keeps parameters gathered from forward to backward,
  `FULL_SHARD` reshards after the forward). Where the mesh has no rank
  to shard over but tp's, nothing is wrapped: the tp ranks' whole
  parameters get equal gradients through `tp_copy`. The AdamW, its global
  gradient norm (summed over the fsdp group, and the tp slices' over the
  tp group) and the EMA work on each rank's shards; the frozen towers
  stay whole on every rank;
- each rank's loader yields its part of the global batch (the readers
  split examples over dcn x fsdp x data: `utils/device.py::rank_and_world`),
  and microbatch i of a step is the batch ranks' microbatches i in rank
  order. The step's draws are made for the whole global microbatch from
  the step's generator and each rank takes its examples' (`forward(
  examples=)`), so a step equals the one-rank step of the global batch; a
  `noise_hook` returns the global microbatch's draws, which each rank
  slices;
- with `sp` > 1 the step and eval run under `ops.attention.
  sequence_parallel` (`sequence_parallel_min_seq`: the ring's threshold):
  the sp ranks split the UNet body's rows, and each backpropagates the
  mean loss over its rows (FSDP's average over all ranks then gives the
  examples' mean gradient). Logged losses are averaged over the ranks,
  eval sums over them (each example counted once over an sp or tp
  group); loggers run on rank 0;
- checkpoints gather the full state (the FSDP shards, then the tp
  slices, the GEGLU's value and gate rows put back in place), which rank
  0 writes in the one-rank format (so either side resumes the other's),
  and every rank reads and re-slices on load; a SIGTERM is acted on when
  the ranks agree (an all-reduce of the flag every
  `preempt_sync_interval` batches, JAX's rule), so every rank saves the
  same batch.

The model is a `StableDiffusion` (with `train_lora_only`, only its UNet's
adapters require grad, so they alone are trained, EMA'd and checkpointed)
or a `PixelDiffusion`; the trainer takes the UNet parameters that require
grad.
"""

from __future__ import annotations

import copy
import hashlib
import logging
import os
import signal
import tempfile
import time as _time
from typing import (Any, Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch

from diffusion_torch.algorithms.ema import EMA, ema_smoothing_for_step
from diffusion_torch.metrics.base import all_hosts_sum
from diffusion_torch.metrics.generation_metrics import (
    GENERATION_METRICS, GenerationMetricsHook)
from diffusion_torch.ops.attention import (sequence_parallel,
                                           tensor_parallel)
from diffusion_torch.parallel import dist
from diffusion_torch.parallel.mesh import (MESH_AXES, create_mesh,
                                           example_layout, mesh_sizes)
from diffusion_torch.parallel.sharding import (batch_slice, fsdp_mesh,
                                               model_tp_head_dim,
                                               process_group, row_shard,
                                               shard_tensor_parallel,
                                               shard_unet, tp_join,
                                               tp_slice)
from diffusion_torch.train import checkpoint as ckpt
from diffusion_torch.train.events import Algorithm, Callback, Event, EventEngine
from diffusion_torch.train.optim import (build_optimizer, constant_scheduler,
                                         global_norm)
from diffusion_torch.train.state import State, TrainState
from diffusion_torch.train.step_graph import LATENTS, StepGraph
from diffusion_torch.utils.device import Device, resolve_device
from diffusion_torch.utils.logging import (ConsoleLogger, Logger,
                                           LoggerCollection)
from diffusion_torch.utils.profiler import TorchProfiler, span
from diffusion_torch.utils.time import Time, Timestamp, time_to_batches

__all__ = ["Trainer", "Evaluator", "grad_accum_steps"]

NoiseHook = Callable[[int, int, int, Dict[str, torch.Tensor]],
                     Tuple[torch.Tensor, ...]]
EvalNoiseHook = Callable[[int, Dict[str, torch.Tensor]],
                         Tuple[torch.Tensor, ...]]


class Evaluator:
    """(label, dataloader, metric names) bundle (reference train.py:48-59
    builds composer Evaluators from the `evaluators` config dict)."""

    def __init__(self, label: str, dataloader: Iterable,
                 metric_names: Sequence[str] = ()):
        self.label = label
        self.dataloader = dataloader
        self.metric_names = tuple(metric_names)


def grad_accum_steps(global_batch: int, micro: int) -> int:
    """Microbatches per step: ceil(global / micro), rounded up to the next
    divisor of the global batch so every microbatch has one shape."""
    n = max(-(-global_batch // micro), 1)
    while global_batch % n:
        n += 1
    return n


class Trainer:
    def __init__(
        self,
        model: Any,
        train_dataloader: Optional[Iterable] = None,
        eval_dataloader: Union[None, Iterable, Sequence[Evaluator]] = None,
        optimizers: Optional[dict] = None,
        schedulers: Optional[Callable[[int], float]] = None,
        loggers: Union[None, Logger, Sequence[Logger]] = None,
        algorithms: Optional[Sequence[Algorithm]] = None,
        callbacks: Optional[Sequence[Callback]] = None,
        *,
        max_duration: Union[str, int] = "1ba",
        eval_interval: Union[str, int] = "10000ba",
        device_train_microbatch_size: Optional[int] = None,
        run_name: str = "run",
        seed: int = 17,
        scale_schedule_ratio: float = 1.0,
        save_folder: Optional[str] = None,
        save_remote: Optional[str] = None,
        save_interval: Union[str, int] = "10000ba",
        save_overwrite: bool = True,
        save_num_checkpoints_to_keep: int = -1,
        async_checkpoint: bool = True,
        checkpoint_on_preemption: bool = True,
        skip_nonfinite_updates: bool = False,
        autoresume: bool = False,
        load_path: Optional[str] = None,
        load_weights_only: bool = False,
        eval_subset_num_batches: int = -1,
        eval_num_inference_steps: int = 50,
        mesh: Any = None,
        mesh_config: Optional[dict] = None,
        fsdp_config: Optional[dict] = None,
        sequence_parallel_min_seq: int = 512,
        preempt_sync_interval: int = 25,
        image_size: int = 256,
        grad_clip_norm: Optional[float] = None,
        batches_per_epoch: Optional[int] = None,
        device: Device = None,
        precision: str = "amp_bf16",
        progress_bar: bool = False,
        log_to_console: bool = False,
        log_traces: bool = False,
        noise_hook: Optional[NoiseHook] = None,
        eval_noise_hook: Optional[EvalNoiseHook] = None,
    ):
        del progress_bar  # yaml parity; the trainer prints no bar
        self.fsdp_config = fsdp_config
        self._setup_mesh(model, mesh, mesh_config)
        self.sequence_parallel_min_seq = int(sequence_parallel_min_seq)
        self.preempt_sync_interval = max(1, int(preempt_sync_interval))
        device = resolve_device(device)
        if model.device.type != device.type or (
                device.index is not None and model.device != device):
            raise ValueError(f"the model lies on {model.device}, the trainer "
                             f"runs on {device}")
        self.device = model.device
        self.model = model
        self.train_dataloader = train_dataloader
        self.run_name = run_name
        self.seed = int(seed)
        self.max_duration = Time.from_str(max_duration)
        self.scale_schedule_ratio = float(scale_schedule_ratio)
        self.max_batches = int(self.scale_schedule_ratio * time_to_batches(
            self.max_duration, self.max_duration, batches_per_epoch or 0))
        self.eval_interval = time_to_batches(eval_interval, self.max_duration,
                                             batches_per_epoch or 0)
        self.eval_subset_num_batches = eval_subset_num_batches
        if save_folder and save_folder.startswith(("s3://", "gs://")):
            # the yamls' save_folder may be a bucket: stage locally under a
            # (run, bucket) key, so a stale staging directory of another
            # bucket is never resumed, and mirror to the bucket
            if save_remote is None:
                save_remote = save_folder
            key = hashlib.sha1(save_folder.encode()).hexdigest()[:8]
            save_folder = os.path.join(tempfile.gettempdir(),
                                       "diffusion_torch_ckpt",
                                       f"{run_name}-{key}")
        self.save_folder = save_folder
        self.save_remote = save_remote
        self.save_interval = time_to_batches(save_interval, self.max_duration,
                                             batches_per_epoch or 0)
        self.save_overwrite = save_overwrite
        self.save_num_checkpoints_to_keep = int(save_num_checkpoints_to_keep)
        self.async_checkpoint = async_checkpoint
        self.checkpoint_on_preemption = checkpoint_on_preemption
        self._preempt_requested = False
        self._last_saved_batch = -1
        self.image_size = image_size
        self.precision = precision
        self.skip_nonfinite_updates = skip_nonfinite_updates
        self.noise_hook = noise_hook
        self.eval_noise_hook = eval_noise_hook
        self._step_graph = StepGraph()

        if loggers is None:
            loggers = [ConsoleLogger(log_interval=100)] if log_to_console else []
        elif isinstance(loggers, Logger):
            loggers = [loggers]
        if dist.get_global_rank() != 0:
            loggers = []
        self.logger = LoggerCollection(loggers)
        callbacks = list(callbacks or [])
        if log_traces:
            callbacks.append(TorchProfiler())
        self.engine = EventEngine(algorithms or [], callbacks)
        self.ema_algorithm: Optional[EMA] = next(
            (a for a in self.engine.algorithms if isinstance(a, EMA)), None)

        if eval_dataloader is None:
            self.evaluators: List[Evaluator] = []
        elif isinstance(eval_dataloader, (list, tuple)) and eval_dataloader \
                and isinstance(eval_dataloader[0], Evaluator):
            self.evaluators = list(eval_dataloader)
        else:
            self.evaluators = [Evaluator(
                "eval", eval_dataloader,
                getattr(model, "val_metric_names", ("MeanSquaredError",)))]

        self._init_device_state(optimizers, schedulers, grad_clip_norm,
                                device_train_microbatch_size)

        scales = tuple(getattr(model, "val_guidance_scales", ()))
        self.metric_hooks: List[Any] = []
        gen_names = [n for n in getattr(model, "val_metric_names", ())
                     if n in GENERATION_METRICS]
        if scales and gen_names and self.evaluators:
            self.metric_hooks.append(GenerationMetricsHook(
                model, scales, gen_names,
                height=image_size, width=image_size,
                num_inference_steps=eval_num_inference_steps,
                inception_weights=getattr(model, "inception_weights", None),
                clip_weights=getattr(model, "clip_metric_weights", None),
                allow_random_weights=getattr(
                    model, "allow_random_tower_weights", False)))
        self.state = State(
            model=model, train_state=self.train_state, timestamp=Timestamp(),
            run_name=run_name, seed=self.seed,
            max_duration=str(self.max_duration),
            max_batches=self.max_batches,
            device_train_microbatch_size=device_train_microbatch_size,
            ema_start_batch=(self.ema_algorithm.start_batch(
                self.max_duration, batches_per_epoch or 0)
                if self.ema_algorithm else 0),
            rank=dist.get_global_rank())
        self._maybe_restore(autoresume, load_path, load_weights_only)
        self.engine.run(Event.INIT, self.state, self.logger)

    # ------------------------------------------------------------------
    def _setup_mesh(self, model, mesh, mesh_config) -> None:
        """The process mesh, JAX's default where none is given; `_sharded`
        where it has more than one rank."""
        use_fsdp = getattr(model, "fsdp", True) and (
            self.fsdp_config is None or self.fsdp_config.get(
                "sharding_strategy", "SHARD_GRAD_OP") != "NO_SHARD")
        world = dist.get_world_size()
        if mesh is None and (mesh_config or world > 1):
            cfg = dict(mesh_config or {"fsdp": world if use_fsdp else 1,
                                       "data": 1 if use_fsdp else world})
            if dist.launched() or torch.distributed.is_initialized():
                dist.initialize()
                mesh = create_mesh(**cfg)
            else:
                mesh_sizes(1, **cfg)     # the axes must cover one process
        self.mesh = mesh
        self._sharded = mesh is not None and mesh.size() > 1
        self._axes = dict(zip(MESH_AXES, mesh.mesh.shape)) if self._sharded \
            else dict.fromkeys(MESH_AXES, 1)
        self._batch_rank, self._batch_world = (
            example_layout(mesh) if self._sharded else (0, 1))
        # FSDP runs over the ranks of this rank's tp coordinate
        self._fsdp = self._sharded and mesh.size() > self._axes["tp"]

    def _init_device_state(self, optimizers, schedulers, grad_clip_norm,
                           micro_size) -> None:
        schedule = schedulers or constant_scheduler()
        self._schedule = schedule
        self._base_lr = (optimizers or {}).get("lr", 1e-4)
        self.micro_size = micro_size
        params = {n: p for n, p in self.model.unet.named_parameters()
                  if p.requires_grad}
        if not params:
            raise ValueError("the model's UNet has no trainable parameters")
        self._fsdp_group, self._fsdp_index = None, 0
        self._tp_shard, self._tp_dims = row_shard(self.mesh, "tp"), {}
        if self._tp_shard is not None:
            self._tp_dims = shard_tensor_parallel(
                self.model.unet, self._tp_shard.index, self._tp_shard.size,
                model_tp_head_dim(self.model))
        if self._sharded:
            self._dparams = [p for p in self.model.unet.parameters()
                             if p.requires_grad]
        if self._fsdp:
            strategy = (self.fsdp_config or {}).get("sharding_strategy",
                                                    "SHARD_GRAD_OP")
            fmesh = fsdp_mesh(self.mesh)
            shard_unet(self.model.unet, fmesh,
                       reshard_after_forward=strategy == "FULL_SHARD")
            self._fsdp_group = fmesh.get_group("shard")
            self._fsdp_index = fmesh.get_local_rank("shard")
            self._dparams = [p for p in self.model.unet.parameters()
                             if p.requires_grad]
            # the shards: views of the sharded parameters' local storage
            params = {n: p.to_local() for n, p in
                      self.model.unet.named_parameters() if p.requires_grad}
        optimizer = build_optimizer(params.values(), optimizers, schedule,
                                    grad_clip_norm)
        ema = ({n: p.detach().clone() for n, p in params.items()}
               if self.ema_algorithm is not None else None)
        self.train_state = TrainState(step=0, params=params,
                                      optimizer=optimizer, ema_params=ema,
                                      shards=self._sharded)

    def _generator(self, seed: int, index: int) -> torch.Generator:
        """A generator for (seed, index), e.g. the run seed and the step,
        or `val_seed` and the eval batch."""
        mixed = np.random.SeedSequence([seed, index]).generate_state(
            1, np.uint64)[0]
        return torch.Generator(device=self.device).manual_seed(
            int(mixed) & (2 ** 63 - 1))

    def _sequence_parallel(self):
        return sequence_parallel(self.mesh if self._sharded else None,
                                 min_seq=self.sequence_parallel_min_seq)

    def _tensor_parallel(self):
        return tensor_parallel(self.mesh if self._sharded else None)

    def _train_step(self, batch: Dict[str, torch.Tensor],
                    local_batch: int) -> Dict[str, torch.Tensor]:
        """One optimizer step over `batch` (this rank's part of the global
        batch); returns the step's metrics."""
        ts = self.train_state
        params = self._dparams if self._sharded else list(ts.params.values())
        global_batch = local_batch * self._batch_world
        # a tp rank holds whole rows (JAX divides tp out too)
        n_dev = self.mesh.size() // self._axes["tp"] if self._sharded else 1
        n_accum = (grad_accum_steps(global_batch, self.micro_size * n_dev)
                   if self.micro_size else 1)
        if local_batch % n_accum:
            raise ValueError(f"a global batch of {global_batch} in "
                             f"{n_accum} microbatches does not split over "
                             f"{self._batch_world} batch ranks")
        micro = local_batch // n_accum
        rows = batch_slice(global_batch // n_accum, self._batch_rank,
                           self._batch_world)
        gen = self._generator(self.seed, ts.step)
        for p in params:
            p.grad = None
        self.model.unet.train()
        why = self._step_graph.reason(self, batch)
        if why is None:
            loss = self._graph_step(batch, gen, n_accum, micro, rows,
                                    global_batch, params)
        else:
            with self._step_graph.eager(why, self.device):
                loss = self._eager_step(batch, gen, n_accum, micro, rows,
                                        global_batch)
        with span("update"):
            grads = [p.grad.to_local() if self._fsdp else p.grad
                     for p in params]
            if self._sharded:
                torch.distributed.all_reduce(loss)
                loss /= self.mesh.size()
            if n_accum > 1:
                torch._foreach_div_(grads, float(n_accum))
                loss /= n_accum
            if self._tp_shard is None:
                gnorm = global_norm(grads, self._fsdp_group)
            else:
                gnorm = global_norm(grads, self._fsdp_group,
                                    [n in self._tp_dims for n in ts.params],
                                    process_group(self._tp_shard.group))
            metrics = {"loss/train/total": loss, "grad/global_norm": gnorm}
            ok = True
            if self.skip_nonfinite_updates:
                ok = bool(torch.isfinite(loss) & torch.isfinite(gnorm))
                metrics["trainer/nonfinite_skipped"] = torch.tensor(
                    0.0 if ok else 1.0)
            if ok:
                # the EMA follows the update in the optimizer's step (a
                # skipped step leaves both the weights and the EMA)
                ema, eff = None, 1.0
                if ts.ema_params is not None:
                    ema = [ts.ema_params[n] for n in ts.params]
                    eff = ema_smoothing_for_step(
                        ts.step, self.ema_algorithm.smoothing(),
                        self.state.ema_start_batch,
                        int(self.ema_algorithm.update_interval.value))
                ts.optimizer.step(grad_norm=gnorm, grads=grads, ema=ema,
                                  smoothing=eff)
            for p in params:
                p.grad = None
        ts.step += 1
        return metrics

    def _eager_step(self, batch: Dict[str, torch.Tensor],
                    gen: Optional[torch.Generator], n_accum: int,
                    micro: int, rows: slice, global_batch: int,
                    draws: Optional[List[Tuple[torch.Tensor,
                                               torch.Tensor]]] = None
                    ) -> torch.Tensor:
        """The microbatches' forward and backward, op by op: each
        microbatch's loss backpropagated into the parameters' `.grad`.
        Microbatch `i`'s `(noise, timesteps)` are `draws[i]` where given,
        else the `noise_hook`'s, else `loss_fn`'s from `gen`. Returns the
        summed loss."""
        step = self.train_state.step
        loss = torch.zeros((), device=self.device)
        with self._sequence_parallel(), self._tensor_parallel():
            for i in range(n_accum):
                with span("forward", micro=i):
                    mb = {k: v[i * micro:(i + 1) * micro]
                          for k, v in batch.items()}
                    given = ()
                    if draws is not None:
                        given = draws[i]
                    elif self.noise_hook is not None:
                        given = tuple(d[rows] for d in self.noise_hook(
                            step, i, n_accum, mb))
                    kwargs = {"dropout_key": (self.seed, step, i,
                                              self._batch_rank)}
                    if self._sharded:
                        kwargs["examples"] = (rows.start,
                                              global_batch // n_accum)
                    micro_loss = self.model.loss_fn(mb, gen, *given,
                                                    **kwargs)
                with span("backward", micro=i):
                    micro_loss.backward()
                loss += micro_loss.detach()
        return loss

    def _graph_step(self, batch: Dict[str, torch.Tensor],
                    gen: torch.Generator, n_accum: int, micro: int,
                    rows: slice, global_batch: int,
                    params: List[torch.nn.Parameter]) -> torch.Tensor:
        """The forward and backward of an unsharded step from the step's
        CUDA graph (`train/step_graph.py`): each microbatch's draws, made
        as the eager step makes them, and its rows go into the graph's
        inputs; on the first call `_eager_step`'s loop over those inputs
        is captured. The graph's gradients become the parameters' `.grad`.
        Returns the summed loss, a fresh tensor."""
        graph, step = self._step_graph, self.train_state.step
        for i in range(n_accum):
            with span("forward", micro=i):
                mb_rows = slice(i * micro, (i + 1) * micro)
                mb = {k: v[mb_rows] for k, v in batch.items()}
                if self.noise_hook is not None:
                    noise, timesteps = self.noise_hook(step, i, n_accum,
                                                       mb)[:2]
                else:
                    timesteps, noise = self.model.training_draws(
                        mb[LATENTS].shape, gen)
                graph.load(i, mb_rows, mb, noise, timesteps, batch)
        if graph.graph is None:
            with span("capture"):
                graph.capture(lambda: self._eager_step(
                    graph.inputs, None, n_accum, micro, rows, global_batch,
                    graph.draws), params, self.model.unet)
        with span("replay"):
            graph.replay()
        for p, grad in zip(params, graph.grads):
            p.grad = grad
        return graph.loss.clone()

    def _to_device(self, host_batch: Mapping[str, Any]
                   ) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in host_batch.items()}

    def _device_batches(self) -> Iterable[Tuple[Dict[str, torch.Tensor], int]]:
        for host_batch in self.train_dataloader:
            batch = self._to_device(host_batch)
            yield batch, int(next(iter(batch.values())).shape[0])

    # ------------------------------------------------------------------
    def _stop_for_preemption(self, batch: int) -> bool:
        """Whether to checkpoint and stop for a SIGTERM: at once on one
        process; on several, only where an all-reduce of the flag (every
        `preempt_sync_interval` batches) finds it set on some rank, so that
        every rank leaves at the same batch (JAX's rule)."""
        if dist.get_world_size() == 1:
            return self._preempt_requested
        if not (self.checkpoint_on_preemption and self.save_folder) \
                or batch % self.preempt_sync_interval:
            return False
        flag = torch.tensor([float(self._preempt_requested)],
                            device=dist.device())
        torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MAX)
        return bool(flag.item())

    def fit(self) -> None:
        if self.train_dataloader is None:
            raise ValueError("fit() requires a train_dataloader")
        # set only by the SIGTERM handler, which is installed only where a
        # checkpoint can be written
        self._preempt_requested = False
        prev_sigterm = None
        if self.checkpoint_on_preemption and self.save_folder:
            try:
                prev_sigterm = signal.signal(
                    signal.SIGTERM,
                    lambda s, f: setattr(self, "_preempt_requested", True))
            except ValueError:
                pass  # not the main thread (embedded or test harnesses)
        try:
            self._fit()
        finally:
            if prev_sigterm is not None:
                signal.signal(signal.SIGTERM, prev_sigterm)

    def _fit(self) -> None:
        state, logger = self.state, self.logger
        self.engine.run(Event.FIT_START, state, logger)
        fit_start = _time.monotonic()
        last_batch_end = fit_start
        first_timed_batch = True

        while state.timestamp.batch < self.max_batches:
            self.engine.run(Event.EPOCH_START, state, logger)
            epoch_had_batches = False
            batches = self._device_batches()
            while state.timestamp.batch < self.max_batches:
                with span("step", step=self.train_state.step):
                    self.engine.run(Event.BEFORE_DATALOADER, state, logger)
                    try:
                        with span("data"):
                            batch, samples = next(batches)
                    except StopIteration:
                        break
                    epoch_had_batches = True
                    state.batch = batch
                    self.engine.run(Event.AFTER_DATALOADER, state, logger)
                    self.engine.run(Event.BATCH_START, state, logger)

                    step_idx = state.timestamp.batch
                    self.engine.run(Event.BEFORE_TRAIN_BATCH, state, logger)
                    metrics = self._train_step(batch, samples)
                    state.train_state = self.train_state
                    state.loss = metrics["loss/train/total"]
                    state.metrics = metrics
                    state.outputs = None
                    self.engine.run(Event.AFTER_TRAIN_BATCH, state, logger)

                    state.timestamp.to_next_batch(
                        samples=samples * self._batch_world)
                    now = _time.monotonic()
                    # the first delta absorbs the warm-up: report 0
                    state.batch_wct = 0.0 if first_timed_batch else (
                        now - last_batch_end)
                    first_timed_batch = False
                    last_batch_end = now
                    state.total_wct = now - fit_start
                    state.lr = float(self._base_lr) * float(
                        self._schedule(step_idx))
                    self.engine.run(Event.BATCH_END, state, logger)

                    b = state.timestamp.batch
                    if b % 100 == 0 or b <= 1:
                        logger.log_metrics(
                            {k: float(v) for k, v in metrics.items()}
                            | {"lr": state.lr, "time/batch": b}, step=b)
                    if self.eval_interval and b % self.eval_interval == 0 \
                            and b < self.max_batches and self.evaluators:
                        self.eval()
                    if self.save_folder and self.save_interval \
                            and b % self.save_interval == 0:
                        self.save_checkpoint()
                    self.engine.run(Event.BATCH_CHECKPOINT, state, logger)
                    if self._stop_for_preemption(b):
                        break
            if not epoch_had_batches:
                raise RuntimeError("train_dataloader yielded no batches")
            if self._stop_for_preemption(state.timestamp.batch):
                logging.getLogger(__name__).warning(
                    "SIGTERM received: checkpointing at ba%d and stopping "
                    "(autoresume continues from there)",
                    state.timestamp.batch)
                break
            state.timestamp.to_next_epoch()
            self.engine.run(Event.EPOCH_END, state, logger)
            self.engine.run(Event.EPOCH_CHECKPOINT, state, logger)

        if self.save_folder and \
                self._last_saved_batch != state.timestamp.batch:
            self.save_checkpoint()
        if self.save_folder:
            self._finish_checkpoints()
        self.engine.run(Event.FIT_END, state, logger)
        logger.flush()

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _eval_step(self, batch: Dict[str, torch.Tensor], index: int
                   ) -> Dict[str, Tuple[float, float]]:
        """(numerator, denominator) of the MSE and of each loss bin's MSE
        over one batch: per-example means of the squared error."""
        model = self.model
        # a continuous-time model has neither bins nor a timestep count
        num_t = getattr(model.noise_scheduler, "num_train_timesteps", 1000)
        draws, gen, kwargs = (), None, {}
        if self.eval_noise_hook is not None:
            draws = self.eval_noise_hook(index, batch)
        else:
            gen = self._generator(model.val_seed, index)
        if self._sharded:
            n = int(next(iter(batch.values())).shape[0])
            kwargs["examples"] = (self._batch_rank * n,
                                  n * self._batch_world)
        with self._sequence_parallel(), self._tensor_parallel():
            out = model.eval_forward(batch, gen, *draws, **kwargs)
        pred, target, t = out["pred"], out["target"], out["timesteps"]
        err = torch.square(pred.float() - target.float())
        per_example = err.mean(dim=tuple(range(1, err.ndim)))
        # an sp rank holds 1 / sp of each example's rows: its part of the
        # example's mean and of the example itself; the tp ranks hold the
        # same examples
        share = self._axes["sp"] * self._axes["tp"]
        out = {"MeanSquaredError": (float(per_example.sum()) / share,
                                    float(per_example.numel()) / share)}
        for lo, hi in getattr(model, "loss_bins", ()) or ():
            mask = ((t >= lo * num_t) & (t < hi * num_t)).float()
            out[f"MeanSquaredError/bin-{lo}-{hi}"] = (
                float((per_example * mask).sum()) / share,
                float(mask.sum()) / share)
        return out

    def eval(self, subset_num_batches: Optional[int] = None
             ) -> Dict[str, float]:
        state, logger = self.state, self.logger
        limit = subset_num_batches if subset_num_batches is not None \
            else self.eval_subset_num_batches
        self.engine.run(Event.EVAL_START, state, logger)
        results: Dict[str, float] = {}
        self.model.unet.eval()
        for evaluator in self.evaluators:
            accum: Dict[str, Tuple[float, float]] = {}
            state.eval_label = evaluator.label
            # an evaluator that names no generation metric pays for no
            # sampling pass (empty metric names: everything)
            hooks = [h for h in self.metric_hooks
                     if not evaluator.metric_names
                     or any(n in evaluator.metric_names
                            for n in h.metric_names)]
            # every eval scores the same slice of the eval set: a prior
            # subset-limited pass left the loader mid-epoch
            dl = evaluator.dataloader
            if hasattr(dl, "load_state_dict"):
                dl.load_state_dict({"epoch": 0, "batch_in_epoch": 0})
            for i, host_batch in enumerate(dl):
                if limit and limit > 0 and i >= limit:
                    break
                state.eval_batch_idx = i
                batch = self._to_device(host_batch)
                state.batch = batch
                self.engine.run(Event.EVAL_BATCH_START, state, logger)
                for name, (num, den) in self._eval_step(batch, i).items():
                    a, b = accum.get(name, (0.0, 0.0))
                    accum[name] = (a + num, b + den)
                for hook in hooks:
                    with self._tensor_parallel():
                        hook.eval_batch(self, evaluator, state, batch, i)
                self.engine.run(Event.EVAL_BATCH_END, state, logger)
            if self._sharded:
                names = sorted(accum)
                sums = all_hosts_sum(np.asarray([accum[k] for k in names],
                                                np.float64))
                accum = {k: (float(a), float(b))
                         for k, (a, b) in zip(names, sums)}
            for name, (num, den) in accum.items():
                if den > 0:
                    results[f"metrics/{evaluator.label}/{name}"] = num / den
            for hook in hooks:
                results.update(hook.eval_end(self, evaluator, state))
        logger.log_metrics(results, step=state.timestamp.batch)
        self.engine.run(Event.EVAL_END, state, logger)
        return results

    # ------------------------------------------------------------------
    def save_checkpoint(self) -> Optional[str]:
        """Write a checkpoint of this batch with the EMA weights active (the
        reference's ema.py). With `async_checkpoint` it returns once the
        tensors are on the host; the EMA swap-back that follows exchanges
        storages only, and the next step may change them in place."""
        if not self.save_folder:
            return None
        state = self.state
        if self.ema_algorithm:
            self.ema_algorithm.swap_in(state)
        meta = {
            "timestamp": state.timestamp.state_dict(),
            "run_name": self.run_name,
            "seed": self.seed,
            "algorithms": {type(a).__name__: a.state_dict()
                           for a in self.engine.algorithms},
            "callbacks": {type(c).__name__: c.state_dict()
                          for c in self.engine.callbacks},
        }
        if hasattr(self.train_dataloader, "state_dict"):
            meta["dataloader"] = self.train_dataloader.state_dict()
        path = None
        try:
            # on a mesh every rank gathers the full state; rank 0 writes it
            ts = self._full_state() if self._sharded else self.train_state
            if dist.is_coordinator():
                path = ckpt.save_checkpoint(
                    self.save_folder, state.timestamp.batch, ts, meta,
                    overwrite=self.save_overwrite,
                    wait=not self.async_checkpoint, remote=self.save_remote)
        finally:
            if self.ema_algorithm:
                self.ema_algorithm.swap_out(state)
        self._last_saved_batch = state.timestamp.batch
        # retention never waits on the async write: it counts as the newest
        if dist.is_coordinator():
            ckpt.prune_checkpoints(self.save_folder,
                                   self.save_num_checkpoints_to_keep)
        return path

    @torch.no_grad()
    def _whole(self, tensors: Sequence[torch.Tensor], empty: bool = False
               ) -> List[torch.Tensor]:
        """The whole tensors, in the one-rank format, of this rank's parts
        of tensors laid out as the trainable parameters (the parameters, a
        moment, the EMA, the gradients), in their order, on every rank (a
        collective): FSDP's shards gathered over the fsdp group, then the
        tp slices over the tp group. With `empty`, zeros of those shapes."""
        from torch.distributed.tensor import DTensor
        out = []
        for name, local, dp in zip(self.train_state.params, tensors,
                                   self._dparams):
            dim = self._tp_dims.get(name)
            if empty:
                shape = list(dp.shape)
                if dim is not None:
                    shape[dim] *= self._tp_shard.size
                out.append(torch.zeros(shape, dtype=local.dtype,
                                       device=local.device))
                continue
            t = local
            if self._fsdp:
                t = DTensor.from_local(
                    local, dp.device_mesh, dp.placements, run_check=False,
                    shape=dp.shape, stride=dp.stride()).full_tensor()
            if dim is not None:
                parts = [torch.empty_like(t) for _ in
                         range(self._tp_shard.size)]
                torch.distributed.all_gather(
                    parts, t.contiguous(),
                    group=process_group(self._tp_shard.group))
                t = tp_join(name, parts, dim)
            out.append(t)
        return out

    @torch.no_grad()
    def _full_state(self, empty: bool = False) -> TrainState:
        """The whole train state of a sharded run, on every rank (a
        collective): the parameters, moments and EMA gathered from the
        shards; with `empty`, zeros of those shapes to load into."""
        ts, opt = self.train_state, self.train_state.optimizer
        names = list(ts.params)
        holder = copy.copy(opt)
        holder.mu = self._whole(opt.mu, empty)
        holder.nu = self._whole(opt.nu, empty)
        holder.params = self._whole(list(ts.params.values()), empty)
        ema = None if ts.ema_params is None else dict(zip(names, self._whole(
            list(ts.ema_params.values()), empty)))
        return TrainState(step=ts.step, params=dict(zip(names, holder.params)),
                          optimizer=holder, ema_params=ema)

    @torch.no_grad()
    def _load_shards(self, full: TrainState, weights_only: bool) -> None:
        """Copy this rank's parts of a whole train state into the live one:
        its tp slices, then of those FSDP2's `torch.chunk` of dim 0 over the
        fsdp axis."""
        ts, opt = self.train_state, self.train_state.optimizer
        n = self._axes["fsdp"] if self._fsdp else 1

        def put(local, whole, name):
            dim = self._tp_dims.get(name)
            if dim is not None:
                whole = tp_slice(name, whole, dim, self._tp_shard.index,
                                 self._tp_shard.size)
            chunks = torch.chunk(whole, n, dim=0)
            part = (chunks[self._fsdp_index] if self._fsdp_index < len(chunks)
                    else whole[:0])
            local.copy_(part.reshape(local.shape))

        names = list(ts.params)
        for name in names:
            put(ts.params[name], full.params[name], name)
        if weights_only:
            return
        for i, name in enumerate(names):
            put(opt.mu[i], full.optimizer.mu[i], name)
            put(opt.nu[i], full.optimizer.nu[i], name)
        opt.count = full.optimizer.count
        if ts.ema_params is not None:
            for name in names:
                put(ts.ema_params[name], full.ema_params[name], name)
        ts.step = full.step

    def _finish_checkpoints(self) -> None:
        """Make the last save durable (and its remote copy), then let the
        checkpoints it outdates age out."""
        ckpt.finalize_pending()
        ckpt.drain_remote_uploads()
        if dist.is_coordinator():
            ckpt.prune_checkpoints(self.save_folder,
                                   self.save_num_checkpoints_to_keep)
        # the other ranks may read the checkpoint next (a resume)
        dist.barrier()

    def _maybe_restore(self, autoresume: bool, load_path: Optional[str],
                       load_weights_only: bool) -> None:
        path = None
        from_save_folder = False
        if autoresume and self.save_folder:
            if self.save_remote and dist.is_coordinator():
                # a fresh host: the newest checkpoint may be remote only
                ckpt.sync_from_remote(self.save_folder, self.save_remote)
            dist.barrier()
            path = ckpt.latest_checkpoint_path(self.save_folder)
            from_save_folder = path is not None
        if path is None and load_path:
            path = load_path
        if path is None:
            return
        ts = self.train_state
        # on a mesh every rank reads the whole state and keeps its shards
        target = self._full_state(empty=True) if self._sharded else ts
        if load_weights_only:
            ckpt.load_checkpoint(path, target, partial=True)
            if self._sharded:
                self._load_shards(target, weights_only=True)
            if ts.ema_params is not None:
                # the EMA was seeded from the initial weights: seed it from
                # the loaded ones, or it blends toward the discarded init
                with torch.no_grad():
                    for name, p in ts.params.items():
                        ts.ema_params[name].copy_(p)
            return
        _, meta = ckpt.load_checkpoint(path, target)
        if self._sharded:
            self._load_shards(target, weights_only=False)
        self.state.timestamp.load_state_dict(meta.get("timestamp", {}))
        if from_save_folder:
            # this batch's checkpoint is the one just restored: a rerun of
            # a finished fit must not write it again
            self._last_saved_batch = self.state.timestamp.batch
        for a in self.engine.algorithms:
            a.load_state_dict(meta.get("algorithms", {}).get(
                type(a).__name__, {}))
        for c in self.engine.callbacks:
            c.load_state_dict(meta.get("callbacks", {}).get(
                type(c).__name__, {}))
        if "dataloader" in meta and hasattr(self.train_dataloader,
                                            "load_state_dict"):
            self.train_dataloader.load_state_dict(meta["dataloader"])
        # checkpoints are written EMA-active: swap back for training
        if self.ema_algorithm and self.ema_algorithm.ema_weights_active:
            self.ema_algorithm.swap_out(self.state)

    def close(self) -> None:
        self._finish_checkpoints()
        self.logger.close()
        # the generation metrics' towers go with their hooks
        for hook in self.metric_hooks:
            hook.close()
        self.metric_hooks = []
        # the step's CUDA graph, and with it its memory pool
        self._step_graph = StepGraph()
        # persistent-worker loaders keep a process or thread pool alive
        for loader in [self.train_dataloader] + [
                e.dataloader for e in self.evaluators]:
            close_fn = getattr(loader, "close", None)
            if callable(close_fn):
                close_fn()
