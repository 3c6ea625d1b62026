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
- timesteps and noise come from a `torch.Generator` derived from `seed` and
  the step (all microbatches draw from it in turn), unless `noise_hook`
  hands them over: ``noise_hook(step, micro_index, n_accum, microbatch) ->
  (noise, timesteps)``, which the tests use to give the port JAX's draws;
- the metrics are the JAX names: `loss/train/total`, `grad/global_norm`
  and, when skipping is on, `trainer/nonfinite_skipped`; `lr` is logged
  from the schedule at the trainer step, as JAX logs it.

Eval runs after batch `b` when `b % eval_interval == 0` and `b` is not the
last, and on `eval()`. Each evaluator's loader restarts at epoch 0 and is
cut at `eval_subset_num_batches`; under EVAL_START/EVAL_END (the EMA swaps
its weights in and out) and `torch.no_grad()`, each batch's per-example
MSE and the `MeanSquaredError/bin-lo-hi` timestep masks of the model's
`loss_bins` are summed as numerator/denominator pairs and logged as
`metrics/<label>/<name>`. Eval timesteps and noise come from a generator
derived from the model's `val_seed` and the batch index, unless
`eval_noise_hook(batch_index, batch) -> (noise, timesteps)` hands them over.

Runs on `device` (CUDA unless the caller asks for the CPU; it raises where
CUDA is missing), which must be the model's. A mesh or more than one
process, checkpoints and resuming raise NotImplementedError naming their
ROADMAP.md items; `fsdp_config`, `image_size`, `save_interval`,
`save_overwrite` and `precision` are recorded.
"""

from __future__ import annotations

import time as _time
from typing import (Any, Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch

from diffusion_torch.algorithms.ema import (EMA, apply_ema,
                                            ema_smoothing_for_step)
from diffusion_torch.train.events import Algorithm, Callback, Event, EventEngine
from diffusion_torch.train.optim import (build_optimizer, constant_scheduler,
                                         global_norm)
from diffusion_torch.train.state import State, TrainState
from diffusion_torch.utils.device import Device, rank_and_world, resolve_device
from diffusion_torch.utils.logging import (ConsoleLogger, Logger,
                                           LoggerCollection)
from diffusion_torch.utils.time import Time, Timestamp, time_to_batches

__all__ = ["Trainer", "Evaluator", "grad_accum_steps"]

NoiseHook = Callable[[int, int, int, Dict[str, torch.Tensor]],
                     Tuple[torch.Tensor, torch.Tensor]]
EvalNoiseHook = Callable[[int, Dict[str, torch.Tensor]],
                         Tuple[torch.Tensor, torch.Tensor]]


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


def _unported(what: str, item: int, title: str) -> NotImplementedError:
    return NotImplementedError(f"{what} comes with ROADMAP.md queue 1 item "
                               f"{item} ({title})")


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
        save_interval: Union[str, int] = "10000ba",
        save_overwrite: bool = True,
        autoresume: bool = False,
        load_path: Optional[str] = None,
        skip_nonfinite_updates: bool = False,
        eval_subset_num_batches: int = -1,
        mesh: Any = None,
        mesh_config: Optional[dict] = None,
        fsdp_config: Optional[dict] = None,
        image_size: int = 256,
        grad_clip_norm: Optional[float] = None,
        batches_per_epoch: Optional[int] = None,
        device: Device = None,
        precision: str = "amp_bf16",
        progress_bar: bool = False,
        log_to_console: bool = False,
        noise_hook: Optional[NoiseHook] = None,
        eval_noise_hook: Optional[EvalNoiseHook] = None,
    ):
        del progress_bar  # yaml parity; the trainer prints no bar
        if save_folder:
            raise _unported("save_folder", 4, "checkpoints and pretrained "
                            "weights")
        if autoresume or load_path:
            raise _unported("load_path/autoresume", 4, "checkpoints and "
                            "pretrained weights")
        if mesh is not None or mesh_config:
            raise _unported("a device mesh", 9, "multi-device")
        if rank_and_world()[1] > 1:
            raise _unported("training on more than one process "
                            "(fsdp_config)", 9, "multi-device")
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
        self.save_interval = time_to_batches(save_interval, self.max_duration,
                                             batches_per_epoch or 0)
        self.save_overwrite = save_overwrite
        self.fsdp_config = fsdp_config
        self.image_size = image_size
        self.precision = precision
        self.skip_nonfinite_updates = skip_nonfinite_updates
        self.noise_hook = noise_hook
        self.eval_noise_hook = eval_noise_hook

        if loggers is None:
            loggers = [ConsoleLogger(log_interval=100)] if log_to_console else []
        elif isinstance(loggers, Logger):
            loggers = [loggers]
        self.logger = LoggerCollection(loggers)
        self.engine = EventEngine(algorithms or [], callbacks or [])
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
        self.state = State(
            model=model, train_state=self.train_state, timestamp=Timestamp(),
            run_name=run_name, seed=self.seed,
            max_duration=str(self.max_duration),
            max_batches=self.max_batches,
            device_train_microbatch_size=device_train_microbatch_size,
            ema_start_batch=(self.ema_algorithm.start_batch(
                self.max_duration, batches_per_epoch or 0)
                if self.ema_algorithm else 0))
        self.engine.run(Event.INIT, self.state, self.logger)

    # ------------------------------------------------------------------
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
        optimizer = build_optimizer(params.values(), optimizers, schedule,
                                    grad_clip_norm)
        ema = ({n: p.detach().clone() for n, p in params.items()}
               if self.ema_algorithm is not None else None)
        self.train_state = TrainState(step=0, params=params,
                                      optimizer=optimizer, ema_params=ema)

    def _generator(self, seed: int, index: int) -> torch.Generator:
        """A generator for (seed, index), e.g. the run seed and the step,
        or `val_seed` and the eval batch."""
        mixed = np.random.SeedSequence([seed, index]).generate_state(
            1, np.uint64)[0]
        return torch.Generator(device=self.device).manual_seed(
            int(mixed) & (2 ** 63 - 1))

    def _train_step(self, batch: Dict[str, torch.Tensor],
                    global_batch: int) -> Dict[str, torch.Tensor]:
        """One optimizer step over `batch`; returns the step's metrics."""
        ts = self.train_state
        params = list(ts.params.values())
        n_accum = (grad_accum_steps(global_batch, self.micro_size)
                   if self.micro_size else 1)
        micro = global_batch // n_accum
        gen = self._generator(self.seed, ts.step)
        for p in params:
            p.grad = None
        loss = torch.zeros((), device=self.device)
        self.model.unet.train()
        for i in range(n_accum):
            mb = {k: v[i * micro:(i + 1) * micro] for k, v in batch.items()}
            noise = timesteps = None
            if self.noise_hook is not None:
                noise, timesteps = self.noise_hook(ts.step, i, n_accum, mb)
            micro_loss = self.model.loss_fn(mb, gen, noise, timesteps)
            micro_loss.backward()
            loss += micro_loss.detach()
        grads = [p.grad for p in params]
        if n_accum > 1:
            torch._foreach_div_(grads, float(n_accum))
            loss /= n_accum
        gnorm = global_norm(grads)
        metrics = {"loss/train/total": loss, "grad/global_norm": gnorm}
        ok = True
        if self.skip_nonfinite_updates:
            ok = bool(torch.isfinite(loss) & torch.isfinite(gnorm))
            metrics["trainer/nonfinite_skipped"] = torch.tensor(
                0.0 if ok else 1.0)
        if ok:
            ts.optimizer.step(grad_norm=gnorm)
        if ts.ema_params is not None:
            eff = ema_smoothing_for_step(
                ts.step, self.ema_algorithm.smoothing(),
                self.state.ema_start_batch,
                int(self.ema_algorithm.update_interval.value))
            apply_ema(ts.ema_params, ts.params, eff if ok else 1.0)
        for p in params:
            p.grad = None
        ts.step += 1
        return metrics

    def _to_device(self, host_batch: Mapping[str, Any]
                   ) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in host_batch.items()}

    def _device_batches(self) -> Iterable[Tuple[Dict[str, torch.Tensor], int]]:
        for host_batch in self.train_dataloader:
            batch = self._to_device(host_batch)
            yield batch, int(next(iter(batch.values())).shape[0])

    # ------------------------------------------------------------------
    def fit(self) -> None:
        if self.train_dataloader is None:
            raise ValueError("fit() requires a train_dataloader")
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
                self.engine.run(Event.BEFORE_DATALOADER, state, logger)
                try:
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

                state.timestamp.to_next_batch(samples=samples)
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
                self.engine.run(Event.BATCH_CHECKPOINT, state, logger)
            if not epoch_had_batches:
                raise RuntimeError("train_dataloader yielded no batches")
            state.timestamp.to_next_epoch()
            self.engine.run(Event.EPOCH_END, state, logger)
            self.engine.run(Event.EPOCH_CHECKPOINT, state, logger)

        self.engine.run(Event.FIT_END, state, logger)
        logger.flush()

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _eval_step(self, batch: Dict[str, torch.Tensor], index: int
                   ) -> Dict[str, Tuple[float, float]]:
        """(numerator, denominator) of the MSE and of each loss bin's MSE
        over one batch: per-example means of the squared error."""
        model = self.model
        num_t = model.noise_scheduler.num_train_timesteps
        noise = timesteps = gen = None
        if self.eval_noise_hook is not None:
            noise, timesteps = self.eval_noise_hook(index, batch)
        else:
            gen = self._generator(model.val_seed, index)
        pred, target, t = model.forward(batch, gen, noise, timesteps)
        err = torch.square(pred.float() - target.float())
        per_example = err.mean(dim=tuple(range(1, err.ndim)))
        out = {"MeanSquaredError": (float(per_example.sum()),
                                    float(per_example.numel()))}
        for lo, hi in model.loss_bins:
            mask = ((t >= lo * num_t) & (t < hi * num_t)).float()
            out[f"MeanSquaredError/bin-{lo}-{hi}"] = (
                float((per_example * mask).sum()), float(mask.sum()))
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
                self.engine.run(Event.EVAL_BATCH_END, state, logger)
            for name, (num, den) in accum.items():
                if den > 0:
                    results[f"metrics/{evaluator.label}/{name}"] = num / den
        logger.log_metrics(results, step=state.timestamp.batch)
        self.engine.run(Event.EVAL_END, state, logger)
        return results

    def close(self) -> None:
        self.logger.close()
        # persistent-worker loaders keep a process or thread pool alive
        for loader in [self.train_dataloader] + [
                e.dataloader for e in self.evaluators]:
            close_fn = getattr(loader, "close", None)
            if callable(close_fn):
                close_fn()
