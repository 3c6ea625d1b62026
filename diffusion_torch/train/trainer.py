"""The single-device Trainer: grad accumulation, AdamW, EMA, events.

Counterpart of `diffusion_tpu/train/trainer.py` (`_init_device_state`,
`_make_train_step`, `fit`), with the JAX constructor's names. One training
batch is one step:

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

Runs on `device` (CUDA unless the caller asks for the CPU; it raises where
CUDA is missing), which must be the model's. A mesh, evaluators,
checkpoints and resuming raise NotImplementedError naming their ROADMAP.md
items.
"""

from __future__ import annotations

import time as _time
from typing import (Any, Callable, Dict, Iterable, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from diffusion_torch.algorithms.ema import (EMA, apply_ema,
                                            ema_smoothing_for_step)
from diffusion_torch.train.events import Algorithm, Callback, Event, EventEngine
from diffusion_torch.train.optim import (build_optimizer, constant_scheduler,
                                         global_norm)
from diffusion_torch.train.state import State, TrainState
from diffusion_torch.utils.device import Device, resolve_device
from diffusion_torch.utils.logging import (ConsoleLogger, Logger,
                                           LoggerCollection)
from diffusion_torch.utils.time import Time, Timestamp, time_to_batches

__all__ = ["Trainer", "grad_accum_steps"]

NoiseHook = Callable[[int, int, int, Dict[str, torch.Tensor]],
                     Tuple[torch.Tensor, torch.Tensor]]


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
        eval_dataloader: Optional[Iterable] = None,
        optimizers: Optional[dict] = None,
        schedulers: Optional[Callable[[int], float]] = None,
        loggers: Union[None, Logger, Sequence[Logger]] = None,
        algorithms: Optional[Sequence[Algorithm]] = None,
        callbacks: Optional[Sequence[Callback]] = None,
        *,
        max_duration: Union[str, int] = "1ba",
        device_train_microbatch_size: Optional[int] = None,
        run_name: str = "run",
        seed: int = 17,
        scale_schedule_ratio: float = 1.0,
        save_folder: Optional[str] = None,
        autoresume: bool = False,
        load_path: Optional[str] = None,
        skip_nonfinite_updates: bool = False,
        mesh: Any = None,
        mesh_config: Optional[dict] = None,
        grad_clip_norm: Optional[float] = None,
        batches_per_epoch: Optional[int] = None,
        device: Device = None,
        log_to_console: bool = False,
        noise_hook: Optional[NoiseHook] = None,
    ):
        if eval_dataloader is not None:
            raise _unported("evaluators", 3, "the eval loop")
        if save_folder:
            raise _unported("save_folder", 4, "checkpoints and pretrained "
                            "weights")
        if autoresume or load_path:
            raise _unported("load_path/autoresume", 4, "checkpoints and "
                            "pretrained weights")
        if mesh is not None or mesh_config:
            raise _unported("a device mesh", 9, "multi-device")
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
        self.skip_nonfinite_updates = skip_nonfinite_updates
        self.noise_hook = noise_hook

        if loggers is None:
            loggers = [ConsoleLogger(log_interval=100)] if log_to_console else []
        elif isinstance(loggers, Logger):
            loggers = [loggers]
        self.logger = LoggerCollection(loggers)
        self.engine = EventEngine(algorithms or [], callbacks or [])
        self.ema_algorithm: Optional[EMA] = next(
            (a for a in self.engine.algorithms if isinstance(a, EMA)), None)

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

    def _generator(self, step: int) -> torch.Generator:
        """The step's generator: its seed mixes the run seed and the step."""
        mixed = np.random.SeedSequence([self.seed, step]).generate_state(
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
        gen = self._generator(ts.step)
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

    def _device_batches(self) -> Iterable[Tuple[Dict[str, torch.Tensor], int]]:
        for host_batch in self.train_dataloader:
            batch = {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                     for k, v in host_batch.items()}
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
                self.engine.run(Event.BATCH_CHECKPOINT, state, logger)
            if not epoch_had_batches:
                raise RuntimeError("train_dataloader yielded no batches")
            state.timestamp.to_next_epoch()
            self.engine.run(Event.EPOCH_END, state, logger)
            self.engine.run(Event.EPOCH_CHECKPOINT, state, logger)

        self.engine.run(Event.FIT_END, state, logger)
        logger.flush()

    def close(self) -> None:
        self.logger.close()
