"""Logger destinations: console, JSON-lines file and WandB.

A copy of the Logger, ConsoleLogger, FileLogger, WandBLogger and
LoggerCollection part of `diffusion_tpu/utils/logging.py`, which imports no
jax: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

__all__ = ["Logger", "ConsoleLogger", "FileLogger", "WandBLogger",
           "LoggerCollection"]


class Logger:
    def log_metrics(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        pass

    def log_hyperparameters(self, params: Dict[str, Any]) -> None:
        pass

    def log_images(self, images, name: str = "image",
                   step: Optional[int] = None, **kwargs) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


def _scalarize(v: Any) -> Any:
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


class ConsoleLogger(Logger):
    def __init__(self, log_interval: int = 1, stream=None):
        self.log_interval = max(int(log_interval), 1)
        self.stream = stream or sys.stderr

    def log_metrics(self, metrics, step=None):
        if step is not None and step % self.log_interval:
            return
        vals = {k: _scalarize(v) for k, v in metrics.items()}
        parts = " ".join(f"{k}={s:.6g}" if isinstance(s, float)
                         else f"{k}={s}" for k, s in vals.items())
        print(f"[step {step}] {parts}", file=self.stream, flush=True)


class FileLogger(Logger):
    """JSON-lines metrics file: one {'step':…, …} record per call."""

    def __init__(self, filename: str = "metrics.jsonl", flush_interval: int = 50):
        os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
        self._f = open(filename, "a")
        self._n = 0
        self.flush_interval = max(int(flush_interval), 1)

    def log_metrics(self, metrics, step=None):
        rec = {"step": step, "time": time.time()}
        rec.update({k: _scalarize(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._n += 1
        if self._n % self.flush_interval == 0:
            self._f.flush()

    def log_hyperparameters(self, params):
        self._f.write(json.dumps({"hparams": {k: _scalarize(v)
                                              for k, v in params.items()}}) + "\n")
        self._f.flush()

    def flush(self):
        self._f.flush()

    def close(self):
        if not self._f.closed:
            self._f.close()


class WandBLogger(Logger):
    """WandB destination (reference train.py:74-82 injects token/host/mode via
    env vars; same here — WANDB_API_KEY/WANDB_MODE). No-ops if wandb is not
    installed, and says so on stderr."""

    def __init__(self, name: Optional[str] = None, project: Optional[str] = None,
                 group: Optional[str] = None, config: Optional[dict] = None,
                 **init_kwargs):
        try:
            import wandb
        except ImportError:
            self._run = None
            print("WandBLogger: wandb not installed; logging disabled",
                  file=sys.stderr)
            return
        self._wandb = wandb
        self._run = wandb.init(name=name, project=project, group=group,
                               config=config, **init_kwargs)

    def log_metrics(self, metrics, step=None):
        if self._run:
            self._run.log({k: _scalarize(v) for k, v in metrics.items()}, step=step)

    def log_hyperparameters(self, params):
        if self._run:
            self._run.config.update(params, allow_val_change=True)

    def log_images(self, images, name="image", step=None, **kwargs):
        if self._run:
            imgs = np.asarray(images)
            if imgs.ndim == 3:
                imgs = imgs[None]
            self._run.log({name: [self._wandb.Image(i) for i in imgs]}, step=step)

    def close(self):
        if self._run:
            self._run.finish()


class LoggerCollection(Logger):
    def __init__(self, loggers: Iterable[Logger] = ()):
        self.loggers: List[Logger] = list(loggers)

    def log_metrics(self, metrics, step=None):
        for lg in self.loggers:
            lg.log_metrics(metrics, step=step)

    def log_hyperparameters(self, params):
        for lg in self.loggers:
            lg.log_hyperparameters(params)

    def log_images(self, images, name="image", step=None, **kwargs):
        for lg in self.loggers:
            lg.log_images(images, name=name, step=step, **kwargs)

    def flush(self):
        for lg in self.loggers:
            lg.flush()

    def close(self):
        for lg in self.loggers:
            lg.close()
