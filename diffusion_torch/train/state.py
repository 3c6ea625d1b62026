"""TrainState (what the train step updates) and the host-side State handed
to callbacks and algorithms.

Counterpart of `diffusion_tpu/train/state.py`. JAX threads an immutable
pytree through a donated step; here the step updates in place: `params`
are the UNet's own `nn.Parameter`s by name, the optimizer holds its
moments, and `ema_params` are fp32 copies of the parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from diffusion_torch.utils.time import Timestamp

__all__ = ["TrainState", "State"]


@dataclasses.dataclass
class TrainState:
    """The step count, the trainable parameters, the optimizer, and the EMA
    shadow of the parameters (or None)."""

    step: int
    params: Dict[str, torch.nn.Parameter]
    optimizer: Any
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    # on a process mesh: `params` are this rank's FSDP shards (views of the
    # sharded parameters' local storage), as are the moments and the EMA
    shards: bool = False


@dataclasses.dataclass
class State:
    """Host-side view for events: the slice of composer.State the
    reference's algorithms and callbacks touch."""

    model: Any
    train_state: TrainState
    timestamp: Timestamp
    run_name: str = "run"
    max_duration: str = "1ba"
    max_batches: Optional[int] = None
    seed: int = 17
    device_train_microbatch_size: Optional[int] = None
    ema_start_batch: int = 0
    # per-batch transient fields
    batch: Optional[Dict[str, Any]] = None
    outputs: Optional[Any] = None
    loss: Optional[torch.Tensor] = None
    lr: Optional[float] = None
    metrics: Optional[Dict[str, torch.Tensor]] = None
    # eval transient fields
    eval_label: Optional[str] = None
    eval_batch_idx: int = 0
    # wall-clock scratch for monitors
    batch_wct: float = 0.0
    total_wct: float = 0.0
    rank: int = 0
