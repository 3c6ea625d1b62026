"""Training-time bookkeeping: Time / Timestamp with 'ba'/'ep'/'sp'/'dur' units.

A copy of `diffusion_tpu/utils/time.py`, which imports no jax: the port
imports nothing of the JAX package (ROADMAP.md queue 4 item 1 lists lifting
such copies into a shared module). Composer's Time system as the yamls use
it (`max_duration: 550000ba`, scheduler `t_warmup: 10000ba`, milestones
`200ep`).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from enum import Enum
from typing import Union

__all__ = ["TimeUnit", "Time", "Timestamp", "time_to_batches"]


class TimeUnit(Enum):
    BATCH = "ba"
    EPOCH = "ep"
    SAMPLE = "sp"
    TOKEN = "tok"
    DURATION = "dur"


_TIME_RE = re.compile(r"^\s*([-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?)\s*(ba|ep|sp|tok|dur)\s*$")


@dataclass(frozen=True, order=False)
class Time:
    """A value with a time unit, e.g. Time.from_str('10000ba')."""

    value: Union[int, float]
    unit: TimeUnit

    @staticmethod
    def from_str(s: Union[str, "Time", int]) -> "Time":
        if isinstance(s, Time):
            return s
        if isinstance(s, (int, float)):
            if float(s) != int(s):
                # a bare 0.5 (user means half the run) would silently
                # truncate to 0 batches — e.g. save_interval: 0.5 turning
                # checkpointing OFF for the whole run. Fractions must say
                # their unit.
                raise ValueError(
                    f"bare fractional time {s!r}: use an explicit unit "
                    f"string like '{s}dur'")
            return Time(int(s), TimeUnit.BATCH)
        m = _TIME_RE.match(s)
        if not m:
            raise ValueError(f"cannot parse time string {s!r} (want e.g. '10000ba', '200ep', '0.5dur')")
        raw, unit = m.groups()
        unit = TimeUnit(unit)
        value = float(raw)
        if unit != TimeUnit.DURATION and value == int(value):
            value = int(value)
        return Time(value, unit)

    def _check(self, other: "Time") -> None:
        if self.unit != other.unit:
            raise ValueError(f"cannot compare {self.unit} with {other.unit}")

    def __lt__(self, other: "Time") -> bool:
        self._check(other)
        return self.value < other.value

    def __le__(self, other: "Time") -> bool:
        self._check(other)
        return self.value <= other.value

    def __gt__(self, other: "Time") -> bool:
        self._check(other)
        return self.value > other.value

    def __ge__(self, other: "Time") -> bool:
        self._check(other)
        return self.value >= other.value

    def __str__(self) -> str:
        return f"{self.value}{self.unit.value}"


@dataclass
class Timestamp:
    """Monotonic training position: batches, samples, epochs, tokens."""

    batch: int = 0
    sample: int = 0
    epoch: int = 0
    token: int = 0
    batch_in_epoch: int = 0

    def to_next_batch(self, samples: int = 0, tokens: int = 0) -> None:
        self.batch += 1
        self.batch_in_epoch += 1
        self.sample += samples
        self.token += tokens

    def to_next_epoch(self) -> None:
        self.epoch += 1
        self.batch_in_epoch = 0

    def get(self, unit: TimeUnit) -> int:
        if unit == TimeUnit.BATCH:
            return self.batch
        if unit == TimeUnit.EPOCH:
            return self.epoch
        if unit == TimeUnit.SAMPLE:
            return self.sample
        if unit == TimeUnit.TOKEN:
            return self.token
        raise ValueError(f"cannot get absolute value of {unit}")

    def state_dict(self) -> dict:
        return {
            "batch": self.batch,
            "sample": self.sample,
            "epoch": self.epoch,
            "token": self.token,
            "batch_in_epoch": self.batch_in_epoch,
        }

    def load_state_dict(self, d: dict) -> None:
        for k, v in d.items():
            setattr(self, k, int(v))


def time_to_batches(t: Union[str, Time], max_duration: Union[str, Time],
                    batches_per_epoch: int = 0) -> int:
    """Convert a Time to an absolute batch count (for schedules/intervals)."""
    t = Time.from_str(t)
    max_duration = Time.from_str(max_duration)
    if t.unit == TimeUnit.BATCH:
        return int(t.value)
    if t.unit == TimeUnit.DURATION:
        if max_duration.unit != TimeUnit.BATCH:
            if max_duration.unit == TimeUnit.EPOCH and batches_per_epoch:
                return int(t.value * max_duration.value * batches_per_epoch)
            raise ValueError("duration-relative time needs a batch-denominated max_duration")
        return int(t.value * max_duration.value)
    if t.unit == TimeUnit.EPOCH:
        if not batches_per_epoch:
            raise ValueError("epoch-denominated time needs batches_per_epoch")
        return int(t.value * batches_per_epoch)
    raise ValueError(f"cannot convert {t} to batches")
