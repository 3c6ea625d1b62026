"""Weighted multi-source mixture dataloader.

A copy of `diffusion_tpu/data/mix.py` with its imports pointed at the
port's modules: children are built by the port's `config.instantiate`
(which resolves the yamls' `diffusion_tpu.*` targets under
`diffusion_torch.`), and the port imports nothing of the JAX package.

The equivalent of the reference's mix datapipe (reference:
diffusion/datasets/mix_datapipe.py:19-122 `build_mix_dataloader`): normalizes
per-source `weight` fields (ref :68-70), instantiates each child pipeline
with the shared transform/tokenizer/filter (ref :72-82), mixes with a
weighted SampleMultiplexer (ref :85), then the common batch/fullsync tail
(ref :87-96). The production mixture weights: pexels 0.012 / laion 5.3 /
coyo 2.1 / cc 0.06 (yamls/hydra-yamls/SD-2-base-256-mixdata.yaml:30-51).

Child pipes are declared as `_target_` config nodes that build *sample-level*
iterables (each child is built with batch_size=0 sentinel meaning "yield
samples, not batches"); mixing happens at sample granularity like the
reference.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Iterator, Mapping, Optional

from diffusion_torch.config import instantiate
from diffusion_torch.data.datapipes import batcher, length_sync, sample_multiplexer

__all__ = ["MixPipeline", "build_mix_dataloader"]


class _Samples:
    """Adapter: iterate a batch-pipeline's samples (batch_size=1, unbatched)."""

    def __init__(self, pipe: Any, name: str = ""):
        self.pipe = pipe
        self.name = name

    def __iter__(self) -> Iterator[Any]:
        for batch in self.pipe:
            # unpack a size-1 batch back into a sample dict
            yield {k: (v[0] if hasattr(v, "__getitem__") else v)
                   for k, v in batch.items()}


class MixPipeline:
    def __init__(self, pipes_to_weights: Mapping[Any, float], batch_size: int,
                 seed: int = 42, drop_last: bool = True):
        self.pipes_to_weights = dict(pipes_to_weights)
        self.batch_size = batch_size
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def __iter__(self) -> Iterator[Any]:
        epoch = self._epoch
        self._epoch += 1
        mixed = sample_multiplexer(self.pipes_to_weights, seed=self.seed + epoch)
        batches = batcher(mixed, self.batch_size, self.drop_last)
        return length_sync(batches)

    def state_dict(self) -> Dict[str, int]:
        return {"epoch": self._epoch}

    def load_state_dict(self, d: Dict[str, int]) -> None:
        self._epoch = int(d.get("epoch", 0))

    def describe(self) -> str:
        """Text rendering of the composed pipeline graph — the debugging
        analog of the reference's to_graph PDF dump (reference
        mix_datapipe.py:98-100): every source with its normalized weight,
        then the stage chain each batch flows through."""
        lines = [f"MixPipeline(batch_size={self.batch_size}, "
                 f"seed={self.seed}, drop_last={self.drop_last})"]
        for pipe, weight in self.pipes_to_weights.items():
            name = getattr(pipe, "name", "") or type(pipe).__name__
            inner = getattr(pipe, "pipe", pipe)
            lines.append(f"  source {name} (weight {weight:.4f}): "
                         f"{type(inner).__name__}")
        lines.append("  stages: sample_multiplexer(seed+epoch) -> "
                     f"batcher(batch_size={self.batch_size}, "
                     f"drop_last={self.drop_last}) -> length_sync")
        return "\n".join(lines)


def build_mix_dataloader(
    datapipes: Mapping[str, Mapping[str, Any]],
    batch_size: int = 8,
    tokenizer_name_or_path: Optional[str] = None,
    resize_size: int = 256,
    caption_drop_prob: float = 0.0,
    filter_strategy: Any = None,
    seed: int = 42,
    drop_last: bool = True,
    **_: Any,
) -> MixPipeline:
    """Each entry of `datapipes` is {_target_: <builder>, weight: w, ...};
    weights are normalized (ref :68-70); shared kwargs are forwarded to every
    child builder (ref :72-82)."""
    total = sum(float(c.get("weight", 1.0)) for c in datapipes.values())
    pipes_to_weights: Dict[Any, float] = {}
    for name, conf in datapipes.items():
        conf = dict(conf)
        weight = float(conf.pop("weight", 1.0)) / total
        child = instantiate(
            conf, batch_size=1,
            tokenizer_name_or_path=tokenizer_name_or_path,
            resize_size=resize_size, caption_drop_prob=caption_drop_prob,
            filter_strategy=filter_strategy, drop_last=True)
        pipes_to_weights[_Samples(child, name=name)] = weight
    mix = MixPipeline(pipes_to_weights, batch_size=batch_size, seed=seed,
                      drop_last=drop_last)
    for line in mix.describe().splitlines():
        logging.getLogger(__name__).info("%s", line)
    return mix
