"""Iterator-combinator pipelines: tar/webdataset reading, shuffling, sharding,
weighted mixing — the host data-plane for web-scale training.

A copy of `diffusion_tpu/data/datapipes.py` with its imports pointed at the
port's modules (the port imports nothing of the JAX package), and jax's
process count, index and all-hosts gather replaced by torch.distributed's
(`rank_and_world`, an all-reduce of the minimum).

The equivalent of the reference's torchdata DataPipes graphs
(reference: diffusion/datasets/wds/wds_datapipe.py — shard listing from
dir-walk or JSON manifest :34-47, shard-shuffle -> tar load -> webdataset
grouping -> key rename :65-76, decode json/text/PIL :89-107, drop-incomplete
:79-86, metadata filter :135-138, sample shuffle, `apply_sharding(world,
rank)` :142-147, transform/tokenize maps :149-157; mix_datapipe.py:85
SampleMultiplexer weighted mixing; DataLoader2 + fullsync tail :216-238).

Plain Python generators instead of DataPipe objects: the hot path is PIL
decode + numpy, threads come from data/dataloader.py's pool, and the
`fullsync` distributed barrier is an explicit all-hosts agreement generator
(length_sync) rather than a reading-service.
"""

from __future__ import annotations

import functools
import io
import json
import logging
import os
import random
import tarfile
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Mapping,
                     Optional, Sequence, Union)

from diffusion_torch.data.filters import filter_fn, log_and_continue

logger = logging.getLogger(__name__)

__all__ = ["list_shards", "shard_shuffle", "apply_sharding", "tar_samples",
           "rename_keys", "decode_sample", "drop_incomplete", "filter_samples",
           "sample_shuffle", "map_samples", "sample_multiplexer", "batcher",
           "length_sync", "WdsPipeline"]

_IMAGE_EXTS = ("jpg", "jpeg", "png", "webp")


def list_shards(urls: Union[str, Sequence[str]],
                manifest: Optional[str] = None) -> List[str]:
    """Tar shard list from a dir walk, glob list, or JSON manifest
    (reference wds_datapipe.py:34-47)."""
    if manifest:
        with open(manifest) as f:
            data = json.load(f)
        return list(data["shards"] if isinstance(data, dict) else data)
    if isinstance(urls, str):
        if os.path.isdir(urls):
            out = []
            for root, _, files in os.walk(urls):
                out.extend(os.path.join(root, f) for f in files
                           if f.endswith(".tar"))
            return sorted(out)
        return [urls]
    return list(urls)


def shard_shuffle(shards: Sequence[str], seed: int = 0,
                  epoch: int = 0) -> List[str]:
    out = list(shards)
    random.Random(f"{seed}-{epoch}").shuffle(out)
    return out


def apply_sharding(items: Iterable[Any], world_size: int, rank: int) -> Iterator[Any]:
    """Every world_size-th item for this rank (torchdata apply_sharding
    parity, reference wds_datapipe.py:142-147)."""
    for i, item in enumerate(items):
        if i % world_size == rank:
            yield item


def _tar_entries(shard: str):
    """(name, data) pairs for regular files; native single-pass index when
    libdataio.so is built (csrc/dataio.cpp — python tarfile is pure Python
    and dominates shard-read CPU), else the tarfile fallback."""
    from diffusion_torch.data.native import native_available, tar_index
    if native_available() and not shard.endswith((".gz", ".tgz", ".bz2", ".xz")):
        with open(shard, "rb") as f:
            data = f.read()
        for name, off, size in tar_index(shard):
            yield name, data[off:off + size]
        return
    with tarfile.open(shard, mode="r|*") as tf:
        for member in tf:
            if not member.isfile():
                continue
            fobj = tf.extractfile(member)
            if fobj is not None:
                yield member.name, fobj.read()


def tar_samples(shards: Iterable[str],
                handler: Callable[[BaseException], bool] = log_and_continue
                ) -> Iterator[Dict[str, Any]]:
    """Stream webdataset-grouped samples out of tar shards: members sharing a
    basename become one dict keyed by extension, plus __key__/__url__."""
    for shard in shards:
        try:
            current_key: Optional[str] = None
            sample: Dict[str, Any] = {}
            for name, data in _tar_entries(shard):
                base, _, ext = name.rpartition(".")
                ext = ext.lower()
                if not base:       # no extension at all
                    base, ext = ext, ""
                if base != current_key:
                    if current_key is not None and sample:
                        yield sample
                    current_key = base
                    sample = {"__key__": base, "__url__": shard}
                sample[ext] = data
            if current_key is not None and sample:
                yield sample
        except Exception as e:  # tar-level corruption: skip shard
            if not handler(e):
                raise


def rename_keys(samples: Iterable[Dict[str, Any]],
                mapping: Optional[Mapping[str, str]] = None
                ) -> Iterator[Dict[str, Any]]:
    """.jpg/.png/.jpeg/.webp -> image (reference wds_datapipe.py:65-76)."""
    mapping = dict(mapping or {ext: "image" for ext in _IMAGE_EXTS})
    for s in samples:
        out = {}
        for k, v in s.items():
            out[mapping.get(k, k)] = v
        yield out


def decode_sample(sample: Dict[str, Any],
                  image_mode: str = "RGB",
                  draft_size: Optional[int] = None) -> Dict[str, Any]:
    """json -> dict, txt -> str, image bytes -> PIL (reference :89-107).

    draft_size: when the downstream transform resizes to ~draft_size, pass
    it here and JPEGs decode at libjpeg's reduced DCT scale (>=2x kept for
    resample headroom) — a large fraction of raw-LAION decode time."""
    from PIL import Image, ImageFile
    ImageFile.LOAD_TRUNCATED_IMAGES = True  # tolerance, reference :31
    out: Dict[str, Any] = {}
    for k, v in sample.items():
        if k == "json" and isinstance(v, (bytes, str)):
            try:
                out[k] = json.loads(v)
            except (json.JSONDecodeError, UnicodeDecodeError):
                out[k] = {}
        elif k in ("txt", "text", "caption") and isinstance(v, bytes):
            out[k] = v.decode("utf-8", errors="replace")
        elif k == "image" and isinstance(v, bytes):
            img = Image.open(io.BytesIO(v))
            if draft_size and img.format == "JPEG":
                img.draft(image_mode, (2 * draft_size, 2 * draft_size))
            out[k] = img.convert(image_mode)
        else:
            out[k] = v
    return out


def drop_incomplete(samples: Iterable[Dict[str, Any]],
                    required: Sequence[str] = ("image",)) -> Iterator[Dict[str, Any]]:
    """(reference wds_datapipe.py:79-86)"""
    for s in samples:
        if all(k in s and s[k] is not None for k in required):
            yield s


def filter_samples(samples: Iterable[Dict[str, Any]],
                   filter_strategy: Optional[Mapping[str, Any]] = None
                   ) -> Iterator[Dict[str, Any]]:
    for s in samples:
        if filter_fn(s, filter_strategy):
            yield s


def sample_shuffle(samples: Iterable[Any], buffer_size: int = 1000,
                   seed: int = 0) -> Iterator[Any]:
    """Reservoir-style streaming shuffle."""
    rng = random.Random(seed)
    buf: List[Any] = []
    for s in samples:
        if len(buf) < buffer_size:
            buf.append(s)
            continue
        i = rng.randrange(buffer_size)
        yield buf[i]
        buf[i] = s
    rng.shuffle(buf)
    yield from buf


def map_samples(samples: Iterable[Any], fn: Callable[[Any], Any],
                handler: Callable[[BaseException], bool] = log_and_continue
                ) -> Iterator[Any]:
    for s in samples:
        try:
            out = fn(s)
        except Exception as e:  # per-sample tolerance (reference utils.py:5-8)
            if not handler(e):
                raise
            continue
        if out is not None:
            yield out


def sample_multiplexer(pipes_to_weights: Mapping[Iterable[Any], float],
                       seed: int = 0) -> Iterator[Any]:
    """Weighted random interleave; a pipe leaving the mix when exhausted
    (torchdata SampleMultiplexer parity, reference mix_datapipe.py:85)."""
    rng = random.Random(seed)
    iters = [(iter(p), float(w)) for p, w in pipes_to_weights.items()]
    while iters:
        total = sum(w for _, w in iters)
        r = rng.random() * total
        acc = 0.0
        for i, (it, w) in enumerate(iters):
            acc += w
            if r <= acc:
                try:
                    yield next(it)
                except StopIteration:
                    iters.pop(i)
                break


def batcher(samples: Iterable[Any], batch_size: int, drop_last: bool = True,
            collate_fn: Optional[Callable] = None) -> Iterator[Any]:
    from diffusion_torch.data.dataloader import default_collate
    collate = collate_fn or default_collate
    buf: List[Any] = []
    for s in samples:
        buf.append(s)
        if len(buf) == batch_size:
            yield collate(buf)
            buf = []
    if buf and not drop_last:
        yield collate(buf)


def length_sync(batches: Iterable[Any]) -> Iterator[Any]:
    """All-hosts agreement that a next batch exists — the `fullsync` analogue
    (reference wds_datapipe.py:220-221): each host contributes 1/0, the global
    minimum decides whether anyone yields. Prevents divergence when tar shards
    are unevenly sized across hosts."""
    from diffusion_torch.utils.device import rank_and_world
    if rank_and_world()[1] == 1:
        yield from batches
        return
    import torch
    import torch.distributed as dist
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    it = iter(batches)
    while True:
        try:
            nxt = next(it)
            have = 1
        except StopIteration:
            nxt, have = None, 0
        flag = torch.tensor([have], dtype=torch.int32, device=device)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        if int(flag.item()) == 0:
            return
        yield nxt


class WdsPipeline:
    """Composed tar->batch pipeline usable as a Trainer dataloader.

    Reconstructs the reference's graph (wds_datapipe.py:65-159,216-238):
    shard shuffle -> per-host shard split -> tar read -> rename -> decode ->
    drop-incomplete -> metadata filter -> sample shuffle -> map(transform)
    -> batch -> fullsync. Re-iterating advances the epoch (new shard order).
    """

    def __init__(self, shards: Sequence[str], transform: Callable,
                 batch_size: int, filter_strategy: Optional[Mapping] = None,
                 required: Sequence[str] = ("image",),
                 shuffle_buffer: int = 1000, seed: int = 42,
                 drop_last: bool = True, shuffle: bool = True,
                 draft_size: Optional[int] = None):
        self.draft_size = draft_size
        self.shards = list(shards)
        self.transform = transform
        self.batch_size = batch_size
        self.filter_strategy = filter_strategy
        self.required = required
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed
        self.drop_last = drop_last
        self.shuffle = shuffle
        self._epoch = 0

    def __iter__(self) -> Iterator[Any]:
        from diffusion_torch.utils.device import rank_and_world
        epoch = self._epoch
        self._epoch += 1
        shards = (shard_shuffle(self.shards, self.seed, epoch)
                  if self.shuffle else list(self.shards))
        rank, world = rank_and_world()
        shards = apply_sharding(shards, world, rank)
        samples = tar_samples(shards)
        samples = rename_keys(samples)
        samples = map_samples(
            samples,
            functools.partial(decode_sample, draft_size=self.draft_size))
        samples = drop_incomplete(samples, self.required)
        samples = filter_samples(samples, self.filter_strategy)
        if self.shuffle:
            samples = sample_shuffle(samples, self.shuffle_buffer,
                                     seed=(self.seed + epoch))
        samples = map_samples(samples, self.transform)
        batches = batcher(samples, self.batch_size, self.drop_last)
        return length_sync(batches)

    def state_dict(self) -> Dict[str, int]:
        return {"epoch": self._epoch}

    def load_state_dict(self, d: Dict[str, int]) -> None:
        self._epoch = int(d.get("epoch", 0))
