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
decode + numpy, and the `fullsync` distributed barrier is an explicit
all-hosts agreement generator (length_sync) rather than a reading-service.
Where `WdsPipeline` has loader workers, each sample's JPEG decode, crop and
resize run in a pool of spawned processes (`ordered_map`), as the
reference's graph ran under torchdata's MultiProcessingReadingService
(wds_datapipe.py:234-237); the stages whose order or draws matter stay on
the iterating thread.
"""

from __future__ import annotations

import collections
import io
import json
import logging
import multiprocessing
import os
import pickle
import random
import tarfile
import threading
import weakref
from concurrent.futures import Future, ProcessPoolExecutor
from concurrent.futures.process import BrokenProcessPool
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Mapping,
                     Optional, Sequence, Union)

from diffusion_torch.data.filters import filter_fn, log_and_continue
from diffusion_torch.ops._build import LaunchCounter

logger = logging.getLogger(__name__)

__all__ = ["list_shards", "shard_shuffle", "apply_sharding", "tar_samples",
           "rename_keys", "decode_sample", "drop_incomplete", "filter_samples",
           "sample_shuffle", "map_samples", "ordered_map",
           "sample_multiplexer", "batcher", "length_sync", "WdsPipeline",
           "decoded_in_workers", "decoded_inline"]

# `WdsPipeline`'s samples whose image a loader worker decoded, and those
# the iterating thread decoded (counted on that thread, as they are taken)
decoded_in_workers = LaunchCounter()
decoded_inline = LaunchCounter()

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
            out[k] = open_image(v, image_mode, draft_size)
        else:
            out[k] = v
    return out


def open_image(data: bytes, image_mode: str = "RGB",
               draft_size: Optional[int] = None):
    """decode_sample's image branch: bytes -> PIL image in `image_mode`."""
    from PIL import Image, ImageFile
    ImageFile.LOAD_TRUNCATED_IMAGES = True  # tolerance, reference :31
    img = Image.open(io.BytesIO(data))
    if draft_size and img.format == "JPEG":
        img.draft(image_mode, (2 * draft_size, 2 * draft_size))
    return img.convert(image_mode)


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


class ImageFailure:
    """What `ImageWork` returns where `image_fn` raised on an image it
    decoded: the error, raised again by the stage that ran `image_fn`
    inline, so the sample drops out where it dropped inline."""

    def __init__(self, error: BaseException):
        self.error = error


class ImageWork:
    """A loader worker's part of a sample: `open_image`, then `image_fn`.
    A failed decode raises (the sample drops where decode_sample's map
    drops it); a failed `image_fn` returns an `ImageFailure`."""

    def __init__(self, image_fn: Callable[[Any], Any], image_mode: str = "RGB",
                 draft_size: Optional[int] = None):
        self.image_fn = image_fn
        self.image_mode = image_mode
        self.draft_size = draft_size

    def __call__(self, data: bytes) -> Any:
        img = open_image(data, self.image_mode, self.draft_size)
        try:
            return self.image_fn(img)
        except Exception as e:
            return ImageFailure(e)


# ---- loader workers --------------------------------------------------------
# spawned, as DataLoader's process path is (data/dataloader.py): the parent
# is multithreaded, and Python-side work in a thread would hold the GIL
# against the training step's dispatch. A worker imports PIL, numpy and
# this package's data modules; its `ImageWork` is unpickled once, and a task
# is one sample's image bytes.
_WORK: Optional[ImageWork] = None


def _init_worker(pickled_work: bytes) -> None:
    global _WORK
    _WORK = pickle.loads(pickled_work)


def _work(data: bytes) -> Any:
    return _WORK(data)


_POOLS: "weakref.WeakSet[ProcessPoolExecutor]" = weakref.WeakSet()


def _cancel_pools() -> None:
    """At exit, before concurrent.futures joins its pools: drop the work
    still queued, so the workers stop after what they are running."""
    for pool in list(_POOLS):
        pool.shutdown(wait=False, cancel_futures=True)


# threading's exit hooks run last-registered first, so this one runs before
# the join concurrent.futures registered when it was imported, above
threading._register_atexit(_cancel_pools)


def _spawn_pool(num_workers: int, work: ImageWork) -> ProcessPoolExecutor:
    pool = ProcessPoolExecutor(
        max_workers=num_workers,
        mp_context=multiprocessing.get_context("spawn"),
        initializer=_init_worker, initargs=(pickle.dumps(work),))
    _POOLS.add(pool)
    return pool


def ordered_map(samples: Iterable[Dict[str, Any]], pool: ProcessPoolExecutor,
                work: ImageWork, window: int,
                handler: Callable[[BaseException], bool] = log_and_continue
                ) -> Iterator[Dict[str, Any]]:
    """Each sample with its `image` bytes replaced by `work`'s result, run
    in the pool's workers, in the order the samples came, with up to
    `window` samples in flight; a sample without image bytes passes
    through, one whose decode raised is dropped (`handler`). While the
    oldest sample's image is not back, the calling thread runs `work` on
    the newest sample no worker has started, rather than wait (as when the
    shuffle buffer first fills). Closing the generator, as an abandoned
    iterator's is, cancels the work it still had queued."""
    # [sample, its image's future, whether a worker runs it]
    pending: "collections.deque" = collections.deque()

    def run_here(entry):
        done: Future = Future()
        try:
            done.set_result(work(entry[0]["image"]))
        except Exception as e:
            done.set_exception(e)
        entry[1:] = [done, False]

    def take():
        head = pending[0][1]
        while head is not None and not head.done():
            for entry in reversed(pending):
                if entry[2] and entry[1].cancel():
                    run_here(entry)
                    break
            else:
                break      # every sample left is the workers': wait
        sample, future, in_worker = pending.popleft()
        if future is None:
            return sample
        try:
            image = future.result()
        except BrokenProcessPool:
            raise
        except Exception as e:
            if not handler(e):
                raise
            return None
        (decoded_in_workers if in_worker else decoded_inline).add()
        return {**sample, "image": image}

    try:
        for s in samples:
            data = s.get("image")
            if isinstance(data, bytes):
                pending.append([s, pool.submit(_work, data), True])
            else:
                pending.append([s, None, False])
            if len(pending) >= window:
                out = take()
                if out is not None:
                    yield out
        while pending:
            out = take()
            if out is not None:
                yield out
    finally:
        for _, future, in_worker in pending:
            if in_worker:
                future.cancel()


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

    With `num_workers` >= 1 and a transform split into `image_fn` (PIL image
    -> array) and `finish` (the rest of the sample) whose `image_fn`
    pickles, the decode and `image_fn` run in `num_workers` spawned loader
    processes, in place of the decode stage (`ordered_map`, up to
    `batch_size x prefetch_factor` samples in flight, and at least one a
    worker; the iterating thread takes a share where it would wait), and
    `finish` in place of the transform; the pool lives until `close()` or
    exit. Otherwise every stage runs on the iterating thread.
    The batches are the same either way, and so are the global `random`
    draws a transform makes, since `finish` runs where the transform ran; an
    `image_fn` that draws from a state of its own draws in the worker.
    """

    def __init__(self, shards: Sequence[str], transform: Callable,
                 batch_size: int, filter_strategy: Optional[Mapping] = None,
                 required: Sequence[str] = ("image",),
                 shuffle_buffer: int = 1000, seed: int = 42,
                 drop_last: bool = True, shuffle: bool = True,
                 draft_size: Optional[int] = None, num_workers: int = 0,
                 prefetch_factor: int = 2):
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
        self.num_workers = max(int(num_workers), 0)
        self.window = max(batch_size * max(int(prefetch_factor), 1),
                          self.num_workers)
        self._work = self._image_work()
        self._pool: Optional[ProcessPoolExecutor] = None
        self._epoch = 0

    def _image_work(self) -> Optional[ImageWork]:
        """The workers' part, where it pickles; None where the pipeline
        decodes inline."""
        image_fn = getattr(self.transform, "image_fn", None)
        if self.num_workers < 1 or image_fn is None:
            return None
        work = ImageWork(image_fn, draft_size=self.draft_size)
        try:
            pickle.dumps(work)
        except Exception:  # a lambda or a local function: inline
            return None
        return work

    def _decode_inline(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        out = decode_sample(sample, draft_size=self.draft_size)
        if isinstance(sample.get("image"), bytes):
            decoded_inline.add()
        return out

    def _finish(self, sample: Dict[str, Any]) -> Any:
        image = sample.get("image")
        if isinstance(image, ImageFailure):
            raise image.error
        return self.transform.finish(sample)

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
        if self._work is None:
            samples = map_samples(samples, self._decode_inline)
        else:
            if self._pool is None:
                self._pool = _spawn_pool(self.num_workers, self._work)
            samples = ordered_map(samples, self._pool, self._work,
                                  self.window)
            # json and text; the image is already the worker's array
            samples = map_samples(samples, decode_sample)
        samples = drop_incomplete(samples, self.required)
        samples = filter_samples(samples, self.filter_strategy)
        if self.shuffle:
            samples = sample_shuffle(samples, self.shuffle_buffer,
                                     seed=(self.seed + epoch))
        samples = map_samples(samples, self.transform if self._work is None
                              else self._finish)
        batches = batcher(samples, self.batch_size, self.drop_last)
        return length_sync(batches)

    def close(self) -> None:
        """Shut the loader workers down (idempotent); the next epoch
        spawns them again."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def state_dict(self) -> Dict[str, int]:
        return {"epoch": self._epoch}

    def load_state_dict(self, d: Dict[str, int]) -> None:
        self._epoch = int(d.get("epoch", 0))
