"""Host DataLoader: worker pool, ordered prefetch, collate, resumable epochs.

The port's counterpart of `diffusion_tpu/data/dataloader.py`. One change:
the host's rank and the world size come from `torch.distributed` when
it is initialised, and are 0 and 1 otherwise (JAX reads its process
index and count).

A replacement for the reference's two loader stacks — torch
DataLoader over StreamingDataset (reference: diffusion/datasets/laion/laion
.py:186-194: batch_size/num_workers/prefetch_factor/drop_last/persistent_
workers/pin_memory) and torchdata DataLoader2 with reading services
(reference: wds_datapipe.py:216-238). The loader's job is to keep decoded
numpy batches ready ahead of the copy to the device, which a thread pool +
bounded prefetch queue does; `pin_memory` is accepted and dropped, as the
JAX loader drops it.

`fullsync` (the reference's distributed-divergence barrier, wds_datapipe.py:
220-221) is unnecessary for map-style streaming datasets: every host computes
the same deterministic epoch order and takes a disjoint strided slice, so all
hosts always agree on batch availability by construction. The iterator-style
pipelines (datapipes.py) get an explicit length-sync instead.
"""

from __future__ import annotations

import multiprocessing
import pickle
import queue
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import numpy as np

__all__ = ["DataLoader", "default_collate"]


# ---- process-pool decode workers ------------------------------------------
# JPEG decode under PIL releases the GIL only inside libjpeg; on a busy host
# the Python-side transform/tokenize work serializes a thread pool. The
# reference fans out with *processes* for the same reason (reference
# laion_cloudwriter.py:299-309, torchdata MultiProcessingReadingService,
# wds_datapipe.py:234-237). The dataset is pickled ONCE per worker process
# (initializer), not per sample; work items are bare indices.
_WORKER_DATASET: Any = None


def _init_process_worker(pickled_dataset: bytes) -> None:
    global _WORKER_DATASET
    _WORKER_DATASET = pickle.loads(pickled_dataset)


def _process_getitem(idx: int) -> Dict[str, Any]:
    return _WORKER_DATASET[idx]


def default_collate(samples: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack array-likes; collect scalars into arrays; keep strings as lists."""
    out: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        first = vals[0]
        if isinstance(first, np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(first, (int, float, np.integer, np.floating)):
            out[key] = np.asarray(vals)
        elif isinstance(first, (list, tuple)) and first and \
                isinstance(first[0], (int, float, np.integer, np.floating)):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals
    return out


class DataLoader:
    """Iterates host-local batches of a StreamingDataset-style dataset.

    The dataset must expose __getitem__(global_idx) and
    partition(epoch, rank, world) -> np.ndarray of global indices.
    """

    def __init__(self, dataset: Any, batch_size: int, drop_last: bool = True,
                 num_workers: int = 4, prefetch_factor: int = 2,
                 collate_fn: Optional[Callable] = None,
                 persistent_workers: bool = True, pin_memory: bool = False,
                 worker_type: str = "thread",
                 **_: Any):
        del pin_memory  # dropped, as the JAX loader drops it
        if worker_type == "auto":
            # measured on a 1-core v5e host (assets/input_pipeline_*.json):
            # process fan-out is SLOWER than threads there (56.9 vs 63.4
            # img/s — spawn + pickle overhead with no parallelism to win).
            # With the native JPEG path (csrc/dataio.cpp) the decode
            # releases the GIL, so threads scale across cores too and
            # processes only pay IPC; processes are the fallback for
            # multi-core hosts stuck on pure-Python (PIL) decode.
            from diffusion_torch.data.native import jpeg_native_available
            import os as _os
            multi_core = (_os.cpu_count() or 1) > 1
            worker_type = ("process"
                           if multi_core and not jpeg_native_available()
                           else "thread")
        if worker_type not in ("thread", "process"):
            raise ValueError(
                f"worker_type must be thread|process|auto: {worker_type}")
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.drop_last = drop_last
        self.num_workers = max(int(num_workers), 1)
        self.prefetch_factor = max(int(prefetch_factor), 1)
        self.collate_fn = collate_fn or default_collate
        self.worker_type = worker_type
        # persistent_workers (torch parity, default on): keep ONE worker
        # pool across epochs — a spawn ProcessPoolExecutor pays
        # num_workers x (interpreter spawn + imports + dataset unpickle)
        # at creation, far too much to repeat at every epoch boundary.
        # Safe because __getitem__(idx) is stateless on these datasets.
        self.persistent_workers = bool(persistent_workers)
        self._pool: Any = None
        self._epoch = 0
        self._batch_in_epoch = 0

    def __len__(self) -> int:
        # imported here, not with the module: spawned decode workers import
        # this module to unpickle their dataset, and need no torch
        from diffusion_torch.utils.device import rank_and_world
        world = rank_and_world()[1]
        n = len(self.dataset) // world
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_indices(self) -> np.ndarray:
        from diffusion_torch.utils.device import rank_and_world
        rank, world = rank_and_world()
        ids = self.dataset.partition(self._epoch, rank, world)
        if self.drop_last:
            n = (len(ids) // self.batch_size) * self.batch_size
            ids = ids[:n]
        return ids

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        ids = self._epoch_indices()
        start = self._batch_in_epoch * self.batch_size
        if start and start >= len(ids):  # _epoch_indices pre-truncates drop_last
            # resumed from a checkpoint taken on the epoch's final batch:
            # the epoch rollover below never ran (the checkpoint is written
            # while this generator is suspended at its last yield), so the
            # restored position points past the end — start the next epoch
            # instead of yielding an empty one
            self._epoch += 1
            self._batch_in_epoch = 0
            ids = self._epoch_indices()
            start = 0
        pool = self._pool if self.persistent_workers else None
        if pool is None:
            if self.worker_type == "process":
                # spawn, not fork: the parent is multithreaded (the torch
                # runtime + this prefetcher) and forking it can deadlock in
                # the child
                pool = ProcessPoolExecutor(
                    max_workers=self.num_workers,
                    mp_context=multiprocessing.get_context("spawn"),
                    initializer=_init_process_worker,
                    initargs=(pickle.dumps(self.dataset),))
            else:
                pool = ThreadPoolExecutor(max_workers=self.num_workers)
            if self.persistent_workers:
                self._pool = pool
        if self.worker_type == "process":
            submit = lambda i: pool.submit(_process_getitem, i)  # noqa: E731
        else:
            submit = lambda i: pool.submit(  # noqa: E731
                self.dataset.__getitem__, i)
        try:
            window = self.batch_size * self.prefetch_factor
            futures: "queue.Queue" = queue.Queue()
            pos = start
            ahead = start

            def submit_upto(limit):
                nonlocal ahead
                while ahead < min(limit, len(ids)):
                    futures.put(submit(int(ids[ahead])))
                    ahead += 1

            submit_upto(start + window + self.batch_size)
            while pos + self.batch_size <= len(ids) or (
                    not self.drop_last and pos < len(ids)):
                take = min(self.batch_size, len(ids) - pos)
                samples = [futures.get().result() for _ in range(take)]
                pos += take
                submit_upto(pos + window + self.batch_size)
                self._batch_in_epoch += 1
                yield self.collate_fn(samples)
            self._epoch += 1
            self._batch_in_epoch = 0
        finally:
            if pool is self._pool:
                # persistent pool: cancel what this (possibly abandoned)
                # epoch still has queued, keep the workers for the next one
                while not futures.empty():
                    futures.get_nowait().cancel()
            else:
                pool.shutdown(wait=False, cancel_futures=True)

    def close(self) -> None:
        """Shut down a persistent worker pool (idempotent)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def __del__(self):  # best-effort; close() is the real API
        try:
            self.close()
        except Exception:
            pass

    # ---- loader-position checkpointing (Composer autoresume parity) -----
    def state_dict(self) -> Dict[str, int]:
        return {"epoch": self._epoch, "batch_in_epoch": self._batch_in_epoch}

    def load_state_dict(self, d: Dict[str, int]) -> None:
        self._epoch = int(d.get("epoch", 0))
        self._batch_in_epoch = int(d.get("batch_in_epoch", 0))
