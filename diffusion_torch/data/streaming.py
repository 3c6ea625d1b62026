"""Streaming sharded dataset: remote shards, cache, deterministic shuffle,

A copy of `diffusion_tpu/data/streaming.py`, which imports no jax, with its
imports pointed at the port's modules: the port imports nothing of
the JAX package.
per-host partition, resumable position.

A replacement for the `mosaicml-streaming` StreamingDataset layer the
reference relies on (reference: diffusion/datasets/laion/laion.py:43-74 —
remote/local Stream pairs, predownload/download_retry/download_timeout/
num_canonical_nodes knobs, deterministic global shuffle, per-rank partition;
SURVEY.md §2.2). Differences are intentional simplifications, documented here:

- Shuffle algorithm: shards are assigned round-robin to `num_canonical_nodes`
  groups; per epoch, a PRNG seeded by (shuffle_seed, epoch) permutes each
  group's shard order and each shard's sample order, then node streams are
  interleaved sample-by-sample. This has streaming's two key properties —
  determinism given (seed, epoch) and shard-locality of reads — without its
  exact permutation (we do not need bit-compat resumption with the reference).
- Partition: the epoch order is padded (leading samples repeated) to a
  multiple of R, then rank r of R takes every R-th sample -> complete,
  EQUAL-LENGTH per rank (a multi-host liveness requirement), disjoint
  except for the <R padding repeats.
- Resumption lives on the DataLoader (dataloader.py state_dict/
  load_state_dict: epoch + batch position), which the Trainer checkpoints.

Downloads happen lazily per shard with retry/timeout semantics matching the
reference's knobs. The reference's `predownload` (samples fetched ahead of
the consumer) is realized by the DataLoader's ordered prefetch window
(data/dataloader.py: the worker pool stays `prefetch_factor x batch_size`
samples ahead, which pulls upcoming shards through the object store before
the consumer reaches them); the knob is accepted for config parity.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from diffusion_torch.data.mds import MDSIndex, MDSShardReader
from diffusion_torch.data.object_store import ObjectStore

__all__ = ["Stream", "StreamingDataset"]


def _has_distinct_remote(stream: "Stream") -> bool:
    """True when the stream can re-fetch data from somewhere other than its
    local dir (bucket URI, or a genuinely different directory — compared by
    abspath so './data' vs 'data' doesn't count as a second copy)."""
    if not stream.remote:
        return False
    if stream.remote.startswith(("s3://", "gs://")):
        return True
    return os.path.abspath(stream.remote) != os.path.abspath(stream.local)


class Stream:
    """(remote, local) shard source (streaming.Stream parity)."""

    def __init__(self, remote: Optional[str] = None, local: Optional[str] = None,
                 proportion: Optional[float] = None):
        if remote is None and local is None:
            raise ValueError("Stream needs remote and/or local")
        if proportion is not None:
            # honesty over silent acceptance: the streaming reader walks
            # every stream's full epoch uniformly — proportion-weighted
            # epochs are served by the weighted mixer (data/mix.py
            # build_mix_dataloader weight=...), not here
            raise ValueError(
                "Stream(proportion=...) is not supported by this reader; "
                "mix weighted sources with data/mix.py instead")
        self.remote = remote
        if local is None and remote and remote.startswith(("s3://", "gs://")):
            # a bucket URI is not a filesystem path — cache under a
            # deterministic tmp dir instead of creating './s3:/bucket/...'
            import hashlib
            import tempfile
            key = hashlib.sha1(remote.encode()).hexdigest()[:12]
            local = os.path.join(tempfile.gettempdir(),
                                 "diffusion_torch_streams", key)
        self.local = local or remote

    def ensure_index(self, store: ObjectStore) -> str:
        """Make sure index.json exists locally; returns the local dir."""
        local_index = os.path.join(self.local, "index.json")
        if not os.path.exists(local_index):
            if not self.remote:
                raise FileNotFoundError(local_index)
            store.download(os.path.join(self.remote, "index.json"), local_index)
        return self.local

    def shard_path(self, basename: str, store: ObjectStore) -> str:
        path = os.path.join(self.local, basename)
        if not os.path.exists(path) and self.remote:
            store.download(os.path.join(self.remote, basename), path)
        return path


class StreamingDataset:
    """Map-style dataset over MDS streams with deterministic epoch ordering."""

    def __init__(self,
                 streams: Optional[Sequence[Stream]] = None,
                 remote: Optional[str] = None,
                 local: Optional[str] = None,
                 split: Optional[str] = None,
                 shuffle: bool = False,
                 shuffle_seed: int = 9176,
                 num_canonical_nodes: Optional[int] = None,
                 predownload: Optional[int] = None,
                 download_retry: int = 2,
                 download_timeout: float = 120.0,
                 validate_hash: Optional[str] = None,
                 keep_zip: bool = False,
                 batch_size: Optional[int] = None,
                 **_: Any):
        if streams is None:
            if remote is None and local is None:
                raise ValueError("need streams or remote/local")
            streams = [Stream(remote, local)]
        if split:
            streams = [Stream(s.remote and os.path.join(s.remote, split),
                              s.local and os.path.join(s.local, split))
                       for s in streams]
        self.streams = list(streams)
        self.shuffle = shuffle
        self.shuffle_seed = shuffle_seed
        self.num_canonical_nodes = num_canonical_nodes
        self.predownload = predownload
        self.validate_hash = validate_hash
        self.keep_zip = keep_zip
        self.batch_size = batch_size
        self.store = ObjectStore(download_retry, download_timeout)

        self._indexes: List[MDSIndex] = []
        self._shard_infos: List[Tuple[int, int]] = []  # (stream_idx, shard_idx)
        self._shard_cum: List[int] = [0]
        for si, stream in enumerate(self.streams):
            local_dir = stream.ensure_index(self.store)
            index = MDSIndex(local_dir)
            self._indexes.append(index)
            for shard_idx in range(len(index.shards)):
                self._shard_infos.append((si, shard_idx))
                self._shard_cum.append(self._shard_cum[-1]
                                       + index.samples_per_shard[shard_idx])
        self.num_samples = self._shard_cum[-1]
        self._readers: Dict[int, MDSShardReader] = {}
        self._lock = threading.Lock()

    # ---- sample access -------------------------------------------------
    def _reader(self, flat_shard: int) -> MDSShardReader:
        with self._lock:
            reader = self._readers.get(flat_shard)
        if reader is not None:
            return reader
        si, shard_idx = self._shard_infos[flat_shard]
        stream, index = self.streams[si], self._indexes[si]
        info = index.shards[shard_idx]
        path = self._materialize_raw(info, stream)
        if self.validate_hash:
            self._check_hash(path, info, stream)
        reader = MDSShardReader.from_shard_info(os.path.dirname(path), info)
        with self._lock:
            self._readers[flat_shard] = reader
        return reader

    def _materialize_raw(self, info: Dict[str, Any], stream: Stream) -> str:
        """Local path of the shard's RAW file, downloading (and, for
        compressed datasets, decompressing — mosaicml ships the zip and
        readers inflate on demand) as needed. The inflated file lands via
        tmp+rename so concurrent readers never map a partial shard; the zip
        is removed after inflation unless keep_zip (there is no re-use for
        it locally — the remote keeps the canonical copy)."""
        raw_base = info["raw_data"]["basename"]
        raw_path = os.path.join(stream.local, raw_base)
        if os.path.exists(raw_path):
            return raw_path
        if not info.get("compression"):
            return stream.shard_path(raw_base, self.store)
        from diffusion_torch.data.mds import decompress_bytes
        zip_path = stream.shard_path(info["zip_data"]["basename"], self.store)
        with open(zip_path, "rb") as f:
            raw = decompress_bytes(info["compression"], f.read())
        if len(raw) != info["raw_data"]["bytes"]:
            raise ValueError(
                f"{zip_path}: inflated to {len(raw)} bytes, index says "
                f"{info['raw_data']['bytes']} (corrupt shard)")
        # unique tmp per call: two threads inflating the same shard must
        # not truncate each other's in-flight copy; each publishes a
        # complete file atomically and the last replace wins
        import uuid
        tmp = f"{raw_path}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp"
        with open(tmp, "wb") as f:
            f.write(raw)
        os.replace(tmp, raw_path)
        # keep the zip when it is the only source (local-only stream) —
        # deleting it would make the raw file unrecoverable after a release
        if not self.keep_zip and _has_distinct_remote(stream):
            try:
                os.remove(zip_path)
            except OSError:
                pass
        return raw_path

    def _check_hash(self, path: str, info: Dict[str, Any],
                    stream: Stream) -> None:
        """Verify the shard against its recorded hash (mosaicml-streaming's
        `validate_hash`; reference laion.py:71 exposes the knob). A corrupt
        local copy is deleted and re-downloaded ONCE — disk bit-rot or a
        truncated earlier download heals itself; a corrupt REMOTE raises."""
        import hashlib
        alg = self.validate_hash
        want = info["raw_data"].get("hashes", {}).get(alg)
        if want is None:
            raise ValueError(
                f"shard {info['raw_data']['basename']} records no {alg!r} "
                f"hash; rewrite the dataset with MDSWriter(hashes=({alg!r},))")

        def digest() -> str:
            h = hashlib.new(alg)
            with open(path, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
            return h.hexdigest()

        if digest() == want:
            return
        if _has_distinct_remote(stream):
            os.remove(path)
            if info.get("compression") and info.get("zip_data"):
                zip_path = os.path.join(stream.local,
                                        info["zip_data"]["basename"])
                if os.path.exists(zip_path):
                    os.remove(zip_path)  # the zip may be the corrupt one
            self._materialize_raw(info, stream)
            if digest() == want:
                return
        raise ValueError(
            f"shard {path} failed {alg} validation (corrupt data)")

    def get_sample(self, global_idx: int) -> Dict[str, Any]:
        flat = int(np.searchsorted(self._shard_cum, global_idx, side="right") - 1)
        local = global_idx - self._shard_cum[flat]
        return self._reader(flat).get(local)

    def flat_shard_of(self, global_idx: int) -> int:
        """Flat shard index holding a global sample index."""
        return int(np.searchsorted(self._shard_cum, global_idx, side="right") - 1)

    def release_shard(self, flat_shard: int) -> bool:
        """Delete the local cached copy of a fully-consumed shard (the
        reference's incremental input-shard deletion during latent precompute,
        reference precompute_latents.py:335-351). Refuses when the local dir
        IS the source of truth (no remote to re-download from). Returns
        whether a file was removed; the shard re-downloads transparently if
        accessed again."""
        si, shard_idx = self._shard_infos[flat_shard]
        stream, index = self.streams[si], self._indexes[si]
        if not _has_distinct_remote(stream):
            return False
        with self._lock:
            self._readers.pop(flat_shard, None)
        info = index.shards[shard_idx]
        removed = False
        names = [info["raw_data"]["basename"]]
        if info.get("zip_data"):
            names.append(info["zip_data"]["basename"])
        for name in names:
            path = os.path.join(stream.local, name)
            if os.path.exists(path):
                os.remove(path)
                removed = True
        return removed

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        sample = self.get_sample(idx)
        return self.process_sample(sample)

    def process_sample(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        """Subclasses decode/transform here."""
        return sample

    # ---- deterministic epoch order --------------------------------------
    def epoch_order(self, epoch: int) -> np.ndarray:
        n_shards = len(self._shard_infos)
        if not self.shuffle:
            return np.arange(self.num_samples, dtype=np.int64)
        nodes = max(int(self.num_canonical_nodes or 1), 1)
        rng = np.random.default_rng([self.shuffle_seed, epoch])
        node_shards: List[List[int]] = [[] for _ in range(nodes)]
        for s in range(n_shards):
            node_shards[s % nodes].append(s)
        node_orders: List[np.ndarray] = []
        for node in range(nodes):
            shards = np.asarray(node_shards[node], dtype=np.int64)
            rng.shuffle(shards)
            parts = []
            for s in shards:
                lo, hi = self._shard_cum[s], self._shard_cum[s + 1]
                ids = np.arange(lo, hi, dtype=np.int64)
                rng.shuffle(ids)
                parts.append(ids)
            node_orders.append(np.concatenate(parts) if parts
                               else np.empty(0, np.int64))
        if nodes == 1:
            return node_orders[0]
        # interleave node streams sample-by-sample
        longest = max(len(o) for o in node_orders)
        out = np.full((longest, nodes), -1, dtype=np.int64)
        for i, o in enumerate(node_orders):
            out[:len(o), i] = o
        flat = out.reshape(-1)
        return flat[flat >= 0]

    def partition(self, epoch: int, rank: int, world: int) -> np.ndarray:
        """Equal-length, complete split of the epoch order across ranks.

        Every rank gets EXACTLY ceil(n/world) samples — when world doesn't
        divide n, the first (padded - n) samples of the epoch order are
        repeated (mosaicml-streaming's padding semantics). Equal lengths are
        a hard multi-host requirement: each host's Trainer iterates its own
        loader until exhaustion, so one rank holding one extra batch would
        dispatch a train step whose cross-host collectives never complete —
        the pod deadlocks at the epoch boundary. Disjoint except for those
        <world repeated samples."""
        order = self.epoch_order(epoch)
        per_rank = max(-(-len(order) // world), 1)
        padded = per_rank * world
        if padded != len(order):
            reps = -(-padded // max(len(order), 1))
            order = np.tile(order, reps)[:padded]
        return order[rank::world]

    # ---- pickling (process-pool decode workers) --------------------------
    def __getstate__(self) -> Dict[str, Any]:
        # drop per-process resources: open shard memmaps and the lock; the
        # child lazily reopens readers on first access
        state = self.__dict__.copy()
        state["_readers"] = {}
        state.pop("_lock", None)
        return state

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state)
        self._lock = threading.Lock()


