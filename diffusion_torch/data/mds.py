"""MDS shard format: reader + writer (mosaicml-streaming wire-compatible).

A copy of `diffusion_tpu/data/mds.py`, which imports no jax, with its
imports pointed at the port's modules: the port imports nothing of
the JAX package.

A replacement for the `mosaicml-streaming` dependency's on-disk
format, which every reference dataset reads and every reference tool writes
(reference: diffusion/datasets/laion/laion.py:12 StreamingDataset,
scripts/laion_cloudwriter.py:230-235 MDSWriter with 16 columns,
scripts/convert_coco.py:55-61, scripts/precompute_latents.py:302-328).

Layout per shard file:
  u32 num_samples
  u32[num_samples+1] absolute byte offsets of each sample (offsets[0] points
      just past this header)
  sample blobs back to back

Per sample: u32 sizes for each variable-length column (column_sizes null in
the index), then each column's raw bytes in column order. `index.json` at the
dataset root lists shards with column names/encodings/sizes and raw byte
counts.

Supported encodings: bytes, str, int, jpeg, png, pil, json, npy16/npy32
(raw little-endian arrays; the reference stores fp16 latents as raw bytes).
"""

from __future__ import annotations

import io
import json
import os
import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = ["MDSWriter", "MDSShardReader", "MDSIndex", "decode_value",
           "encode_value", "compress_bytes", "decompress_bytes",
           "compression_suffix"]

_U32 = struct.Struct("<I")
_I64 = struct.Struct("<q")


def _parse_compression(spec: str) -> Tuple[str, Optional[int]]:
    name, _, level = spec.partition(":")
    return name, (int(level) if level else None)


def compression_suffix(spec: str) -> str:
    """File suffix for a compression spec ('zstd:7' -> '.zstd'), matching
    mosaicml-streaming's shard naming."""
    return "." + _parse_compression(spec)[0]


def compress_bytes(spec: str, data: bytes) -> bytes:
    name, level = _parse_compression(spec)
    if name == "zstd":
        import zstandard
        return zstandard.ZstdCompressor(level=level or 3).compress(data)
    if name == "gz":
        import gzip
        return gzip.compress(data, compresslevel=level or 9)
    if name == "bz2":
        import bz2
        return bz2.compress(data, compresslevel=level or 9)
    raise ValueError(f"unsupported compression {spec!r} (zstd/gz/bz2)")


def decompress_bytes(spec: str, data: bytes) -> bytes:
    name, _ = _parse_compression(spec)
    if name == "zstd":
        import zstandard
        return zstandard.ZstdDecompressor().decompress(data)
    if name == "gz":
        import gzip
        return gzip.decompress(data)
    if name == "bz2":
        import bz2
        return bz2.decompress(data)
    raise ValueError(f"unsupported compression {spec!r} (zstd/gz/bz2)")


def encode_value(encoding: str, value: Any) -> bytes:
    if encoding == "bytes":
        return bytes(value)
    if encoding in ("jpeg", "png", "pil"):
        if isinstance(value, (bytes, bytearray)):
            return bytes(value)
        buf = io.BytesIO()  # a PIL image
        value.save(buf, format="JPEG" if encoding == "jpeg" else "PNG")
        return buf.getvalue()
    if encoding == "str":
        return str(value).encode("utf-8")
    if encoding == "int":
        return _I64.pack(int(value))
    if encoding == "json":
        return json.dumps(value).encode("utf-8")
    if encoding.startswith("npy"):
        return np.ascontiguousarray(value).tobytes()
    raise ValueError(f"unknown MDS encoding {encoding!r}")


def decode_value(encoding: str, data: bytes) -> Any:
    if encoding == "bytes":
        return data
    if encoding in ("jpeg", "png", "pil"):
        return data  # callers decode pixels themselves (datasets do PIL.open)
    if encoding == "str":
        return data.decode("utf-8")
    if encoding == "int":
        return _I64.unpack(data)[0]
    if encoding == "json":
        return json.loads(data.decode("utf-8"))
    if encoding.startswith("npy"):
        return data
    raise ValueError(f"unknown MDS encoding {encoding!r}")


class MDSWriter:
    """Sharded dataset writer (MDSWriter parity: `columns` dict of
    name->encoding, `size_limit` bytes per shard, context-manager protocol).

    `out` may also be a `(local, remote)` pair — shards then stream to the
    remote (s3://, gs://, or path) in a background thread as each one
    completes, the way the reference cloudwriter targets buckets directly
    (reference scripts/laion_cloudwriter.py:230-235); `keep_local=False`
    deletes each local shard after its upload lands."""

    def __init__(self, out: Union[str, Sequence[str]], columns: Dict[str, str],
                 size_limit: int = 1 << 26, compression: Optional[str] = None,
                 hashes: Sequence[str] = (), keep_local: bool = True,
                 **_: Any):
        if compression:
            compress_bytes(compression, b"")  # validate the spec up front
        self.compression = compression or None
        for h in hashes:
            if h not in ("sha1", "md5"):
                raise ValueError(f"unsupported hash {h!r} (sha1/md5)")
        self.hashes = tuple(hashes)
        self.remote: Optional[str] = None
        if not isinstance(out, str):
            out, self.remote = out
        self.out = out
        self.keep_local = keep_local
        self._uploads: List[Any] = []
        self._pool = None
        if self.remote:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(max_workers=4,
                                            thread_name_prefix="mds-upload")
        os.makedirs(out, exist_ok=True)
        self.column_names = sorted(columns)  # deterministic column order
        self.column_encodings = [columns[c] for c in self.column_names]
        self.size_limit = size_limit
        self._samples: List[bytes] = []
        self._bytes = 0
        self._shards: List[dict] = []
        # remote index refresh cadence (shards between re-uploads)
        self.index_upload_interval = 8
        self._shards_since_index = 0

    def write(self, sample: Dict[str, Any]) -> None:
        var_sizes: List[int] = []
        blobs: List[bytes] = []
        for name, enc in zip(self.column_names, self.column_encodings):
            blob = encode_value(enc, sample[name])
            blobs.append(blob)
            var_sizes.append(len(blob))
        payload = b"".join(_U32.pack(s) for s in var_sizes) + b"".join(blobs)
        self._samples.append(payload)
        self._bytes += len(payload)
        if self._bytes >= self.size_limit:
            self._flush_shard()

    def _flush_shard(self) -> None:
        if not self._samples:
            return
        n = len(self._samples)
        header_size = 4 + 4 * (n + 1)
        offsets = [header_size]
        for blob in self._samples:
            offsets.append(offsets[-1] + len(blob))
        basename = f"shard.{len(self._shards):05}.mds"
        path = os.path.join(self.out, basename)
        with open(path, "wb") as f:
            f.write(_U32.pack(n))
            f.write(b"".join(_U32.pack(o) for o in offsets))
            for blob in self._samples:
                f.write(blob)
        def _digests(p: str) -> Dict[str, str]:
            if not self.hashes:
                return {}
            import hashlib
            with open(p, "rb") as f:
                data = f.read()
            return {h: hashlib.new(h, data).hexdigest() for h in self.hashes}

        raw_entry = {"basename": basename, "bytes": os.path.getsize(path),
                     "hashes": _digests(path)}
        zip_entry = None
        upload_basename = basename
        if self.compression:
            # mosaicml behavior: ship the compressed file, drop the raw —
            # readers decompress on demand (streaming.py _reader)
            zip_base = basename + compression_suffix(self.compression)
            zip_path = os.path.join(self.out, zip_base)
            with open(path, "rb") as f:
                blob = compress_bytes(self.compression, f.read())
            with open(zip_path, "wb") as f:
                f.write(blob)
            os.remove(path)
            zip_entry = {"basename": zip_base, "bytes": len(blob),
                         "hashes": _digests(zip_path)}
            upload_basename = zip_base
        self._shards.append({
            "column_encodings": list(self.column_encodings),
            "column_names": list(self.column_names),
            "column_sizes": [None] * len(self.column_names),
            "compression": self.compression,
            "format": "mds",
            "hashes": list(self.hashes),
            "raw_data": raw_entry,
            "samples": n,
            "size_limit": self.size_limit,
            "version": 2,
            "zip_data": zip_entry,
        })
        self._samples, self._bytes = [], 0
        if self._pool is not None:
            self._uploads.append(
                self._pool.submit(self._upload, upload_basename))
            # drain finished uploads NOW so a failed upload surfaces on the
            # next shard, not days later at finish(); and refresh the
            # remote index every few shards so a crash mid-run still
            # leaves a loadable (if slightly stale) remote dataset
            pending = []
            for fut in self._uploads:
                if fut.done():
                    fut.result()  # raises if the upload failed
                else:
                    pending.append(fut)
            self._uploads = pending
            self._shards_since_index += 1
            if self._shards_since_index >= self.index_upload_interval:
                self._shards_since_index = 0
                self._write_index()
                # upload a per-refresh SNAPSHOT: a queued upload must never
                # read index.json while a later refresh truncates/rewrites
                # it (the remote would receive a partial JSON)
                snap = f".index.{len(self._shards):05}.json"
                self._write_index(snap)
                self._uploads.append(
                    self._pool.submit(self._upload_index_snapshot, snap))

    def _upload(self, basename: str) -> None:
        from diffusion_torch.data.object_store import ObjectStore
        local = os.path.join(self.out, basename)
        ObjectStore().upload(local, f"{self.remote.rstrip('/')}/{basename}")
        if not self.keep_local and basename != "index.json":
            os.remove(local)

    def _upload_index_snapshot(self, basename: str) -> None:
        from diffusion_torch.data.object_store import ObjectStore
        local = os.path.join(self.out, basename)
        ObjectStore().upload(local, f"{self.remote.rstrip('/')}/index.json")
        os.remove(local)

    def _write_index(self, basename: str = "index.json") -> None:
        with open(os.path.join(self.out, basename), "w") as f:
            json.dump({"version": 2, "shards": self._shards}, f)

    def flush(self) -> None:
        """Durability barrier: flush buffered samples into a shard, refresh
        index.json, and WAIT for every queued upload (raising on failure).
        After flush() returns, everything written so far is durable on disk
        and (if remote) in the bucket — the point at which a long-running
        converter may safely delete its consumed inputs. Forcing the
        partial buffer out makes one undersized shard per call, so call at
        batch boundaries, not per sample."""
        self._flush_shard()
        self._write_index()
        if self._pool is not None:
            for fut in self._uploads:
                fut.result()
            self._uploads = []
            self._upload("index.json")

    def finish(self) -> None:
        self.flush()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __enter__(self) -> "MDSWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.finish()


class MDSIndex:
    """Parsed index.json: shard list with cumulative sample offsets."""

    def __init__(self, dirname: str):
        with open(os.path.join(dirname, "index.json")) as f:
            index = json.load(f)
        self.dirname = dirname
        self.shards = index["shards"]
        self.samples_per_shard = [int(s["samples"]) for s in self.shards]
        self.cumulative = np.concatenate(
            [[0], np.cumsum(self.samples_per_shard)]).astype(np.int64)
        self.num_samples = int(self.cumulative[-1])

    def locate(self, idx: int) -> Tuple[int, int]:
        """global sample idx -> (shard_idx, local_idx)"""
        shard = int(np.searchsorted(self.cumulative, idx, side="right") - 1)
        return shard, idx - int(self.cumulative[shard])

    def shard_basename(self, shard_idx: int) -> str:
        return self.shards[shard_idx]["raw_data"]["basename"]


class MDSShardReader:
    """Random access into one shard file (mmap-backed)."""

    def __init__(self, path: str, column_names: Sequence[str],
                 column_encodings: Sequence[str],
                 column_sizes: Optional[Sequence[Optional[int]]] = None):
        self.path = path
        self.column_names = list(column_names)
        self.column_encodings = list(column_encodings)
        self.column_sizes = list(column_sizes or [None] * len(column_names))
        self._data = np.memmap(path, dtype=np.uint8, mode="r")
        self.num_samples = int(_U32.unpack(self._data[:4].tobytes())[0])
        off_bytes = self._data[4:4 + 4 * (self.num_samples + 1)].tobytes()
        self.offsets = np.frombuffer(off_bytes, dtype=np.uint32)

    @classmethod
    def from_shard_info(cls, dirname: str, info: dict) -> "MDSShardReader":
        return cls(os.path.join(dirname, info["raw_data"]["basename"]),
                   info["column_names"], info["column_encodings"],
                   info.get("column_sizes"))

    def get_raw(self, idx: int) -> Dict[str, bytes]:
        lo, hi = int(self.offsets[idx]), int(self.offsets[idx + 1])
        blob = self._data[lo:hi].tobytes()
        n_var = sum(1 for s in self.column_sizes if s is None)
        sizes: List[int] = []
        pos = 0
        var_sizes = list(struct.unpack(f"<{n_var}I", blob[:4 * n_var]))
        pos = 4 * n_var
        out: Dict[str, bytes] = {}
        vi = 0
        for name, fixed in zip(self.column_names, self.column_sizes):
            size = fixed if fixed is not None else var_sizes[vi]
            if fixed is None:
                vi += 1
            out[name] = blob[pos:pos + size]
            pos += size
        return out

    def get(self, idx: int) -> Dict[str, Any]:
        raw = self.get_raw(idx)
        return {name: decode_value(enc, raw[name])
                for name, enc in zip(self.column_names, self.column_encodings)}

    def __len__(self) -> int:
        return self.num_samples
