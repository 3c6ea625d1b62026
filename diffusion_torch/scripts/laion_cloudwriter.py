#!/usr/bin/env python
"""Long-running parquet -> MDS converter with resolution bucketing and
cloud upload.

A copy of `scripts/laion_cloudwriter.py`, which imports no jax, over the
port's `MDSWriter` (`diffusion_torch/data/mds.py`): the port imports
nothing of the JAX package. It polls a download directory for parquet
shards whose img2dataset `*_stats.json` marks them complete, decodes and
validates every image, writes MDS samples with the LAION metadata columns,
routes each sample to a resolution bucket [0,64,128,256,512,768,1024,inf)
with one writer per bucket and one background uploader per bucket
streaming finished shards to the remote, deletes consumed parquets once
their samples are durable (`--remove-consumed`), and reports progress
(stdout and, with `--wandb`, wandb). The shards are byte for byte the JAX
script's.

Decode/validation fans out over a thread pool (PIL releases the GIL in
decode); each bucket's MDSWriter uploads its shards on its own background
threads, so conversion, upload, and polling overlap. `pyarrow` is imported
only when the script runs.

  python -m diffusion_torch.scripts.laion_cloudwriter \\
      --download-dir <img2dataset output> --out <mds root> [--remote URL] \\
      [--one-shot] [--remove-consumed]
"""

from __future__ import annotations

import argparse
import glob
import io
import os
import time
from concurrent.futures import ThreadPoolExecutor

from diffusion_torch.data.mds import MDSWriter

BUCKETS = [0, 64, 128, 256, 512, 768, 1024]

COLUMNS = {
    "jpg": "bytes", "caption": "str", "url": "str", "key": "str",
    "width": "int", "height": "int", "original_width": "int",
    "original_height": "int", "status": "str", "error_message": "str",
    "exif": "str", "similarity": "str", "punsafe": "str", "pwatermark": "str",
    "aesthetic": "str", "hash": "str",
}


def bucket_of(width: int, height: int) -> int:
    side = min(width or 0, height or 0)
    b = 0
    for i, lo in enumerate(BUCKETS):
        if side >= lo:
            b = i
    return BUCKETS[b]


def completed_parquets(download_dir: str) -> list:
    """Parquet shards whose img2dataset stats sidecar exists (ref :78-98)."""
    done = []
    for stats in sorted(glob.glob(os.path.join(download_dir, "*_stats.json"))):
        pq = stats.replace("_stats.json", ".parquet")
        if os.path.exists(pq):
            done.append(pq)
    return done


def decode_row(row: dict):
    """Validate one row's image; -> (sample, bucket) or None (ref :166-175)."""
    from PIL import Image

    data = row.get("jpg") or row.get("image")
    if not data:
        return None
    try:
        img = Image.open(io.BytesIO(data))
        img.verify()
        w, h = img.size
    except Exception:
        return None
    sample = {k: "" for k in COLUMNS}
    sample.update({
        "jpg": data,
        "caption": str(row.get("caption") or ""),
        "url": str(row.get("url") or ""),
        "key": str(row.get("key") or ""),
        "width": int(w), "height": int(h),
        "original_width": int(row.get("original_width") or w),
        "original_height": int(row.get("original_height") or h),
        "status": str(row.get("status") or "ok"),
        "error_message": str(row.get("error_message") or ""),
        "exif": str(row.get("exif") or ""),
        "similarity": str(row.get("similarity") or ""),
        "punsafe": str(row.get("punsafe") or ""),
        "pwatermark": str(row.get("pwatermark") or ""),
        "aesthetic": str(row.get("AESTHETIC_SCORE")
                         or row.get("aesthetic") or ""),
        "hash": str(row.get("hash") or ""),
    })
    return sample, bucket_of(w, h)


def _durable_then_remove(writers: dict, pending: list) -> None:
    """Flush every bucket writer (disk + remote uploads drained), then and
    only then delete the consumed source parquets."""
    for w in writers.values():
        w.flush()
    _remove_parquets(pending)


def _remove_parquets(pending: list) -> None:
    for parquet in pending:
        if os.path.exists(parquet):
            os.remove(parquet)
        stats = parquet.replace(".parquet", "_stats.json")
        if os.path.exists(stats):
            os.remove(stats)
    pending.clear()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    p.add_argument("--download-dir", required=True)
    p.add_argument("--out", required=True, help="local output root; per-bucket subdirs")
    p.add_argument("--remote", default=None,
                   help="remote root (s3://, gs://, or path); shards upload "
                        "per bucket in the background as they complete")
    p.add_argument("--keep-local", action="store_true",
                   help="with --remote: keep local shard copies after upload")
    p.add_argument("--poll-interval", type=float, default=30.0)
    p.add_argument("--decode-workers", type=int, default=8)
    p.add_argument("--remove-consumed", action="store_true",
                   help="delete source parquets once their samples are "
                        "DURABLE (flushed to disk and, with --remote, "
                        "uploaded) — deletion waits for the next "
                        "--flush-every durability barrier, matching the "
                        "reference's remove-after-all-buckets-finished "
                        "semantics (ref :254-287)")
    p.add_argument("--flush-every", type=int, default=10,
                   help="parquets between durability barriers (writer "
                        "flush + upload drain) when --remove-consumed")
    p.add_argument("--one-shot", action="store_true",
                   help="convert what exists and exit (no polling)")
    p.add_argument("--wandb", action="store_true",
                   help="log progress to wandb (reference parity; no-op if "
                        "wandb is unavailable)")
    args = p.parse_args(argv)

    import pyarrow.parquet as pq

    wandb_run = None
    if args.wandb:
        try:
            import wandb
            wandb_run = wandb.init(project="laion-cloudwriter")
        except Exception:
            print("wandb unavailable; progress to stdout only")

    writers = {}
    for lo in BUCKETS:
        local = os.path.join(args.out, f"bucket_{lo}")
        out = local if args.remote is None else \
            (local, f"{args.remote.rstrip('/')}/bucket_{lo}")
        writers[lo] = MDSWriter(out, COLUMNS,
                                keep_local=args.keep_local or not args.remote)

    consumed = set()
    pending_removal: list = []
    totals = {"parquets": 0, "samples": 0, "rejected": 0}
    pool = ThreadPoolExecutor(max_workers=max(args.decode_workers, 1))
    t_start = time.time()
    try:
        while True:
            new = [f for f in completed_parquets(args.download_dir)
                   if f not in consumed]
            for parquet in new:
                rows = pq.read_table(parquet).to_pylist()
                n_ok = 0
                # decode/validate in parallel; write in arrival order
                for decoded in pool.map(decode_row, rows):
                    if decoded is None:
                        totals["rejected"] += 1
                        continue
                    sample, bucket = decoded
                    writers[bucket].write(sample)
                    n_ok += 1
                consumed.add(parquet)
                totals["parquets"] += 1
                totals["samples"] += n_ok
                rate = totals["samples"] / max(time.time() - t_start, 1e-9)
                progress = {**totals, "samples_per_sec": round(rate, 1)}
                print(f"converted {parquet}: {n_ok}/{len(rows)} samples "
                      f"| {progress}")
                if wandb_run is not None:
                    wandb_run.log(progress)
                if args.remove_consumed:  # ref :254-287 remover process
                    # deletion is DEFERRED to the next durability barrier:
                    # right here these samples may exist only in MDSWriter's
                    # in-memory buffer (and un-uploaded local shards) — a
                    # crash would lose them with the source already gone
                    pending_removal.append(parquet)
                if len(pending_removal) >= args.flush_every:
                    _durable_then_remove(writers, pending_removal)
            if args.one_shot:
                break
            time.sleep(args.poll_interval)
    finally:
        errors = []
        for lo, w in writers.items():
            # one bucket's failed upload must not abort the other buckets'
            # final flush (their buffered samples would be dropped)
            try:
                w.finish()
            except Exception as e:  # noqa: BLE001 - collected and re-raised
                errors.append((lo, e))
        pool.shutdown(wait=True)
        if wandb_run is not None:
            wandb_run.finish()
        if errors:
            raise RuntimeError(
                f"bucket writer finish() failed for {[lo for lo, _ in errors]}"
            ) from errors[0][1]
        # every sample is durable now — safe to drop remaining sources
        _remove_parquets(pending_removal)


if __name__ == "__main__":
    main()
