"""Object-store access with exponential-backoff retry.

A copy of `diffusion_tpu/data/object_store.py`, which imports no jax, with its
imports pointed at the port's modules: the port imports nothing of
the JAX package.

The equivalent of the reference's petrel_client S3 access wrapped in
`backoff.on_exception` (reference: diffusion/datasets/pexels/pexels_datapipe
.py:40-69 `client.get(..., enable_stream=True)` with x3 exponential retry;
wds_datapipe.py:13,195). Supports local paths out of the box; s3:// and gs://
are gated behind optional clients (boto3 / google-cloud-storage) since this
image is zero-egress — the retry/backoff semantics are what carry over.
"""

from __future__ import annotations

import os
import random
import shutil
import time
import uuid
from typing import Callable

__all__ = ["ObjectStore", "download_with_retry", "retry"]


def retry(fn: Callable, max_tries: int = 3, base_delay: float = 0.5,
          max_delay: float = 30.0, exceptions=(Exception,)):
    """Exponential backoff with jitter (backoff.on_exception parity)."""
    last = None
    for attempt in range(max_tries):
        try:
            return fn()
        except exceptions as e:  # noqa: PERF203
            last = e
            if attempt == max_tries - 1:
                break
            delay = min(base_delay * (2 ** attempt), max_delay)
            time.sleep(delay * (0.5 + random.random() / 2))
    raise last  # type: ignore[misc]


class ObjectStore:
    """get/download for local/, s3://, gs:// URIs."""

    def __init__(self, download_retry: int = 2, download_timeout: float = 120.0):
        self.download_retry = max(int(download_retry), 1)
        self.download_timeout = download_timeout
        self._s3 = None
        self._gcs = None

    def __getstate__(self):
        # lazily-created SDK clients hold sockets; recreate per process
        state = self.__dict__.copy()
        state["_s3"] = None
        state["_gcs"] = None
        return state

    # ---- backends ------------------------------------------------------
    def _s3_client(self):
        if self._s3 is None:
            import boto3  # gated: not in this image
            self._s3 = boto3.client("s3")
        return self._s3

    def _gcs_client(self):
        if self._gcs is None:
            from google.cloud import storage  # gated
            self._gcs = storage.Client()
        return self._gcs

    # ---- API -------------------------------------------------------------
    def get(self, uri: str) -> bytes:
        def _once() -> bytes:
            if uri.startswith("s3://"):
                bucket, _, key = uri[5:].partition("/")
                obj = self._s3_client().get_object(Bucket=bucket, Key=key)
                return obj["Body"].read()
            if uri.startswith("gs://"):
                bucket, _, key = uri[5:].partition("/")
                return (self._gcs_client().bucket(bucket).blob(key)
                        .download_as_bytes(timeout=self.download_timeout))
            with open(uri, "rb") as f:
                return f.read()
        return retry(_once, max_tries=self.download_retry + 1)

    def download(self, uri: str, local_path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(local_path)), exist_ok=True)
        # unique tmp per call: concurrent workers (threads OR the
        # process-pool decode workers) racing on the same shard must never
        # truncate each other's in-flight tmp — each publishes a complete
        # file atomically and the last replace wins
        tmp = f"{local_path}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp"

        def _once() -> str:
            if os.path.exists(local_path):  # another worker already won
                return local_path
            if uri.startswith(("s3://", "gs://")):
                data = self.get(uri)
                with open(tmp, "wb") as f:
                    f.write(data)
            else:
                shutil.copyfile(uri, tmp)
            os.replace(tmp, local_path)  # atomic: readers never see partials
            return local_path

        return retry(_once, max_tries=self.download_retry + 1)

    def list_prefix(self, uri: str) -> list:
        """Object keys under `uri`, relative to it (recursive). Local paths
        walk the directory; s3/gs paginate the prefix. Missing prefix -> []."""

        def _once() -> list:
            if uri.startswith("s3://"):
                bucket, _, prefix = uri[5:].partition("/")
                prefix = prefix.rstrip("/")
                prefix = prefix + "/" if prefix else ""  # bare bucket: ""
                keys = []
                paginator = self._s3_client().get_paginator("list_objects_v2")
                for page in paginator.paginate(Bucket=bucket, Prefix=prefix):
                    keys += [o["Key"][len(prefix):]
                             for o in page.get("Contents", [])]
                return keys
            if uri.startswith("gs://"):
                bucket, _, prefix = uri[5:].partition("/")
                prefix = prefix.rstrip("/")
                prefix = prefix + "/" if prefix else ""
                blobs = self._gcs_client().bucket(bucket).list_blobs(
                    prefix=prefix)
                return [b.name[len(prefix):] for b in blobs]
            root = os.path.abspath(uri)
            if not os.path.isdir(root):
                return []
            out = []
            for dirpath, _, files in os.walk(root):
                for f in files:
                    out.append(os.path.relpath(os.path.join(dirpath, f),
                                               root))
            return out

        return retry(_once, max_tries=self.download_retry + 1)

    def upload(self, local_path: str, uri: str) -> str:
        """Upload a local file to s3://, gs://, or a local destination path
        (the reference cloudwriter writes MDS shards straight to remote
        buckets, reference: scripts/laion_cloudwriter.py:230-235,299-309)."""

        def _once() -> str:
            if uri.startswith("s3://"):
                bucket, _, key = uri[5:].partition("/")
                self._s3_client().upload_file(local_path, bucket, key)
            elif uri.startswith("gs://"):
                bucket, _, key = uri[5:].partition("/")
                (self._gcs_client().bucket(bucket).blob(key)
                 .upload_from_filename(local_path,
                                       timeout=self.download_timeout))
            else:
                os.makedirs(os.path.dirname(os.path.abspath(uri)),
                            exist_ok=True)
                # unique tmp: concurrent uploads to the same destination
                # (e.g. two index.json refreshes) must not clobber each
                # other's in-flight copy
                tmp = f"{uri}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp"
                shutil.copyfile(local_path, tmp)
                os.replace(tmp, uri)
            return uri

        return retry(_once, max_tries=self.download_retry + 1)


def download_with_retry(uri: str, local_path: str, download_retry: int = 2,
                        download_timeout: float = 120.0) -> str:
    return ObjectStore(download_retry, download_timeout).download(uri, local_path)
