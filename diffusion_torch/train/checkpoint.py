"""Checkpoints of the Trainer's state, with autoresume, retention and a
remote mirror.

Counterpart of `diffusion_tpu/train/checkpoint.py`, with its functions and
contracts; the files are safetensors (`utils/safetensors.py`), not orbax.
Layout:

    <save_folder>/ba<N>/state/params.safetensors     the UNet's parameters
                                                      (a diffusers UNet
                                                      state_dict)
    <save_folder>/ba<N>/state/optimizer.safetensors  mu.<name>, nu.<name>
    <save_folder>/ba<N>/state/ema.safetensors        the EMA, when there is one
    <save_folder>/ba<N>/state/train_state.json       step and the update count
    <save_folder>/ba<N>/meta.json                    timestamp, algorithm,
                                                      callback and loader state

`meta.json` is written last, through a temporary file and a rename: it
marks the checkpoint complete. A directory without it is never resumed
and never pruned; on an overwrite it is deleted first.

`save_checkpoint(wait=False)` copies the tensors into host buffers (pinned
when they come from the card), allocated once and reused from save to
save, waits until the copy is done, and writes the files from a thread.
The wait matters: the port's optimizer and EMA update the parameters in
place, so the next step would otherwise write into the checkpoint. At
most one save is in flight; `finalize_pending()` waits for it and writes
its marker (it runs at the next save, at every discovery or load, and at
the Trainer's end). With `remote=`, a finalized checkpoint is mirrored to
an object-store URI (`data/object_store.py`) by a thread, marker last;
errors of the write or of the upload surface at the next save, finalize
or drain.

One process writes (the port trains on one).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import torch

from diffusion_torch.data.object_store import ObjectStore
from diffusion_torch.models.pretrained import copy_into, validate
from diffusion_torch.utils import safetensors

__all__ = ["save_checkpoint", "load_checkpoint", "load_params",
           "latest_checkpoint_path", "checkpoint_batch", "finalize_pending",
           "prune_checkpoints", "sync_from_remote", "drain_remote_uploads",
           "fetch_checkpoint_dir", "last_save_stats"]

_BA_RE = re.compile(r"^ba(\d+)$")
_COMPLETE = "meta.json"  # written last => marks a complete checkpoint
_PARAMS, _OPT, _EMA = ("params.safetensors", "optimizer.safetensors",
                       "ema.safetensors")
_TRAIN_STATE = "train_state.json"
_ALIGN = 64

# (thread, errbox, meta_path, meta, remote) of the one in-flight save
_PENDING: Optional[Tuple[threading.Thread, list, str, Dict[str, Any],
                         Optional[str]]] = None
# (thread, errbox, local_dir) of the in-flight background upload
_UPLOAD: Optional[Tuple[threading.Thread, list, str]] = None
# bytes, pin_alloc_s, d2h_s, call_s, write_s of the last save
_STATS: Dict[str, float] = {}


class _HostBuffers:
    """Host copies of a checkpoint's tensors: one block, pinned when the
    tensors live on the card, cut into a view per tensor. It is
    allocated again only when the layout changes."""

    def __init__(self):
        self.layout: Optional[tuple] = None
        self.views: Dict[str, Dict[str, torch.Tensor]] = {}

    def copy(self, files: Dict[str, Dict[str, torch.Tensor]]
             ) -> Dict[str, Dict[str, torch.Tensor]]:
        layout = tuple((f, n, t.dtype, tuple(t.shape), t.device.type)
                       for f, ts in files.items() for n, t in ts.items())
        if layout != self.layout:
            self.views, self.layout = {}, None
            pin = any(entry[4] == "cuda" for entry in layout)
            offsets, total = [], 0
            for _, _, dtype, shape, _ in layout:
                offsets.append(total)
                nbytes = torch.Size(shape).numel() * dtype.itemsize
                total += -(-nbytes // _ALIGN) * _ALIGN
            t0 = time.perf_counter()
            block = torch.empty(max(total, 1), dtype=torch.uint8,
                                pin_memory=pin)
            _STATS["pin_alloc_s"] = time.perf_counter() - t0
            for (f, n, dtype, shape, _), off in zip(layout, offsets):
                nbytes = torch.Size(shape).numel() * dtype.itemsize
                self.views.setdefault(f, {})[n] = (
                    block[off:off + nbytes].view(dtype).view(shape))
            self.layout = layout
        else:
            _STATS["pin_alloc_s"] = 0.0
        t0 = time.perf_counter()
        on_card = False
        for f, ts in files.items():
            for n, t in ts.items():
                self.views[f][n].copy_(t.detach(), non_blocking=True)
                on_card = on_card or t.is_cuda
        if on_card:
            # the copies must land before the caller's next step changes
            # the tensors in place
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        _STATS["d2h_s"] = time.perf_counter() - t0
        return self.views


_HOST = _HostBuffers()


def last_save_stats() -> Dict[str, float]:
    """Sizes and times of the last save: `bytes`, `pin_alloc_s` (0 when
    the buffers were reused), `d2h_s` (the copy into them), `call_s`
    (until `save_checkpoint` returned) and, once written, `write_s`."""
    return dict(_STATS)


def _upload_dir(local_dir: str, remote_dir: str) -> None:
    """Mirror a complete checkpoint directory, the marker LAST, so a remote
    reader applies the same is-it-complete rule as a local one."""
    store = ObjectStore()
    marker = None
    for dirpath, _, files in os.walk(local_dir):
        for f in files:
            src = os.path.join(dirpath, f)
            rel = os.path.relpath(src, local_dir)
            if rel == _COMPLETE:
                marker = src
                continue
            store.upload(src, f"{remote_dir.rstrip('/')}/{rel}")
    if marker is not None:
        store.upload(marker, f"{remote_dir.rstrip('/')}/{_COMPLETE}")


def _drain_upload() -> None:
    """Wait for the in-flight upload; raise its error."""
    global _UPLOAD
    if _UPLOAD is None:
        return
    t, errbox, _ = _UPLOAD
    _UPLOAD = None
    t.join()
    if errbox:
        raise errbox[0]


def drain_remote_uploads() -> None:
    """Block until the background upload (if any) is done; raise its
    error. Call before the process exits when a remote copy is wanted."""
    _drain_upload()


def _thread(name: str, fn) -> Tuple[threading.Thread, list]:
    errbox: list = []

    def run():
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 -- re-raised at the join
            errbox.append(e)

    t = threading.Thread(target=run, daemon=True, name=name)
    t.start()
    return t, errbox


def _start_upload(local_dir: str, remote_dir: str) -> None:
    global _UPLOAD
    _drain_upload()  # one at a time; surface the previous failure
    t, errbox = _thread("ckpt-upload",
                        lambda: _upload_dir(local_dir, remote_dir))
    _UPLOAD = (t, errbox, local_dir)


def _mark(meta_path: str, meta: Dict[str, Any],
          remote: Optional[str]) -> None:
    tmp = meta_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, meta_path)
    if remote:
        local_dir = os.path.dirname(meta_path)
        _start_upload(local_dir, f"{remote.rstrip('/')}/"
                                 f"{os.path.basename(local_dir)}")


def finalize_pending() -> None:
    """Wait until the in-flight save (if any) is written, then write its
    marker (and start its upload when a remote is set). Raises here if the
    write failed, leaving the directory unmarked."""
    global _PENDING
    if _PENDING is None:
        _drain_upload()
        return
    t, errbox, meta_path, meta, remote = _PENDING
    _PENDING = None
    t.join()
    if errbox:
        raise errbox[0]
    _mark(meta_path, meta, remote)


def _moments(train_state: Any) -> Dict[str, torch.Tensor]:
    """The optimizer's moments under `mu.<name>` and `nu.<name>`."""
    opt = train_state.optimizer.state_dict()
    return {f"{key}.{n}": t for key in ("mu", "nu")
            for n, t in zip(train_state.params, opt[key])}


def _tensor_files(train_state: Any) -> Dict[str, Dict[str, torch.Tensor]]:
    files = {_PARAMS: {n: p.detach() for n, p in train_state.params.items()},
             _OPT: _moments(train_state)}
    if train_state.ema_params is not None:
        files[_EMA] = dict(train_state.ema_params)
    return files


def _write(state_path: str, host: Dict[str, Dict[str, torch.Tensor]],
           scalars: Dict[str, int]) -> None:
    t0 = time.perf_counter()
    for name, tensors in host.items():
        safetensors.save_file(tensors, os.path.join(state_path, name))
    with open(os.path.join(state_path, _TRAIN_STATE), "w") as f:
        json.dump(scalars, f)
    _STATS["write_s"] = time.perf_counter() - t0


def save_checkpoint(save_folder: str, batch: int, train_state: Any,
                    meta: Optional[Dict[str, Any]] = None,
                    overwrite: bool = True, wait: bool = True,
                    remote: Optional[str] = None) -> str:
    """Write `<save_folder>/ba<batch>/{state/, meta.json}` from a
    `TrainState` (params, optimizer, EMA, step).

    An existing directory of that batch is overwritten (or, with
    `overwrite=False`, FileExistsError): its marker goes first, so a crash
    during the rewrite leaves a directory that discovery skips.

    `wait=False` returns once the tensors are in the host buffers; the
    files are written by a thread and the marker by `finalize_pending()`.
    `remote` mirrors the finalized checkpoint there."""
    global _PENDING
    t_call = time.perf_counter()
    finalize_pending()  # at most one in flight; also orders overwrites
    path = os.path.join(save_folder, f"ba{batch}")
    state_path = os.path.join(path, "state")
    meta_path = os.path.join(path, _COMPLETE)
    if os.path.exists(state_path) or os.path.exists(meta_path):
        if not overwrite:
            raise FileExistsError(f"{path} exists and save_overwrite=False")
        if _UPLOAD is not None and \
                os.path.abspath(_UPLOAD[2]) == os.path.abspath(path):
            _drain_upload()  # not out from under its own mirror
        if os.path.exists(meta_path):
            os.remove(meta_path)
        if os.path.exists(state_path):
            shutil.rmtree(state_path)
    os.makedirs(state_path)
    files = _tensor_files(train_state)
    _STATS.clear()
    _STATS["bytes"] = sum(t.numel() * t.element_size()
                          for ts in files.values() for t in ts.values())
    host = _HOST.copy(files)
    scalars = {"step": int(train_state.step),
               "count": int(train_state.optimizer.count)}
    meta = dict(meta or {})
    if wait:
        _write(state_path, host, scalars)
        _mark(meta_path, meta, remote)
    else:
        t, errbox = _thread("ckpt-write",
                            lambda: _write(state_path, host, scalars))
        _PENDING = (t, errbox, meta_path, meta, remote)
    _STATS["call_s"] = time.perf_counter() - t_call
    return path


def load_params(path: str, params: Dict[str, torch.Tensor]) -> str:
    """Copy a checkpoint's parameters into `params` in place. `path` is a
    complete Trainer checkpoint (`state/params.safetensors` beside its
    marker) or a weights-only directory (a bare `params.safetensors`).
    Returns the file read."""
    finalize_pending()
    in_state = os.path.join(path, "state", _PARAMS)
    bare = os.path.join(path, _PARAMS)
    if os.path.exists(in_state):
        if not os.path.exists(os.path.join(path, _COMPLETE)):
            raise FileNotFoundError(f"{path} has no {_COMPLETE}: the "
                                    f"checkpoint is incomplete")
        src = in_state
    elif os.path.exists(bare):
        src = bare
    else:
        raise FileNotFoundError(
            f"{path} is neither a Trainer checkpoint (state/{_PARAMS} and "
            f"{_COMPLETE}) nor a weights-only directory ({_PARAMS})")
    copy_into(f"checkpoint params ({src})", params,
              safetensors.load_file(src))
    return src


def load_checkpoint(path: str, train_state: Any, partial: bool = False
                    ) -> Tuple[Any, Dict[str, Any]]:
    """Restore a complete checkpoint into `train_state` in place:
    parameters, optimizer moments and count, EMA and step. With
    `partial=True` only the parameters (the reference's
    `load_weights_only`). Returns (train_state, meta)."""
    finalize_pending()  # an async save of this very path may be in flight
    meta_path = os.path.join(path, _COMPLETE)
    if not os.path.exists(meta_path):
        raise FileNotFoundError(f"{path} has no {_COMPLETE}: the checkpoint "
                                f"is incomplete")
    state_path = os.path.join(path, "state")
    load_params(path, train_state.params)
    if not partial:
        with open(os.path.join(state_path, _TRAIN_STATE)) as f:
            scalars = json.load(f)
        got = safetensors.load_file(os.path.join(state_path, _OPT))
        validate(f"checkpoint optimizer state ({path})", got,
                 _moments(train_state))
        train_state.optimizer.load_state_dict({
            "count": scalars["count"],
            **{key: [got[f"{key}.{n}"] for n in train_state.params]
               for key in ("mu", "nu")}})
        ema_file = os.path.join(state_path, _EMA)
        has_ema = os.path.exists(ema_file)
        if (train_state.ema_params is not None) != has_ema:
            raise ValueError(
                f"{path}: the checkpoint {'has' if has_ema else 'has no'} "
                f"EMA weights and the trainer "
                f"{'has' if train_state.ema_params is not None else 'has no'}"
                f" EMA (load its weights alone with load_weights_only)")
        if train_state.ema_params is not None:
            copy_into(f"checkpoint EMA ({path})", train_state.ema_params,
                      safetensors.load_file(ema_file))
        train_state.step = int(scalars["step"])
    with open(meta_path) as f:
        meta = json.load(f)
    return train_state, meta


def prune_checkpoints(save_folder: str, keep: int) -> None:
    """Delete the oldest complete checkpoints so at most `keep` remain
    (keep <= 0 keeps all). The in-flight save counts as the newest without
    being waited for, but while it is unmarked the newest complete one is
    kept too (a crash must leave one to resume). Unmarked directories and
    one still uploading are never deleted. Remote mirrors are not pruned."""
    if keep <= 0 or not save_folder or not os.path.isdir(save_folder):
        return
    complete = []
    for name in os.listdir(save_folder):
        m = _BA_RE.match(name)
        full = os.path.join(save_folder, name)
        if m and os.path.exists(os.path.join(full, _COMPLETE)):
            complete.append((int(m.group(1)), full))
    complete.sort()
    uploading = (os.path.abspath(_UPLOAD[2])
                 if _UPLOAD is not None and _UPLOAD[0].is_alive() else None)
    budget = max(keep - 1, 1) if _PENDING is not None else keep
    excess = [(n, f) for n, f in complete[:-budget]
              if os.path.abspath(f) != uploading]
    for _, full in excess:
        # marker first: a crash mid-delete leaves an unmarked directory
        os.remove(os.path.join(full, _COMPLETE))
        shutil.rmtree(full, ignore_errors=True)


def checkpoint_batch(path: str) -> int:
    m = _BA_RE.match(os.path.basename(os.path.normpath(path)))
    return int(m.group(1)) if m else -1


def latest_checkpoint_path(save_folder: str) -> Optional[str]:
    """The highest complete ba<N> under save_folder (autoresume)."""
    finalize_pending()  # in-process autoresume right after an async save
    if not save_folder or not os.path.isdir(save_folder):
        return None
    best, best_n = None, -1
    for name in os.listdir(save_folder):
        m = _BA_RE.match(name)
        full = os.path.join(save_folder, name)
        if m and os.path.exists(os.path.join(full, _COMPLETE)) \
                and int(m.group(1)) > best_n:
            best, best_n = full, int(m.group(1))
    return best


def sync_from_remote(save_folder: str, remote: str) -> Optional[str]:
    """Download the newest complete remote checkpoint when it is newer
    than the newest local one (autoresume on a fresh host), marker last.
    Returns its local path, or None when the local folder is current."""
    finalize_pending()
    store = ObjectStore()
    keys = store.list_prefix(remote)
    best_n, best_name = -1, None
    for k in keys:
        parts = k.replace("\\", "/").split("/")
        if len(parts) == 2 and parts[1] == _COMPLETE:
            m = _BA_RE.match(parts[0])
            if m and int(m.group(1)) > best_n:
                best_n, best_name = int(m.group(1)), parts[0]
    if best_name is None:
        return None
    local_latest = latest_checkpoint_path(save_folder)
    if local_latest is not None and checkpoint_batch(local_latest) >= best_n:
        return None
    dest = os.path.join(save_folder, best_name)
    prefix = f"{remote.rstrip('/')}/{best_name}/"
    files = [k.replace("\\", "/").split("/", 1)[1] for k in keys
             if k.replace("\\", "/").startswith(best_name + "/")]
    for rel in sorted(files, key=lambda r: r == _COMPLETE):  # marker last
        store.download(prefix + rel, os.path.join(dest, rel))
    return dest


_REMOTE_SCHEMES = ("s3://", "gs://", "file://")


def fetch_checkpoint_dir(checkpoint_path: str,
                         cache_dir: Optional[str] = None) -> str:
    """A local directory for a checkpoint path that may be in an object
    store. Local paths pass through; `s3://`, `gs://` and `file://` are
    mirrored once into a cache directory keyed by the path, behind a
    marker, so a restarted server does not download again. Any other
    scheme raises ValueError naming it."""
    if "://" in checkpoint_path and \
            not checkpoint_path.startswith(_REMOTE_SCHEMES):
        scheme = checkpoint_path.split("://", 1)[0]
        raise ValueError(
            f"unsupported checkpoint scheme {scheme}:// "
            f"({checkpoint_path}); supported: a local directory, "
            f"s3://, gs://, or file://")
    if not checkpoint_path.startswith(_REMOTE_SCHEMES):
        return checkpoint_path
    src = checkpoint_path[7:] if checkpoint_path.startswith("file://") \
        else checkpoint_path
    digest = hashlib.sha1(checkpoint_path.encode()).hexdigest()[:16]
    dest = os.path.join(
        cache_dir or os.path.join(os.path.expanduser("~/.cache"),
                                  "diffusion_torch", "serving_ckpt"),
        digest)
    marker = os.path.join(dest, ".fetched")
    if os.path.exists(marker):
        return dest
    store = ObjectStore()
    keys = store.list_prefix(src)
    if not keys:
        raise FileNotFoundError(
            f"no objects under checkpoint path {checkpoint_path}")
    for rel in keys:
        store.download(f"{src.rstrip('/')}/{rel}", os.path.join(dest, rel))
    with open(marker, "w") as f:
        f.write(checkpoint_path + "\n")
    return dest
