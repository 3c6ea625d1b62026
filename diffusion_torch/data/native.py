"""ctypes bindings for the native data-plane core (csrc/dataio.cpp).

The port's copy of `diffusion_tpu/data/native.py`. Provides
`tar_index(path)` — (name, offset, size) for every file in a tar shard via
one mmap pass — `mds_sample_table(buf)` — the sample offset table of an MDS
shard — and `jpeg_decode_square`. Each has a pure-Python answer (or None)
when the library is absent.

One change: the port never loads the JAX package's library. The first call
builds its own `libdataio` from `csrc/dataio.cpp` with g++ into
`build/diffusion_torch/` (git-ignored; the name carries a hash of the
source), with the commands of `tools/build_native.py`: against libjpeg where
it links and loads, else without the JPEG entry point. Where g++ is
missing, the pure-Python paths run; where neither variant builds and
loads, the first call raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import mmap
import os
import shutil
import subprocess
import tarfile
import threading
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["tar_index", "mds_sample_table", "native_available",
           "jpeg_decode_square", "jpeg_native_available", "build_info"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "csrc", "dataio.cpp")
_BUILD_DIR = os.path.join(_ROOT, "build", "diffusion_torch")
_BASE = ("-O3", "-shared", "-fPIC", "-std=c++17")
# tools/build_native.py: against libjpeg where it links, else without
_VARIANTS = (("jpeg", ("-DHAVE_JPEG", "-ljpeg"), "with libjpeg"),
             ("nojpeg", (), "no libjpeg"))
_lib = None
_info = "not loaded"
_load_lock = threading.Lock()


class _TarEntry(ctypes.Structure):
    _fields_ = [("name_off", ctypes.c_uint64), ("name_len", ctypes.c_uint32),
                ("data_off", ctypes.c_uint64), ("data_len", ctypes.c_uint64)]


def _open_library() -> Optional[ctypes.CDLL]:
    """The built library, loaded (building it if needed), or None without
    g++ or without the source. A variant that does not build, or that was
    built where libjpeg is and cannot load here, yields to the next."""
    global _info
    gxx = shutil.which("g++")
    if gxx is None or not os.path.exists(_SRC):
        _info = "pure Python (no g++)" if gxx is None else \
            "pure Python (no csrc/dataio.cpp)"
        return None
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_BASE).encode()
                                ).hexdigest()[:16]
    errors = []
    for tag, flags, kind in _VARIANTS:
        out = os.path.join(_BUILD_DIR, f"libdataio_{digest}_{tag}.so")
        if not os.path.exists(out):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            proc = subprocess.run([gxx, *_BASE, _SRC, *flags, "-o", tmp],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                errors.append(proc.stderr[-2000:])
                continue
            os.replace(tmp, out)  # atomic: concurrent builders agree
        try:
            lib = ctypes.CDLL(out)
        except OSError as e:
            errors.append(str(e))
            continue
        _info = f"{out} ({kind})"
        return lib
    raise RuntimeError(f"g++ could not build a loadable library from "
                       f"{_SRC}:\n" + "\n".join(errors))


def _load():
    global _lib
    with _load_lock:
        if _lib is not None:
            return _lib
        lib = _open_library()
        if lib is None:
            _lib = False
            return _lib
        lib.tar_index.restype = ctypes.c_long
        lib.tar_index.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                  ctypes.POINTER(_TarEntry), ctypes.c_long]
        lib.mds_sample_table.restype = ctypes.c_int
        lib.mds_sample_table.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_uint32]
        lib.jpeg_decode_square.restype = ctypes.c_int
        lib.jpeg_decode_square.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float)]
        _lib = lib
        return _lib


def native_available() -> bool:
    return bool(_load())


def build_info() -> str:
    """Which data-plane path runs: the library's path and whether it links
    libjpeg, or the pure-Python path and why."""
    _load()
    return _info


def tar_index(path: str) -> List[Tuple[str, int, int]]:
    """[(member_name, data_offset, data_size)] for regular files in a tar."""
    lib = _load()
    if not lib:
        out = []
        with tarfile.open(path, "r") as tf:
            for m in tf:
                if m.isfile():
                    out.append((m.name, m.offset_data, m.size))
        return out
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        view = None
        try:
            # zero-copy readonly view; numpy exposes the buffer address
            view = np.frombuffer(mm, np.uint8)
            addr = view.ctypes.data
            # every entry consumes >= 512 header bytes, so this bounds them
            max_entries = len(mm) // 512 + 16
            entries = (_TarEntry * max_entries)()
            n = lib.tar_index(ctypes.cast(addr, ctypes.c_char_p), len(mm),
                              entries, max_entries)
            if n < 0:
                raise ValueError(f"malformed tar: {path}")
            out = []
            for i in range(n):
                e = entries[i]
                name = mm[e.name_off:e.name_off + e.name_len].decode(
                    "utf-8", errors="replace")
                out.append((name, int(e.data_off), int(e.data_len)))
            return out
        finally:
            del view  # release buffer export before closing the mmap
            mm.close()


_JPEG_MAGIC = b"\xff\xd8"


def jpeg_native_available() -> bool:
    """True when the compiled library can decode JPEGs (built with
    -DHAVE_JPEG against libjpeg/-turbo)."""
    lib = _load()
    if not lib:
        return False
    # a no-JPEG build stubs the symbol to return -100
    out = (ctypes.c_float * 3)()
    return lib.jpeg_decode_square(_JPEG_MAGIC, 2, 1, 1, out) != -100


def jpeg_decode_square(data: bytes, size: int,
                       min_short: Optional[int] = None) -> Optional[np.ndarray]:
    """Decode a JPEG and return the LargestCenterSquare crop resized to
    (size, size, 3) float32 in [-1, 1] — the whole SD train-input transform
    (reference datasets/laion/transforms.py:9-21 + Normalize(0.5, 0.5)) in
    one GIL-releasing native call. Returns None when the native path is
    unavailable or declines the stream (corrupt data, CMYK, non-JPEG):
    callers fall back to the tolerant PIL path.

    `min_short` is the smallest acceptable decoded short side for libjpeg
    DCT scaling (defaults to `size`; pass 2*size for PIL-draft-quality
    headroom)."""
    lib = _load()
    if not lib or not isinstance(data, (bytes, bytearray)) \
            or not bytes(data[:2]) == _JPEG_MAGIC:
        return None
    out = np.empty((size, size, 3), np.float32)
    rc = lib.jpeg_decode_square(
        bytes(data), len(data), size, int(min_short or size),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out if rc == 0 else None


def mds_sample_table(buf: bytes) -> Optional[np.ndarray]:
    """(n, 2) array of [start, end) byte ranges per sample, or None to use
    the Python path."""
    lib = _load()
    if not lib:
        return None
    n = int(np.frombuffer(buf[:4], np.uint32)[0])
    starts = (ctypes.c_uint64 * n)()
    ends = (ctypes.c_uint64 * n)()
    got = lib.mds_sample_table(buf, len(buf), starts, ends, n)
    if got < 0:
        raise ValueError("malformed MDS shard")
    out = np.empty((got, 2), np.int64)
    out[:, 0] = np.frombuffer(starts, np.uint64, got)
    out[:, 1] = np.frombuffer(ends, np.uint64, got)
    return out
