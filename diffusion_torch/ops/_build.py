"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources in `diffusion_torch/csrc/` have a plain C interface, so they
build with `nvcc -shared` in seconds, without PyTorch's headers, into
`build/diffusion_torch/` at the repository root. The library's name carries
a hash of the sources and flags: an edit rebuilds, an unchanged tree reuses
the library. The first kernel call in a process builds and loads it;
importing this module does neither. `set_build_dir` moves the library to
another directory, which several processes or hosts may share
(`utils/compile_cache.py`).

Every wrapper that launches a kernel counts its launches in a
`LaunchCounter`, so a run can show that its main path went through the
kernels (chip_smoke.py reads the counts around a serving run), and sums
there its host time from its entry to the launch's return
(`LaunchCounter.launched`); `utils/profiler.py` records how far the sum
over all counters grows in each training step.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import operator
import os
import shutil
import subprocess
import threading
import time

__all__ = ["LaunchCounter", "library", "library_path", "build_log",
           "set_build_dir", "BUILD_DIR"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "diffusion_torch")
_SOURCES = ("adamw.cu", "flash_attention.cu", "flash_attention_bwd.cu",
            "group_norm.cu")
_HEADERS = ("flash_common.cuh", "hopper_common.cuh")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "dt_flash_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL,
                               _F, _P],
    "dt_flash_attention_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                  _I, *[_LL] * 15, _F, _P],
    "dt_flash_attention_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                   _I, _I, *[_LL] * 12, _F, _P],
    "dt_group_norm_fwd": [*[_P] * 7, *[_I] * 9, _F, _I, _I, _I, _P],
    "dt_group_norm_bwd": [*[_P] * 11, *[_I] * 12, _P],
    "dt_group_norm_fwd_stage": [*[_P] * 7, *[_I] * 10, _F, _I, _I, _I, _P],
    "dt_group_norm_bwd_stage": [*[_P] * 13, *[_I] * 13, _P],
    "dt_adamw_ema_foreach": [_P, _P, _P, _I, _I, _I, _P, *[_F] * 12, _P],
}


_HOST_NS = operator.attrgetter("_host_ns")


class LaunchCounter:
    """A thread-safe count of one kernel's launches, and the host
    nanoseconds its wrapper took for those counted through `launched`
    (`reset` leaves them: they only grow)."""

    _all: "list[LaunchCounter]" = []     # every counter made, kept

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._n = 0
        self._host_ns = 0
        LaunchCounter._all.append(self)

    def add(self, n: int = 1) -> None:
        """Count `n` launches (a CUDA graph's replay adds those it
        captured; a capture takes back those it recorded), with no host
        time."""
        with self._lock:
            self._n += n

    def launched(self, start_ns: int) -> None:
        """Count one launch whose wrapper was entered at `start_ns`
        (`time.perf_counter_ns()`), and add the host time since."""
        ns = time.perf_counter_ns() - start_ns
        with self._lock:
            self._n += 1
            self._host_ns += ns

    @property
    def host_ns(self) -> int:
        with self._lock:
            return self._host_ns

    @classmethod
    def counters(cls) -> "list[LaunchCounter]":
        """Every counter made in the process."""
        return list(cls._all)

    @classmethod
    def total_host_ns(cls) -> int:
        """The host time of every counter in the process, summed (each
        read of an int is atomic: no lock)."""
        return sum(map(_HOST_NS, cls._all))

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._n


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build diffusion_torch's kernels")


def _digest() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build_log() -> str:
    """Path of the nvcc log (ptxas registers, shared memory, spills)."""
    return os.path.join(BUILD_DIR, f"build_{_digest()}.log")


def library_path() -> str:
    """Where `library()` finds, or builds, the shared library."""
    return os.path.join(BUILD_DIR, f"libdiffusion_torch_{_digest()}.so")


def set_build_dir(path: str) -> None:
    """From now on, `library()` builds and loads the library under
    `path`."""
    global BUILD_DIR
    BUILD_DIR = path
    library.cache_clear()


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels' shared library."""
    out = library_path()
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *_FLAGS, "-o", tmp,
               *(os.path.join(_CSRC, s) for s in _SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        with open(build_log(), "w") as f:
            f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                               f"{proc.stderr[-4000:]}")
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    lib = ctypes.CDLL(out)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
