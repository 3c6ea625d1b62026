"""A build cache for the port's kernel library, shared across restarts.

Counterpart of `diffusion_tpu/utils/compile_cache.py`, JAX's persistent XLA
compilation cache. The port compiles nothing with XLA: what a restarted job
(an autoresume after preemption, a redeployed server, a relaunched eval)
builds again is the kernel library, one nvcc call in `ops/_build.py`
(`library()`). Pointing that library's directory at a cache directory that
outlives the job turns every start after the first into a load.

Enabled three ways, all funnelling here:
  - yaml: top-level `compile_cache_dir: /path` (`train/train.py`)
  - serving: `python -m diffusion_torch.inference.serve --compile-cache /path`
  - env: DIFFUSION_TORCH_COMPILE_CACHE=/path (read by both)

The directory is shared-safe: the library's name carries a hash of its
sources and flags, and a builder writes a file of its own and renames it
into place (`os.replace`), so many processes or hosts can point at one
directory, and an edited tree builds a library of its own beside the old.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

__all__ = ["enable_compile_cache"]

_ENV_VAR = "DIFFUSION_TORCH_COMPILE_CACHE"


def enable_compile_cache(cache_dir: Optional[str] = None,
                         min_compile_time_secs: float = 1.0) -> Optional[str]:
    """Build and load the kernel library under `cache_dir` (else
    $DIFFUSION_TORCH_COMPILE_CACHE) and return the resolved path; None, and
    the library stays under the checkout's `build/`, when neither is set.

    A library loaded before this call is not used by later calls: the next
    kernel launch loads (or builds) the cached one. `min_compile_time_secs`
    is kept for the JAX signature and unused: there is one library, and it
    is always worth keeping.
    """
    cache_dir = cache_dir or os.environ.get(_ENV_VAR)
    if not cache_dir:
        return None
    cache_dir = os.path.abspath(os.path.expanduser(str(cache_dir)))
    os.makedirs(cache_dir, exist_ok=True)
    from diffusion_torch.ops import _build
    _build.set_build_dir(cache_dir)
    logging.getLogger(__name__).info(
        "kernel library cache at %s", cache_dir)
    return cache_dir
