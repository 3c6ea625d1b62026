"""Metadata filtering for web-scale image datasets.

A copy of `diffusion_tpu/data/filters.py`, which imports no jax, with its
imports pointed at the port's modules: the port imports nothing of
the JAX package.

The equivalent of the reference's filter utils (reference:
diffusion/datasets/wds/utils.py == pexels/utils.py, 98 LoC each): a JSON
`filter_strategy` drives thresholds on image short side (ref :27-40), aspect
ratio (ref :42-56), `punsafe` (ref :58-69), `aesthetic` score (ref :71-83)
and `pwatermark` (ref :85-96), each with a `default` keep/drop decision when
the metadata key is missing; key lookup is tolerant across LAION/COYO schema
variants; `log_and_continue` swallows per-sample errors (ref :5-8).
"""

from __future__ import annotations

import json
import logging
from typing import Any, Dict, Mapping, Optional, Sequence, Union

logger = logging.getLogger(__name__)

__all__ = ["filter_fn", "load_filter_strategy", "log_and_continue"]


def log_and_continue(exn: BaseException) -> bool:
    """Swallow-and-log handler for per-sample pipeline errors."""
    logger.warning("caught %r in pipeline; skipping sample", exn)
    return True


def load_filter_strategy(path_or_dict: Union[str, Mapping[str, Any], None]
                         ) -> Optional[Dict[str, Any]]:
    if path_or_dict is None:
        return None
    if isinstance(path_or_dict, Mapping):
        return dict(path_or_dict)
    with open(path_or_dict) as f:
        return json.load(f)


def _lookup(meta: Mapping[str, Any], keys: Sequence[str]) -> Optional[float]:
    """Tolerant metadata lookup across LAION/COYO/schema variants."""
    for k in keys:
        if k in meta and meta[k] is not None:
            try:
                return float(meta[k])
            except (TypeError, ValueError):
                return None
    return None


_HEIGHT_KEYS = ("height", "HEIGHT", "original_height", "orig_height")
_WIDTH_KEYS = ("width", "WIDTH", "original_width", "orig_width")
_PUNSAFE_KEYS = ("punsafe", "pnsfw", "nsfw_score")
_AESTHETIC_KEYS = ("aesthetic", "AESTHETIC_SCORE", "aesthetic_score")
_PWATERMARK_KEYS = ("pwatermark", "watermark_score")


def filter_fn(sample: Mapping[str, Any],
              filter_strategy: Optional[Mapping[str, Any]] = None,
              meta_key: str = "json") -> bool:
    """True = keep. `filter_strategy` sections (all optional):
      short_side:   {"min": px, "default": bool}
      aspect_ratio: {"max": r, "default": bool}       (long/short)
      punsafe:      {"max": p, "default": bool}
      aesthetic:    {"min": s, "default": bool}
      pwatermark:   {"max": p, "default": bool}
    """
    if not filter_strategy:
        return True
    meta = sample.get(meta_key) or {}
    if isinstance(meta, (bytes, str)):
        try:
            meta = json.loads(meta)
        except (json.JSONDecodeError, UnicodeDecodeError):
            meta = {}

    cfg = filter_strategy.get("short_side")
    if cfg:
        h = _lookup(meta, _HEIGHT_KEYS)
        w = _lookup(meta, _WIDTH_KEYS)
        if h is None or w is None:
            if not cfg.get("default", True):
                return False
        elif min(h, w) < cfg.get("min", 0):
            return False

    cfg = filter_strategy.get("aspect_ratio")
    if cfg:
        h = _lookup(meta, _HEIGHT_KEYS)
        w = _lookup(meta, _WIDTH_KEYS)
        if h is None or w is None or min(h, w) == 0:
            if not cfg.get("default", True):
                return False
        elif max(h, w) / min(h, w) > cfg.get("max", float("inf")):
            return False

    cfg = filter_strategy.get("punsafe")
    if cfg:
        v = _lookup(meta, _PUNSAFE_KEYS)
        if v is None:
            if not cfg.get("default", True):
                return False
        elif v > cfg.get("max", 1.0):
            return False

    cfg = filter_strategy.get("aesthetic")
    if cfg:
        v = _lookup(meta, _AESTHETIC_KEYS)
        if v is None:
            if not cfg.get("default", True):
                return False
        elif v < cfg.get("min", 0.0):
            return False

    cfg = filter_strategy.get("pwatermark")
    if cfg:
        v = _lookup(meta, _PWATERMARK_KEYS)
        if v is None:
            if not cfg.get("default", True):
                return False
        elif v > cfg.get("max", 1.0):
            return False

    return True
