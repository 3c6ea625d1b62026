"""YAML config substrate: load, interpolate, override, instantiate.

A copy of `diffusion_tpu/config/loader.py`, which imports no jax: the port
imports nothing of the JAX package. One change: `_target_` paths under
`diffusion_tpu.` resolve to the same path under `diffusion_torch.`, so one
yaml composes either package and the port never imports the JAX one.

The hydra/OmegaConf surface the reference's yamls use:

- YAML config trees with ``${dotted.path}`` interpolation.
- Objects declared with ``_target_`` (a dotted import path) instantiated
  recursively, honoring ``_recursive_`` and ``_partial_``.
- Dotted CLI overrides (``a.b.c=value``, ``+new.key=value``, ``~deleted.key``).

Plain dicts/lists all the way down -- no DictConfig class hierarchy.
"""

from __future__ import annotations

import copy
import functools
import importlib
import re
from typing import Any, Dict, Optional, Sequence

import yaml

__all__ = [
    "load_config",
    "resolve",
    "apply_overrides",
    "instantiate",
    "to_yaml",
    "select",
    "merge",
]

_INTERP_RE = re.compile(r"\$\{([^}]+)\}")


def load_config(path: str, overrides: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Load a YAML file, apply CLI-style overrides, and resolve interpolations."""
    with open(path, "r") as f:
        cfg = yaml.safe_load(f) or {}
    if not isinstance(cfg, dict):
        raise TypeError(f"top-level config must be a mapping, got {type(cfg)}")
    # mosaic-yaml dialect: the whole config tree nests under `parameters:`
    # (reference yamls/mosaic-yamls/SD-2-base-256.yaml:20+ — the mcli platform
    # wraps the hydra tree); accept both dialects transparently
    if "parameters" in cfg and isinstance(cfg["parameters"], dict) \
            and "model" in cfg["parameters"]:
        cfg = cfg["parameters"]
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return resolve(cfg)


def loads_config(text: str, overrides: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Like :func:`load_config` but from a YAML string (same dialect rules:
    top level must be a mapping, mosaic `parameters:` trees unwrap)."""
    cfg = yaml.safe_load(text) or {}
    if not isinstance(cfg, dict):
        raise TypeError(f"top-level config must be a mapping, got {type(cfg)}")
    if "parameters" in cfg and isinstance(cfg["parameters"], dict) \
            and "model" in cfg["parameters"]:
        cfg = cfg["parameters"]
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return resolve(cfg)


def select(cfg: Dict[str, Any], dotted: str, default: Any = None) -> Any:
    """Fetch ``cfg[a][b][c]`` for ``dotted == 'a.b.c'``; list indices allowed."""
    node: Any = cfg
    for part in dotted.split("."):
        if isinstance(node, dict):
            if part not in node:
                return default
            node = node[part]
        elif isinstance(node, list):
            try:
                node = node[int(part)]
            except (ValueError, IndexError):
                return default
        else:
            return default
    return node


def _parse_value(raw: str) -> Any:
    """Parse an override RHS with YAML scalar semantics ('3'->int, 'null'->None...)."""
    try:
        return yaml.safe_load(raw)
    except yaml.YAMLError:
        return raw


def apply_overrides(cfg: Dict[str, Any], overrides: Sequence[str]) -> Dict[str, Any]:
    """Apply hydra-style dotted overrides. Returns a new config.

    ``a.b=v`` sets (key must exist unless prefixed '+'), ``+a.b=v`` adds,
    ``~a.b`` deletes.
    """
    cfg = copy.deepcopy(cfg)
    for ov in overrides:
        ov = ov.strip()
        if not ov:
            continue
        if ov.startswith("~"):
            # hydra also allows '~a.b=value' (delete only the key; the
            # value part is informational) — keeping '=v' inside the key
            # path made the delete a silent no-op
            path, value, mode = ov[1:].split("=", 1)[0], None, "del"
        else:
            if "=" not in ov:
                raise ValueError(f"override {ov!r} must look like key=value")
            path, raw = ov.split("=", 1)
            mode = "add" if path.startswith("+") else "set"
            path = path.lstrip("+")
            value = _parse_value(raw)
        parts = path.split(".")
        node: Any = cfg
        for p in parts[:-1]:
            if isinstance(node, list):
                node = node[int(p)]
            else:
                if p not in node or node[p] is None:
                    if mode == "add":
                        node[p] = {}
                    elif p not in node:
                        raise KeyError(f"override path {path!r}: missing key {p!r} "
                                       f"(use +{path} to add)")
                    elif mode == "set":
                        # a null placeholder node (e.g. 'logger:\n  wandb:')
                        # cannot be traversed into — say so instead of the
                        # TypeError 'NoneType is not iterable'
                        raise KeyError(
                            f"override path {path!r}: {p!r} is null in the "
                            f"config (use +{path}=... to create the subtree)")
                    else:           # del through a null parent: nothing to do
                        node = None
                        break
                node = node[p]
        if node is None:
            continue        # '~' through a null parent: nothing to delete
        last = parts[-1]
        if mode == "del":
            if isinstance(node, list):
                del node[int(last)]
            else:
                node.pop(last, None)
        else:
            if isinstance(node, list):
                node[int(last)] = value
            else:
                if mode == "set" and last not in node:
                    raise KeyError(f"override {path!r}: key {last!r} not in config "
                                   f"(use +{path}=... to add)")
                node[last] = value
    return cfg


def resolve(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Resolve ``${dotted.path}`` interpolations against the config root."""
    root = copy.deepcopy(cfg)

    def _resolve_node(node: Any, seen: tuple) -> Any:
        if isinstance(node, dict):
            return {k: _resolve_node(v, seen) for k, v in node.items()}
        if isinstance(node, list):
            return [_resolve_node(v, seen) for v in node]
        if isinstance(node, str):
            return _resolve_str(node, seen)
        return node

    def _resolve_str(s: str, seen: tuple) -> Any:
        m = _INTERP_RE.fullmatch(s)
        if m:  # whole-string interpolation keeps the referent's type
            return _lookup(m.group(1), seen)
        def sub(match: "re.Match[str]") -> str:
            return str(_lookup(match.group(1), seen))
        return _INTERP_RE.sub(sub, s)

    def _lookup(path: str, seen: tuple) -> Any:
        if path in seen:
            raise ValueError(f"circular interpolation through ${{{path}}}")
        val = select(root, path, default=_MISSING)
        if val is _MISSING:
            raise KeyError(f"interpolation ${{{path}}} not found in config")
        return _resolve_node(val, seen + (path,))

    return _resolve_node(root, ())


class _Missing:
    def __repr__(self) -> str:  # pragma: no cover
        return "<missing>"


_MISSING = _Missing()


_JAX_PACKAGE, _PORT_PACKAGE = "diffusion_tpu.", "diffusion_torch."


def _import_target(path: str) -> Any:
    if path.startswith(_JAX_PACKAGE):
        path = _PORT_PACKAGE + path[len(_JAX_PACKAGE):]
    module_path, _, attr = path.rpartition(".")
    if not module_path:
        raise ImportError(f"_target_ {path!r} must be a dotted import path")
    mod = importlib.import_module(module_path)
    try:
        return getattr(mod, attr)
    except AttributeError as e:
        raise ImportError(f"module {module_path!r} has no attribute {attr!r}") from e


def instantiate(node: Any, *args: Any, **kwargs: Any) -> Any:
    """Recursively instantiate ``_target_`` nodes (hydra.utils.instantiate parity).

    Special keys: ``_target_`` (dotted import path), ``_partial_`` (return a
    functools.partial), ``_recursive_`` (default True; False passes child dicts
    through raw), ``_args_`` (positional args).
    Extra ``kwargs`` override config-declared ones.
    """
    if isinstance(node, list):
        return [instantiate(v) for v in node]
    if not isinstance(node, dict):
        return node
    if "_target_" not in node:
        return {k: instantiate(v) for k, v in node.items()}

    node = dict(node)
    target = _import_target(node.pop("_target_"))
    # control keys may come from the config node or the call site (hydra
    # parity: instantiate(conf, _recursive_=False), reference train.py:41)
    partial = bool(kwargs.pop("_partial_", node.pop("_partial_", False)))
    recursive = bool(kwargs.pop("_recursive_", node.pop("_recursive_", True)))
    cfg_args = node.pop("_args_", [])

    if recursive:
        node = {k: instantiate(v) for k, v in node.items()}
        cfg_args = [instantiate(v) for v in cfg_args]
    node.update(kwargs)
    all_args = list(cfg_args) + list(args)
    if partial:
        return functools.partial(target, *all_args, **node)
    return target(*all_args, **node)


def to_yaml(cfg: Any) -> str:
    return yaml.safe_dump(cfg, sort_keys=False)


def merge(base: Dict[str, Any], *others: Dict[str, Any]) -> Dict[str, Any]:
    """Deep-merge dicts; later values win; dicts merge recursively."""
    out = copy.deepcopy(base)
    for other in others:
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(out.get(k), dict):
                out[k] = merge(out[k], v)
            else:
                out[k] = copy.deepcopy(v)
    return out
