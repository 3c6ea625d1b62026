"""A reader of the `<name>.msgpack` weight files that `tools/port_weights.py`
writes through `flax.serialization.msgpack_serialize`.

The JAX loader reads them with `flax.serialization.msgpack_restore`
(`diffusion_tpu/models/pretrained.py`); the port decodes them itself.
It takes the subset of msgpack those files use: maps, arrays, str, bin,
ints, floats, nil and bool, and ext type 1, flax's ndarray, whose payload
is itself msgpack: ``(shape, dtype name, raw bytes)``. flax splits an
array of more than 2^30 bytes into a map ``{"__msgpack_chunked_array__":
True, "shape": {...}, "chunks": {...}}``, which is joined back here. Any
other ext type raises, naming its code.

The result is the flax tree with numpy leaves, for `unet_from_jax`,
`vae_from_jax` and `clip_text_from_jax` (`models/port_jax.py`). Arrays are
views of a map of the file; bfloat16 leaves (numpy has none) are widened
to float32, which is exact.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

__all__ = ["load", "unpackb"]

_NDARRAY = 1     # flax's _MsgpackExtType.ndarray


def _ndarray(payload: memoryview) -> np.ndarray:
    (shape, dtype, raw), end = _decode(payload, 0)
    if end != len(payload):
        raise ValueError("msgpack: trailing bytes in an ndarray payload")
    if dtype == "bfloat16":
        bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(dtype).newbyteorder("<")
                         ).reshape(shape)


def _unpack(fmt: str, buf: memoryview, pos: int) -> Tuple[Any, int]:
    size = struct.calcsize(fmt)
    return struct.unpack_from(fmt, buf, pos)[0], pos + size


def _decode(buf: memoryview, pos: int) -> Tuple[Any, int]:
    """One object at `pos` -> (object, position after it)."""
    b = buf[pos]
    pos += 1
    if b <= 0x7f:                                  # positive fixint
        return b, pos
    if b >= 0xe0:                                  # negative fixint
        return b - 0x100, pos
    if 0x80 <= b <= 0x8f:
        return _map(buf, pos, b & 0x0f)
    if 0x90 <= b <= 0x9f:
        return _array(buf, pos, b & 0x0f)
    if 0xa0 <= b <= 0xbf:
        n = b & 0x1f
        return str(buf[pos:pos + n], "utf-8"), pos + n
    if b == 0xc0:
        return None, pos
    if b in (0xc2, 0xc3):
        return b == 0xc3, pos
    if b in (0xc4, 0xc5, 0xc6, 0xd9, 0xda, 0xdb):  # bin / str 8, 16, 32
        n, pos = _unpack({0xc4: ">B", 0xc5: ">H", 0xc6: ">I", 0xd9: ">B",
                          0xda: ">H", 0xdb: ">I"}[b], buf, pos)
        raw = buf[pos:pos + n]
        return (raw if b <= 0xc6 else str(raw, "utf-8")), pos + n
    if b in (0xc7, 0xc8, 0xc9):                    # ext 8, 16, 32
        n, pos = _unpack({0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}[b], buf, pos)
        return _ext(buf, pos, n)
    if 0xd4 <= b <= 0xd8:                          # fixext 1..16
        return _ext(buf, pos, 1 << (b - 0xd4))
    if b in (0xca, 0xcb):
        return _unpack(">f" if b == 0xca else ">d", buf, pos)
    if 0xcc <= b <= 0xd3:                          # uint / int 8..64
        return _unpack(">" + "BHIQbhiq"[b - 0xcc], buf, pos)
    if b in (0xdc, 0xdd):
        n, pos = _unpack(">H" if b == 0xdc else ">I", buf, pos)
        return _array(buf, pos, n)
    if b in (0xde, 0xdf):
        n, pos = _unpack(">H" if b == 0xde else ">I", buf, pos)
        return _map(buf, pos, n)
    raise ValueError(f"msgpack: type byte 0x{b:02x} at {pos - 1} is not "
                     f"one the flax weight files use")


def _ext(buf: memoryview, pos: int, n: int) -> Tuple[Any, int]:
    code = struct.unpack_from(">b", buf, pos)[0]
    payload = buf[pos + 1:pos + 1 + n]
    if code != _NDARRAY:
        raise ValueError(f"msgpack: ext type {code} is not understood (flax "
                         f"weight files hold ext type {_NDARRAY}, ndarray)")
    return _ndarray(payload), pos + 1 + n


def _array(buf: memoryview, pos: int, n: int) -> Tuple[list, int]:
    out = []
    for _ in range(n):
        item, pos = _decode(buf, pos)
        out.append(item)
    return out, pos


def _map(buf: memoryview, pos: int, n: int) -> Tuple[Any, int]:
    out = {}
    for _ in range(n):
        key, pos = _decode(buf, pos)
        out[key], pos = _decode(buf, pos)
    if out.get("__msgpack_chunked_array__") is True:
        shape = [out["shape"][str(i)] for i in range(len(out["shape"]))]
        chunks = [out["chunks"][str(i)] for i in range(len(out["chunks"]))]
        return np.concatenate(chunks).reshape(shape), pos
    return out, pos


def unpackb(data) -> Any:
    """Decode one msgpack object that fills `data` (bytes or a buffer)."""
    buf = memoryview(data).cast("B")
    obj, end = _decode(buf, 0)
    if end != len(buf):
        raise ValueError(f"msgpack: {len(buf) - end} trailing bytes")
    return obj


def load(path: str) -> Any:
    """The flax tree of a `.msgpack` weight file."""
    return unpackb(np.memmap(path, dtype=np.uint8, mode="r"))
