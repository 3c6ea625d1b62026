"""The safetensors file format, read and written by hand.

The counterpart of the JAX package's `load_safetensors_dir`
(`diffusion_tpu/models/port_hf.py`), which reads through the `safetensors`
package; the port reads and writes the format itself. A file is an 8-byte
little-endian header length, a JSON header ``{name: {"dtype", "shape",
"data_offsets": [begin, end]}}`` with an optional ``"__metadata__"`` of
strings, padded with spaces to a multiple of 8 bytes, then the tensors'
raw little-endian bytes, with no gaps, offsets counted from the end of the
header.

Dtypes: F32, F16, BF16, I64 and I32. numpy has no bfloat16, so BF16 goes
through an int16 view of the tensor both ways. Reads map the file
(`np.memmap`, copy-on-write) and wrap each tensor with `torch.frombuffer`:
a tensor's pages are read when it is used, so loading a 3.5 GB file and
copying it into a model does not hold two copies in RAM. The writer
orders the tensors by item size, largest first, so every tensor starts at
a multiple of its own item size.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_file", "load_file", "load_dir", "read_header"]

DTYPES = {"F32": torch.float32, "F16": torch.float16,
          "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32}
_NAMES = {v: k for k, v in DTYPES.items()}
# the integer type each dtype's bytes are written and read through
_RAW = {torch.bfloat16: torch.int16}


def _dtype_name(t: torch.Tensor, name: str) -> str:
    if t.dtype not in _NAMES:
        raise ValueError(f"{name}: dtype {t.dtype} is not one of "
                         f"{sorted(_NAMES.values(), key=str)}")
    return _NAMES[t.dtype]


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """The tensor's bytes as a flat numpy array (no copy for a contiguous
    CPU tensor)."""
    t = t.detach().contiguous().reshape(-1)
    if t.dtype in _RAW:
        t = t.view(_RAW[t.dtype])
    return t.cpu().numpy().view(np.uint8)


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write `tensors` to `path`; returns the bytes written. CUDA tensors
    are copied to the host one at a time."""
    order = sorted(tensors, key=lambda n: -tensors[n].element_size())
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in order:
        t = tensors[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _dtype_name(t, name),
                        "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            f.write(memoryview(_host_bytes(tensors[name])))
    return 8 + len(blob) + offset


def read_header(path: str) -> Tuple[Dict[str, dict], Dict[str, str], int]:
    """(tensor entries, metadata, offset of the data) of a file, checked
    against the file's size."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file (no header)")
        (n,) = struct.unpack("<Q", head)
        if n > size - 8:
            raise ValueError(f"{path}: header length {n} exceeds the file")
        header = json.loads(f.read(n))
    metadata = header.pop("__metadata__", None) or {}
    data_len = size - 8 - n
    for name, entry in header.items():
        if entry["dtype"] not in DTYPES:
            raise ValueError(f"{path}: {name} has dtype {entry['dtype']}; "
                             f"this reader takes {sorted(DTYPES)}")
        begin, end = entry["data_offsets"]
        want = int(np.prod(entry["shape"], dtype=np.int64)) * \
            DTYPES[entry["dtype"]].itemsize
        if end - begin != want or not 0 <= begin <= end <= data_len:
            raise ValueError(f"{path}: {name} has offsets {begin}-{end} for "
                             f"{want} bytes in {data_len} bytes of data")
    return header, metadata, 8 + n


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a file, as CPU tensors backed by a map of the file."""
    header, _, start = read_header(path)
    if not header:
        return {}
    # copy-on-write: a writable buffer for torch.frombuffer; the file is
    # never written
    mm = np.memmap(path, dtype=np.uint8, mode="c")
    out: Dict[str, torch.Tensor] = {}
    for name, entry in header.items():
        dtype = DTYPES[entry["dtype"]]
        raw = _RAW.get(dtype, dtype)
        begin, end = entry["data_offsets"]
        count = (end - begin) // raw.itemsize
        t = (torch.frombuffer(mm, dtype=raw, count=count,
                              offset=start + begin) if count
             else torch.empty(0, dtype=raw))
        out[name] = t.view(dtype).reshape(entry["shape"])
    return out


def load_dir(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of every `*.safetensors` file in a directory, in the
    order of the file names (a later file's tensor replaces an earlier
    one's of the same name)."""
    tensors: Dict[str, torch.Tensor] = {}
    for name in sorted(os.listdir(path)):
        if not name.endswith(".safetensors"):
            continue
        tensors.update(load_file(os.path.join(path, name)))
    if not tensors:
        raise FileNotFoundError(f"no .safetensors under {path}")
    return tensors
