"""The reference's own read of a raw-image cell's tar shards, independent
of the program's reader (`diffusion_torch/data/`).

A sample is a `<key>.jpg` and a `<key>.txt` member. Its caption is
tokenized with the reference tokenizer (`tiny_tokenizer()`, 77 positions);
its JPEG is decoded with PIL in RGB, centre-cropped to the largest square,
resized bicubically to `side` x `side` and scaled to [-1, 1], as the SD
wds recipe's `CenterCropSDTransform` specifies.

The program shuffles shards and samples with its own generator, so the
reference finds each row of a program batch by its token ids: the
shards' captions are distinct (words drawn from the seed), and a row
whose ids match no caption's reference tokens is a row the reference
cannot follow (`pixels` reads 2, the range of the scale, for it). The
check allows the program's pixels one 8-bit level (`PIXELS_LIMIT`) from
the reference's: a limit of the decode's definition, not of a precision.
"""

from __future__ import annotations

import io
import tarfile
from typing import Dict, List, Sequence, Tuple

import numpy as np

from portbench.reference.tokenizer import tiny_tokenizer

__all__ = ["Shards", "decode", "pixel_gap", "NO_MATCH", "PIXELS_LIMIT"]

NO_MATCH = 2.0      # the [-1, 1] scale's range
PIXELS_LIMIT = 1 / 127.5


def decode(jpeg: bytes, side: int) -> np.ndarray:
    """(side, side, 3) float32 in [-1, 1]: RGB, the largest centred square,
    bicubic resize."""
    from PIL import Image
    img = np.asarray(Image.open(io.BytesIO(jpeg)).convert("RGB"))
    h, w = img.shape[:2]
    sq = min(h, w)
    top, left = (h - sq) // 2, (w - sq) // 2
    img = Image.fromarray(img[top:top + sq, left:left + sq])
    img = img.resize((side, side), Image.BICUBIC)
    return np.asarray(img, dtype=np.float32) / 127.5 - 1.0


class Shards:
    """The shards' samples, indexed by their captions' reference token
    ids."""

    def __init__(self, paths: Sequence[str]):
        tok = tiny_tokenizer()
        captions: Dict[str, str] = {}
        self.jpegs: Dict[str, Tuple[str, str]] = {}
        for path in paths:
            with tarfile.open(path) as tar:
                for m in tar.getmembers():
                    key, _, ext = m.name.rpartition(".")
                    if ext == "txt":
                        captions[key] = tar.extractfile(m).read().decode()
                    elif ext == "jpg":
                        self.jpegs[key] = (path, m.name)
        self.by_ids: Dict[bytes, str] = {}
        for key, text in captions.items():
            ids = tok(text)["input_ids"][0].astype(np.int64)
            self.by_ids[ids.tobytes()] = key

    def _jpeg(self, key: str) -> bytes:
        path, name = self.jpegs[key]
        with tarfile.open(path) as tar:
            return tar.extractfile(name).read()

    def batch(self, ids: np.ndarray, side: int
              ) -> Tuple[np.ndarray, np.ndarray, List[bool]]:
        """The images (B, side, side, 3) and token ids (B, 77) of the
        samples whose captions the rows of `ids` are, and which rows were
        found; a row not found keeps its ids and a zero image."""
        images = np.zeros((len(ids), side, side, 3), np.float32)
        out = np.asarray(ids, np.int64).copy()
        found = []
        for r, row in enumerate(out):
            key = self.by_ids.get(row.tobytes())
            found.append(key is not None)
            if key is not None:
                images[r] = decode(self._jpeg(key), side)
        return images, out, found


def pixel_gap(program: np.ndarray, reference: np.ndarray,
              found: Sequence[bool]) -> float:
    """The largest |program - reference| pixel gap over the rows found;
    `NO_MATCH` where a row was not found."""
    if not all(found):
        return NO_MATCH
    return float(np.max(np.abs(program.astype(np.float32) - reference)))
