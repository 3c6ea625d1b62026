"""The reference's own read of an MDS dataset directory (the layout
`data/mds.py` writes and mosaicml-streaming reads), in a few lines and
without the program's reader: `index.json` lists the shards; a shard is a
u32 sample count, u32 offsets of the samples (count + 1), then each
sample's u32 sizes of its columns followed by the columns' bytes, in the
index's column order. Uncompressed shards whose columns all have
variable sizes, as the program's writer makes them."""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

__all__ = ["read_samples"]


def read_samples(root: str) -> List[Dict[str, bytes]]:
    """Every sample of the dataset at `root`, in shard order, as
    {column: bytes}."""
    with open(os.path.join(root, "index.json")) as f:
        shards = json.load(f)["shards"]
    out = []
    for shard in shards:
        names = shard["column_names"]
        if shard.get("compression") or any(
                s is not None for s in shard["column_sizes"]):
            raise ValueError(f"{shard['raw_data']['basename']}: compressed "
                             f"or fixed-size columns are not read here")
        with open(os.path.join(root, shard["raw_data"]["basename"]),
                  "rb") as f:
            data = f.read()
        n = int(np.frombuffer(data, "<u4", 1, 0)[0])
        offsets = np.frombuffer(data, "<u4", n + 1, 4)
        for i in range(n):
            pos = int(offsets[i])
            sizes = np.frombuffer(data, "<u4", len(names), pos)
            pos += 4 * len(names)
            sample = {}
            for name, size in zip(names, sizes):
                sample[name] = data[pos:pos + int(size)]
                pos += int(size)
            out.append(sample)
    return out
