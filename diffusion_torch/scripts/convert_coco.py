"""COCO-2014-val captions -> MDS for the FID/CLIP eval.

A copy of `scripts/convert_coco.py`, which imports no jax, over the port's
`MDSWriter` (`diffusion_torch/data/mds.py`): the port imports nothing of
the JAX package. It parses captions_val2014.json into {image_id:
captions}, takes a fixed-seed random subset (10k by default) and writes
MDS samples {image: jpeg bytes, captions: json list}, byte for byte the
shards the JAX script writes.

  python -m diffusion_torch.scripts.convert_coco \\
      --annotations captions_val2014.json --image-dir val2014/ \\
      --out coco-10k-mds/ --num-samples 10000 --seed 42
"""

from __future__ import annotations

import argparse
import json
import os
import random

from diffusion_torch.data.mds import MDSWriter


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--annotations", required=True)
    p.add_argument("--image-dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--num-samples", type=int, default=10_000)
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args(argv)

    with open(args.annotations) as f:
        anns = json.load(f)

    file_by_id = {img["id"]: img["file_name"] for img in anns["images"]}
    captions_by_id: dict = {}
    for ann in anns["annotations"]:
        captions_by_id.setdefault(ann["image_id"], []).append(ann["caption"])

    ids = sorted(captions_by_id)
    random.Random(args.seed).shuffle(ids)
    ids = ids[:args.num_samples]

    written = 0
    with MDSWriter(args.out, {"image": "bytes", "captions": "json"}) as writer:
        for image_id in ids:
            path = os.path.join(args.image_dir, file_by_id[image_id])
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except FileNotFoundError:
                continue
            writer.write({"image": data, "captions": captions_by_id[image_id]})
            written += 1
    print(f"wrote {written} samples to {args.out}")
    return written


if __name__ == "__main__":
    main()
