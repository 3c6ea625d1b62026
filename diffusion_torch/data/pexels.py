"""Pexels/Midjourney-style JSON-manifest image dataloader.

A copy of `diffusion_tpu/data/pexels.py` with its imports pointed at the
port's modules (the port imports nothing of the JAX package), and jax's
process count and index replaced by torch.distributed's
(`rank_and_world`).

The equivalent of the reference's fork-added pexels datapipe
(reference: diffusion/datasets/pexels/pexels_datapipe.py): a JSON manifest
listing per-sample JSON records (ref :115-117); image fetch = random choice
among `local_paths` with object-store fallback + exponential backoff x3
(ref :40-69); caption synthesis = random prompt + up to 5 random tags + the
literal suffix 'raw data' (ref :72-101); then the shared filter/shuffle/
shard/batch/fullsync tail.
"""

from __future__ import annotations

import io
import json
import random
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Sequence, Union

import numpy as np
from PIL import Image

from diffusion_torch.data.datapipes import (apply_sharding, batcher, filter_samples,
                                          length_sync, map_samples,
                                          sample_shuffle)
from diffusion_torch.data.filters import load_filter_strategy
from diffusion_torch.data.object_store import ObjectStore, retry
from diffusion_torch.data.transforms import CenterCropSDTransform
from diffusion_torch.text.tokenizer import CLIPTokenizer, tiny_tokenizer
from diffusion_torch.utils.device import rank_and_world

__all__ = ["load_image", "load_caption", "ImgPipeline", "build_pexels_dataloader"]


def load_image(record: Mapping[str, Any], store: ObjectStore,
               rng: random.Random) -> Optional[Image.Image]:
    """Random choice among local_paths, falling back to the object store with
    retry (reference pexels_datapipe.py:40-69). None on failure (tolerated)."""
    paths: List[str] = list(record.get("local_paths") or [])
    if record.get("path"):
        paths.append(record["path"])
    if not paths:
        return None
    path = rng.choice(paths)
    try:
        data = retry(lambda: store.get(path), max_tries=3)
        return Image.open(io.BytesIO(data)).convert("RGB")
    except Exception:
        return None


def load_caption(record: Mapping[str, Any], rng: random.Random,
                 max_tags: int = 5) -> str:
    """Synthesized caption: one random prompt + <=5 random tags + 'raw data'
    (reference pexels_datapipe.py:72-101)."""
    parts: List[str] = []
    prompts = record.get("prompts") or record.get("prompt")
    if isinstance(prompts, str):
        parts.append(prompts)
    elif prompts:
        parts.append(str(rng.choice(list(prompts))))
    tags = list(record.get("tags") or [])
    if tags:
        rng.shuffle(tags)
        parts.extend(str(t) for t in tags[:max_tags])
    parts.append("raw data")
    return ", ".join(p for p in parts if p)


class ImgPipeline:
    """Manifest-of-JSONs pipeline (reference ImgDatapipe) with the shared
    shuffle/shard/filter/batch/fullsync tail."""

    def __init__(self, records: Sequence[Mapping[str, Any]], transform: Callable,
                 tokenizer: Any, batch_size: int,
                 filter_strategy: Optional[Mapping] = None,
                 caption_drop_prob: float = 0.0, seed: int = 42,
                 shuffle: bool = True, shuffle_buffer: int = 1000,
                 drop_last: bool = True, store: Optional[ObjectStore] = None):
        self.records = list(records)
        self.transform = transform
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.filter_strategy = filter_strategy
        self.caption_drop_prob = caption_drop_prob
        self.seed = seed
        self.shuffle = shuffle
        self.shuffle_buffer = shuffle_buffer
        self.drop_last = drop_last
        self.store = store or ObjectStore()
        self._epoch = 0

    def _sample(self, record: Mapping[str, Any],
                rng: random.Random) -> Optional[Dict[str, Any]]:
        img = load_image(record, self.store, rng)
        if img is None:
            return None
        caption = "" if (self.caption_drop_prob
                         and rng.random() < self.caption_drop_prob) \
            else load_caption(record, rng)
        ids = self.tokenizer(caption)["input_ids"][0].astype(np.int32)
        return {"image": np.asarray(self.transform(img), np.float32),
                "captions": ids}

    def __iter__(self) -> Iterator[Any]:
        epoch = self._epoch
        self._epoch += 1
        rng = random.Random(f"{self.seed}-{epoch}")
        records: Any = list(self.records)
        if self.shuffle:
            rng.shuffle(records)
        rank, world = rank_and_world()
        records = apply_sharding(records, world, rank)
        records = filter_samples(records, self.filter_strategy)
        samples = map_samples(records, lambda r: self._sample(r, rng))
        if self.shuffle:
            samples = sample_shuffle(samples, self.shuffle_buffer,
                                     seed=self.seed + epoch)
        batches = batcher(samples, self.batch_size, self.drop_last)
        return length_sync(batches)


def build_pexels_dataloader(
    meta_json: str,
    batch_size: int = 8,
    tokenizer_name_or_path: Optional[str] = None,
    caption_drop_prob: float = 0.0,
    resize_size: int = 256,
    transform: Optional[Callable] = None,
    filter_strategy: Union[str, Mapping[str, Any], None] = None,
    shuffle: bool = True,
    shuffle_buffer: int = 1000,
    seed: int = 42,
    drop_last: bool = True,
    download_retry: int = 2,
    download_timeout: float = 120.0,
    **_: Any,
) -> ImgPipeline:
    """Builder parity with the reference (pexels_datapipe.py:152-243)."""
    with open(meta_json) as f:
        manifest = json.load(f)
    records = manifest["samples"] if isinstance(manifest, dict) else manifest
    # manifest may list paths to per-sample JSON files (ref :115-117)
    if records and isinstance(records[0], str):
        loaded = []
        for p in records:
            try:
                with open(p) as f:
                    loaded.append(json.load(f))
            except Exception:
                continue
        records = loaded
    tokenizer = (CLIPTokenizer.from_pretrained(tokenizer_name_or_path)
                 if tokenizer_name_or_path else tiny_tokenizer())
    return ImgPipeline(
        records, transform or CenterCropSDTransform(size=resize_size),
        tokenizer, batch_size=batch_size,
        filter_strategy=load_filter_strategy(filter_strategy),
        caption_drop_prob=caption_drop_prob, seed=seed, shuffle=shuffle,
        shuffle_buffer=shuffle_buffer, drop_last=drop_last,
        store=ObjectStore(download_retry, download_timeout))
