"""WebDataset tar-shard dataloader builder.

A copy of `diffusion_tpu/data/wds.py`, which imports no jax, with its
imports pointed at the port's modules: the port imports nothing of
the JAX package.

The equivalent of the reference's fork-added wds datapipe builder
(reference: diffusion/datasets/wds/wds_datapipe.py:163-251
`build_wds_dataloader`): shard list from dir or JSON manifest, the
tar->rename->decode->filter->shuffle->shard->transform->tokenize->batch->
fullsync graph (see data/datapipes.py), caption dropout, and the
CenterCropSDTransform default. `num_workers` loader processes decode,
crop and resize the images; `num_workers: 0` does it on the iterating
thread.
"""

from __future__ import annotations

import functools
import random
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Union

import numpy as np

from diffusion_torch.data.datapipes import WdsPipeline, list_shards
from diffusion_torch.data.filters import load_filter_strategy
from diffusion_torch.data.transforms import CenterCropSDTransform
from diffusion_torch.text.tokenizer import CLIPTokenizer, tiny_tokenizer

__all__ = ["build_wds_dataloader", "SDSampleTransform"]


class SDSampleTransform:
    """sample dict (PIL image + caption) -> {'image': f32 HWC, 'captions': ids}
    (reference wds_datapipe.py:149-159 transform/tokenize maps + slice).

    In two halves, for `WdsPipeline`'s loader workers: `image_fn`, PIL image
    -> array (the default `CenterCropSDTransform`'s uint8 crop, or a given
    `transform` whole), and `finish`, the sample with `image_fn`'s array ->
    the float image, the caption (with caption dropout's draw from the
    global `random`) and its token ids. Calling it runs both."""

    def __init__(self, tokenizer: Any, size: int = 256,
                 caption_drop_prob: float = 0.0,
                 caption_key_candidates: Sequence[str] = (
                     "txt", "text", "caption"),
                 transform: Optional[Callable] = None):
        self.tokenizer = tokenizer
        self.caption_drop_prob = caption_drop_prob
        self.caption_key_candidates = caption_key_candidates
        if transform is None:
            crop = CenterCropSDTransform(size=size)
            self.image_fn, self._to_float = crop.crop, crop.scale
        else:
            self.image_fn = transform
            self._to_float = functools.partial(np.asarray, dtype=np.float32)

    def __call__(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        return self.finish({**sample, "image": self.image_fn(sample["image"])})

    def finish(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        image = self._to_float(sample["image"])
        caption = ""
        if not (self.caption_drop_prob
                and random.random() < self.caption_drop_prob):
            for key in self.caption_key_candidates:
                if sample.get(key):
                    caption = str(sample[key])
                    break
        ids = self.tokenizer(caption)["input_ids"][0].astype(np.int32)
        return {"image": image, "captions": ids}


def build_wds_dataloader(
    urls: Union[str, Sequence[str], None] = None,
    meta_json: Optional[str] = None,
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
    num_workers: int = 8,          # loader processes for decode and crop
    prefetch_factor: int = 2,      # batches of samples in flight to them
    **_: Any,
) -> WdsPipeline:
    """Builder parity with the reference (wds_datapipe.py:163-251)."""
    tokenizer = (CLIPTokenizer.from_pretrained(tokenizer_name_or_path)
                 if tokenizer_name_or_path else tiny_tokenizer())
    shards = list_shards(urls or [], manifest=meta_json)
    fn = SDSampleTransform(tokenizer, size=resize_size,
                           caption_drop_prob=caption_drop_prob,
                           transform=transform)
    return WdsPipeline(shards, fn, batch_size=batch_size,
                       filter_strategy=load_filter_strategy(filter_strategy),
                       shuffle=shuffle, shuffle_buffer=shuffle_buffer,
                       seed=seed, drop_last=drop_last,
                       draft_size=resize_size, num_workers=num_workers,
                       prefetch_factor=prefetch_factor)
