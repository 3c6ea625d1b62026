"""WebDataset tar-shard dataloader builder.

A copy of `diffusion_tpu/data/wds.py`, which imports no jax, with its
imports pointed at the port's modules: the port imports nothing of
the JAX package.

The equivalent of the reference's fork-added wds datapipe builder
(reference: diffusion/datasets/wds/wds_datapipe.py:163-251
`build_wds_dataloader`): shard list from dir or JSON manifest, the
tar->rename->decode->filter->shuffle->shard->transform->tokenize->batch->
fullsync graph (see data/datapipes.py), caption dropout, and the
CenterCropSDTransform default.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Union

import numpy as np

from diffusion_torch.data.datapipes import WdsPipeline, list_shards
from diffusion_torch.data.filters import load_filter_strategy
from diffusion_torch.data.transforms import CenterCropSDTransform
from diffusion_torch.text.tokenizer import CLIPTokenizer, tiny_tokenizer

__all__ = ["build_wds_dataloader", "make_sd_sample_transform"]


def make_sd_sample_transform(tokenizer: Any, size: int = 256,
                             caption_drop_prob: float = 0.0,
                             caption_key_candidates: Sequence[str] = (
                                 "txt", "text", "caption"),
                             transform: Optional[Callable] = None
                             ) -> Callable[[Dict[str, Any]], Dict[str, Any]]:
    """sample dict (PIL image + caption) -> {'image': f32 HWC, 'captions': ids}
    (reference wds_datapipe.py:149-159 transform/tokenize maps + slice)."""
    img_transform = transform or CenterCropSDTransform(size=size)

    def fn(sample: Dict[str, Any]) -> Dict[str, Any]:
        image = np.asarray(img_transform(sample["image"]), np.float32)
        caption = ""
        if not (caption_drop_prob and random.random() < caption_drop_prob):
            for key in caption_key_candidates:
                if sample.get(key):
                    caption = str(sample[key])
                    break
        ids = tokenizer(caption)["input_ids"][0].astype(np.int32)
        return {"image": image, "captions": ids}

    return fn


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
    num_workers: int = 8,          # accepted for yaml parity; decode runs in
    prefetch_factor: int = 2,      # the loader pool at iteration time
    **_: Any,
) -> WdsPipeline:
    """Builder parity with the reference (wds_datapipe.py:163-251)."""
    tokenizer = (CLIPTokenizer.from_pretrained(tokenizer_name_or_path)
                 if tokenizer_name_or_path else tiny_tokenizer())
    shards = list_shards(urls or [], manifest=meta_json)
    fn = make_sd_sample_transform(tokenizer, size=resize_size,
                                  caption_drop_prob=caption_drop_prob,
                                  transform=transform)
    return WdsPipeline(shards, fn, batch_size=batch_size,
                       filter_strategy=load_filter_strategy(filter_strategy),
                       shuffle=shuffle, shuffle_buffer=shuffle_buffer,
                       seed=seed, drop_last=drop_last,
                       draft_size=resize_size)
