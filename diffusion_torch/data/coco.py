"""Streaming COCO-2014-val captions dataset for FID/CLIP eval.

A copy of `diffusion_tpu/data/coco.py`, which imports no jax, with its
imports pointed at the port's modules: the port imports nothing of
the JAX package.

The equivalent of the reference's StreamingCOCOCaption (reference:
diffusion/datasets/coco/coco_captions.py): crop-vs-resize choice `use_crop`
(ref :105-108), NO normalization — FID consumes [0,1] images (ref :106-108),
first/random caption among the sample's list (ref :83-88). MDS columns:
{image: jpeg bytes, captions: json list} (written by scripts/convert_coco.py,
ref convert_coco.py:55-61).
"""

from __future__ import annotations

import io
import random
from typing import Any, Dict, Optional

import numpy as np
from PIL import Image

from diffusion_torch.data.dataloader import DataLoader
from diffusion_torch.data.streaming import Stream, StreamingDataset
from diffusion_torch.data.transforms import LargestCenterSquare, to_tensor
from diffusion_torch.text.tokenizer import CLIPTokenizer, tiny_tokenizer

__all__ = ["StreamingCOCOCaption", "build_streaming_cocoval_dataloader"]


class StreamingCOCOCaption(StreamingDataset):
    def __init__(self, *, resize_size: int = 256, use_crop: bool = True,
                 caption_selection: str = "first",
                 tokenizer: Optional[Any] = None,
                 tokenizer_name_or_path: Optional[str] = None,
                 **streaming_kwargs: Any):
        super().__init__(**streaming_kwargs)
        self.resize_size = resize_size
        self.use_crop = use_crop
        self.caption_selection = caption_selection
        if tokenizer is None:
            tokenizer = (CLIPTokenizer.from_pretrained(tokenizer_name_or_path)
                         if tokenizer_name_or_path else tiny_tokenizer())
        self.tokenizer = tokenizer

    def process_sample(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        img = Image.open(io.BytesIO(sample["image"])).convert("RGB")
        if self.use_crop:
            img = LargestCenterSquare(self.resize_size)(img)
        else:
            img = img.resize((self.resize_size, self.resize_size), Image.BICUBIC)
        captions = sample["captions"]
        if isinstance(captions, (list, tuple)) and captions:
            caption = (captions[0] if self.caption_selection == "first"
                       else random.choice(captions))
        else:
            caption = str(captions)
        ids = self.tokenizer(str(caption))["input_ids"][0]
        # [0,1] image for FID (no +-1 normalization, ref :106-108)
        return {"image": to_tensor(img), "captions": ids.astype(np.int32)}


def build_streaming_cocoval_dataloader(
    remote: str,
    local: Optional[str] = None,
    batch_size: int = 8,
    resize_size: int = 256,
    use_crop: bool = True,
    caption_selection: str = "first",
    tokenizer_name_or_path: Optional[str] = None,
    drop_last: bool = False,
    shuffle: bool = False,
    num_workers: int = 8,
    prefetch_factor: int = 2,
    persistent_workers: bool = True,
    worker_type: str = "auto",
    pin_memory: bool = True,
    **_: Any,
) -> DataLoader:
    """Builder parity with the reference (coco_captions.py:93-122)."""
    dataset = StreamingCOCOCaption(
        streams=[Stream(remote, local)], shuffle=shuffle,
        resize_size=resize_size, use_crop=use_crop,
        caption_selection=caption_selection,
        tokenizer_name_or_path=tokenizer_name_or_path, batch_size=batch_size)
    return DataLoader(dataset, batch_size=batch_size, drop_last=drop_last,
                      num_workers=num_workers, prefetch_factor=prefetch_factor,
                      persistent_workers=persistent_workers,
                      pin_memory=pin_memory, worker_type=worker_type)
