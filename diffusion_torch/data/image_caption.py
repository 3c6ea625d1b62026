"""Generic streaming image-caption dataset + dataloader builder.

A copy of `diffusion_tpu/data/image_caption.py`, which imports no jax, with its
imports pointed at the port's modules: the port imports nothing of
the JAX package.

The equivalent of the reference's StreamingImageCaptionDataset
(reference: diffusion/datasets/image_caption.py): JPEG-bytes decode -> RGB
(ref :79-83), transform, caption dropout with prob `caption_drop_prob`
(ref :88-89), first-vs-random caption selection (ref :92-95), CLIP tokenize
to fixed 77 ids (ref :96-100); builder wires Stream-per-(remote,local) pairs
(ref :154-157) with the default LargestCenterSquare -> [-1,1] transform
(ref :160-166).
"""

from __future__ import annotations

import io
import os
import random
from typing import Any, Callable, Dict, Optional, Sequence, Union

import numpy as np
from PIL import Image

from diffusion_torch.data.dataloader import DataLoader
from diffusion_torch.data.native import jpeg_decode_square
from diffusion_torch.data.streaming import Stream, StreamingDataset
from diffusion_torch.data.transforms import SDSquareNormalize
from diffusion_torch.text.tokenizer import CLIPTokenizer, tiny_tokenizer

__all__ = ["StreamingImageCaptionDataset", "build_streaming_image_caption_dataloader"]


class StreamingImageCaptionDataset(StreamingDataset):
    def __init__(self, *,
                 tokenizer: Optional[Any] = None,
                 tokenizer_name_or_path: Optional[str] = None,
                 caption_drop_prob: float = 0.0,
                 caption_selection: str = "first",
                 transform: Optional[Callable] = None,
                 image_key: str = "image",
                 caption_key: str = "caption",
                 image_size: int = 256,
                 **streaming_kwargs: Any):
        super().__init__(**streaming_kwargs)
        if tokenizer is None:
            tokenizer = (CLIPTokenizer.from_pretrained(tokenizer_name_or_path)
                         if tokenizer_name_or_path else tiny_tokenizer())
        self.tokenizer = tokenizer
        self.caption_drop_prob = float(caption_drop_prob)
        if caption_selection not in ("first", "random"):
            raise ValueError(f"caption_selection must be first|random, got "
                             f"{caption_selection}")
        self.caption_selection = caption_selection
        self.transform = transform
        if self.transform is None:
            # module-level callable (not a closure) so the dataset pickles
            # into process-pool decode workers
            self.transform = SDSquareNormalize(image_size)
        self.image_key = image_key
        self.caption_key = caption_key

    def _decode_image(self, raw: Union[bytes, Image.Image]) -> Image.Image:
        if isinstance(raw, Image.Image):
            img = raw
        else:
            # same tolerance as the wds decode path (datapipes.decode_sample;
            # reference wds_datapipe.py:31): a truncated JPEG in a
            # web-scraped shard must not kill the whole fit
            from PIL import ImageFile
            ImageFile.LOAD_TRUNCATED_IMAGES = True
            img = Image.open(io.BytesIO(raw))
            # decode at a reduced DCT scale when the source is much larger
            # than the train resolution (libjpeg 1/2..1/8 scaling) — the
            # decoder then touches a fraction of the pixels. Keep >= 2x the
            # target so the LANCZOS resize still has headroom; draft() is a
            # no-op for non-JPEGs and never upscales.
            if img.format == "JPEG":
                t = 2 * self.transform.size if hasattr(
                    self.transform, "size") else None
                if t:
                    img.draft("RGB", (t, t))
        return img.convert("RGB")

    def _pick_caption(self, captions: Any) -> str:
        if isinstance(captions, (list, tuple)):
            if not captions:
                return ""
            if self.caption_selection == "first":
                return str(captions[0])
            return str(random.choice(captions))
        return str(captions)

    def process_sample(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        raw = sample[self.image_key]
        image = None
        if (isinstance(raw, (bytes, bytearray))
                and type(self.transform) is SDSquareNormalize
                and os.environ.get("DIFFUSION_TORCH_NATIVE_JPEG", "1") == "1"):
            # fused native decode->crop->resize->normalize (csrc/dataio.cpp
            # jpeg_decode_square): one GIL-releasing C call replaces
            # PIL draft + LargestCenterSquare + normalize, ~2x per core on
            # 512px+ sources. Returns None (corrupt/CMYK/non-JPEG/no lib)
            # -> the tolerant PIL path below.
            image = jpeg_decode_square(bytes(raw), self.transform.size)
        if image is None:
            img = self._decode_image(raw)
            image = self.transform(img)
        if self.caption_drop_prob and random.random() < self.caption_drop_prob:
            caption = ""
        else:
            caption = self._pick_caption(sample[self.caption_key])
        ids = self.tokenizer(caption)["input_ids"][0]
        return {"image": np.asarray(image, np.float32),
                "captions": ids.astype(np.int32)}


def build_streaming_image_caption_dataloader(
    remote: Union[str, Sequence[str]],
    local: Union[str, Sequence[str], None] = None,
    batch_size: int = 8,
    tokenizer_name_or_path: Optional[str] = None,
    caption_drop_prob: float = 0.0,
    caption_selection: str = "first",
    resize_size: int = 256,
    transform: Optional[Callable] = None,
    image_key: str = "image",
    caption_key: str = "caption",
    drop_last: bool = True,
    shuffle: bool = True,
    num_workers: int = 8,
    prefetch_factor: int = 2,
    persistent_workers: bool = True,
    worker_type: str = "auto",
    pin_memory: bool = True,
    download_timeout: float = 120.0,
    download_retry: int = 2,
    num_canonical_nodes: Optional[int] = None,
    predownload: Optional[int] = None,
    validate_hash: Optional[str] = None,
    keep_zip: bool = False,
    **_: Any,
) -> DataLoader:
    """Builder parity with the reference (image_caption.py:105-189); the
    `batch_size` here is already per-host (train.py divides the global)."""
    remotes = [remote] if isinstance(remote, str) else list(remote)
    locals_ = ([local] if isinstance(local, str) else list(local)) \
        if local else [None] * len(remotes)
    if len(locals_) != len(remotes):
        # zip() would silently truncate and train on a subset of the streams
        raise ValueError(f"got {len(remotes)} remotes but {len(locals_)} "
                         f"locals — the lists must pair 1:1")
    streams = [Stream(r, l) for r, l in zip(remotes, locals_)]
    dataset = StreamingImageCaptionDataset(
        streams=streams, shuffle=shuffle,
        tokenizer_name_or_path=tokenizer_name_or_path,
        caption_drop_prob=caption_drop_prob,
        caption_selection=caption_selection, transform=transform,
        image_key=image_key, caption_key=caption_key, image_size=resize_size,
        download_retry=download_retry, download_timeout=download_timeout,
        num_canonical_nodes=num_canonical_nodes, predownload=predownload,
        validate_hash=validate_hash, keep_zip=keep_zip,
        batch_size=batch_size)
    return DataLoader(dataset, batch_size=batch_size, drop_last=drop_last,
                      num_workers=num_workers, prefetch_factor=prefetch_factor,
                      persistent_workers=persistent_workers,
                      pin_memory=pin_memory, worker_type=worker_type)
