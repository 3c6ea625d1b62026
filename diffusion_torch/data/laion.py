"""Streaming LAION dataset with precomputed-latent columns.

A copy of `diffusion_tpu/data/laion.py`, which imports no jax, with its
imports pointed at the port's modules: the port imports nothing of
the JAX package.

The equivalent of the reference's StreamingLAIONDataset (reference:
diffusion/datasets/laion/laion.py): the image-caption pattern plus
precomputed fp16 latent columns — `caption_latents` -> (77, 1024),
`latents_256` -> (4, 32, 32), `latents_512` -> (4, 64, 64) selected by
image_size (ref :102-112) — and streaming knobs predownload/download_retry/
download_timeout/num_canonical_nodes (ref :43-74), optional `num_samples`
subset (ref :182-184).

Latents are stored NCHW fp16 bytes by the precompute tool (reference
precompute_latents.py); we deliver them NHWC float arrays — the JAX
package's layout — transposing on the host during decode.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Union

import numpy as np

from diffusion_torch.data.dataloader import DataLoader
from diffusion_torch.data.image_caption import StreamingImageCaptionDataset
from diffusion_torch.data.streaming import Stream

__all__ = ["StreamingLAIONDataset", "build_streaming_laion_dataloader"]


class StreamingLAIONDataset(StreamingImageCaptionDataset):
    def __init__(self, *, predownload: Optional[int] = 100_000,
                 image_size: int = 256, precomputed_latents: bool = False,
                 caption_latent_dim: int = 1024, **kwargs: Any):
        # LAION MDS columns: 'jpg' bytes + 'caption' str (+ latent bytes)
        kwargs.setdefault("image_key", "jpg")
        kwargs.setdefault("caption_key", "caption")
        super().__init__(predownload=predownload, image_size=image_size, **kwargs)
        self.image_size = image_size
        self.precomputed_latents = precomputed_latents
        self.caption_latent_dim = caption_latent_dim

    def process_sample(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        latents_key = f"latents_{self.image_size}"
        if self.precomputed_latents and sample.get(latents_key):
            # raw fp16 bytes, stored NCHW (4, s, s) with s = image_size // 8
            s = self.image_size // 8
            lat = np.frombuffer(sample[latents_key], np.float16).reshape(4, s, s)
            cap = np.frombuffer(sample["caption_latents"], np.float16)
            cap = cap.reshape(77, self.caption_latent_dim)
            return {"image_latents": lat.transpose(1, 2, 0).astype(np.float16),
                    "caption_latents": cap}
        return super().process_sample(sample)


def build_streaming_laion_dataloader(
    remote: Union[str, Sequence[str]],
    local: Union[str, Sequence[str], None] = None,
    batch_size: int = 8,
    tokenizer_name_or_path: Optional[str] = None,
    caption_drop_prob: float = 0.0,
    resize_size: int = 256,
    caption_selection: str = "first",
    transform: Optional[Callable] = None,
    precomputed_latents: bool = False,
    drop_last: bool = True,
    shuffle: bool = True,
    num_workers: int = 8,
    prefetch_factor: int = 2,
    persistent_workers: bool = True,
    worker_type: str = "auto",
    pin_memory: bool = True,
    predownload: int = 100_000,
    download_retry: int = 2,
    download_timeout: float = 120.0,
    num_canonical_nodes: Optional[int] = None,
    validate_hash: Optional[str] = None,
    caption_latent_dim: int = 1024,
    num_samples: Optional[int] = None,
    **_: Any,
) -> DataLoader:
    """Builder parity with the reference (laion.py:115-194)."""
    remotes = [remote] if isinstance(remote, str) else list(remote)
    locals_ = ([local] if isinstance(local, str) else list(local)) \
        if local else [None] * len(remotes)
    streams = [Stream(r, l) for r, l in zip(remotes, locals_)]
    dataset = StreamingLAIONDataset(
        streams=streams, shuffle=shuffle,
        tokenizer_name_or_path=tokenizer_name_or_path,
        caption_drop_prob=caption_drop_prob,
        caption_selection=caption_selection, transform=transform,
        image_size=resize_size, precomputed_latents=precomputed_latents,
        caption_latent_dim=caption_latent_dim,
        predownload=predownload, download_retry=download_retry,
        download_timeout=download_timeout, validate_hash=validate_hash,
        num_canonical_nodes=num_canonical_nodes, batch_size=batch_size)
    if num_samples is not None:
        dataset = _Subset(dataset, num_samples)
    return DataLoader(dataset, batch_size=batch_size, drop_last=drop_last,
                      num_workers=num_workers, prefetch_factor=prefetch_factor,
                      persistent_workers=persistent_workers,
                      pin_memory=pin_memory, worker_type=worker_type)


class _Subset:
    """First-n view (reference laion.py:182-184 uses torch Subset)."""

    def __init__(self, dataset: Any, num_samples: int):
        self.dataset = dataset
        self.num_samples = min(int(num_samples), len(dataset))

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, idx: int):
        return self.dataset[idx]

    def partition(self, epoch: int, rank: int, world: int) -> np.ndarray:
        # filtering by id alone would give ranks different lengths (which
        # ids survive varies per rank) — the same multi-host batch-count
        # divergence StreamingDataset.partition pads away. Normalize every
        # rank to exactly ceil(num_samples/world) ids: cycle-pad short
        # ranks (torch DistributedSampler semantics), truncate long ones.
        ids = self.dataset.partition(epoch, rank, world)
        ids = ids[ids < self.num_samples]
        per_rank = max(-(-self.num_samples // world), 1)
        if len(ids) < per_rank:
            fill = ids if len(ids) else np.arange(
                min(self.num_samples, per_rank), dtype=np.int64)
            reps = -(-(per_rank - len(ids)) // len(fill))
            ids = np.concatenate([ids, np.tile(fill, reps)])
        return ids[:per_rank]

    def __getattr__(self, name: str):
        return getattr(self.dataset, name)
