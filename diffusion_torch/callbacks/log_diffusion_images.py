"""LogDiffusionImages: generate a fixed prompt list during eval and log the
images.

Counterpart of `diffusion_tpu/callbacks/log_diffusion_images.py` (the
reference callback): on the first eval batch only, tokenize the prompts
once, generate with the model's sampler, and send one image per prompt to
every logger.
"""

from __future__ import annotations

from typing import Sequence

import torch

from diffusion_torch.train.events import Callback

__all__ = ["LogDiffusionImages"]


class LogDiffusionImages(Callback):
    def __init__(self, prompts: Sequence[str] = ("a majestic lion",),
                 size: int = 256, guidance_scale: float = 0.0,
                 num_inference_steps: int = 50, seed: int = 1138):
        self.prompts = list(prompts)
        self.size = size
        self.guidance_scale = guidance_scale
        self.num_inference_steps = num_inference_steps
        self.seed = seed
        self._tokenized = None

    def eval_batch_end(self, state, logger) -> None:
        if state.eval_batch_idx != 0:       # the first eval batch only
            return
        model = state.model
        if self._tokenized is None:
            self._tokenized = torch.from_numpy(
                model.tokenizer(self.prompts)["input_ids"])
        images = model.generate(
            self._tokenized, height=self.size, width=self.size,
            guidance_scale=self.guidance_scale,
            num_inference_steps=self.num_inference_steps, seed=self.seed)
        for prompt, img in zip(self.prompts, images.float().cpu().numpy()):
            logger.log_images(img, name=prompt, step=state.timestamp.batch)
