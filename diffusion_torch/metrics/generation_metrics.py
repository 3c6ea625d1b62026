"""Per-guidance-scale generation metrics for the eval loop.

Counterpart of `diffusion_tpu/metrics/generation_metrics.py` (the
reference's eval_forward + update_metric wiring: one metric copy per
guidance scale, named '<Metric>-scale-<g>'; one image batch per scale with
the fixed `val_seed`; real and fake images into FID, fakes into IS, fakes
and the batch's caption ids into CLIPScore).

`Trainer.eval` calls `eval_batch` for every eval batch and `eval_end` once
per evaluator, which computes and resets. The towers come from
`metrics/towers.py` on the model's device, each loaded once per hook (one
InceptionV3 for FID and IS) and held only by the hook's metrics, as the
JAX hook holds its tower functions: `close()` (which `Trainer.close`
calls) or dropping the hook frees them. The initial
noise of a batch is `latents_fn(batch_index, shape)` where given (the
tests hand it the JAX package's draws: JAX draws
`normal(key(val_seed), shape)` for every batch, and threefry is not
torch's generator), else `generate`'s own draw from `val_seed`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import torch

from diffusion_torch.metrics import towers
from diffusion_torch.metrics.base import scale_suffix
from diffusion_torch.metrics.clip_score import CLIPScore
from diffusion_torch.metrics.fid import FrechetInceptionDistance
from diffusion_torch.metrics.inception_score import InceptionScore

__all__ = ["GenerationMetricsHook", "GENERATION_METRICS"]

GENERATION_METRICS = ("FrechetInceptionDistance", "InceptionScore",
                      "CLIPScore")
LatentsFn = Callable[[int, tuple], torch.Tensor]


class GenerationMetricsHook:
    def __init__(self, model: Any, guidance_scales: Sequence[float],
                 metric_names: Sequence[str] = ("FrechetInceptionDistance",),
                 height: int = 256, width: int = 256,
                 num_inference_steps: int = 50,
                 inception_weights: Optional[str] = None,
                 clip_weights: Optional[str] = None,
                 allow_random_weights: bool = False,
                 latents_fn: Optional[LatentsFn] = None):
        self.model = model
        self.guidance_scales = [float(g) for g in guidance_scales]
        self.height, self.width = height, width
        self.num_inference_steps = num_inference_steps
        self.latents_fn = latents_fn
        # Trainer.eval skips the sampling pass for an evaluator that names
        # none of these
        self.metric_names = tuple(metric_names)
        want = set(metric_names)
        kw = dict(allow_random_weights=allow_random_weights,
                  device=model.device)
        feature_fn = logits_fn = embed_fn = None
        if want & {"FrechetInceptionDistance", "InceptionScore"}:
            # one InceptionV3 for the features and the logits
            inception = towers.inception_tower(inception_weights, **kw)
            if "FrechetInceptionDistance" in want:
                feature_fn = towers.inception_feature_fn(tower=inception)
            if "InceptionScore" in want:
                logits_fn = towers.inception_logits_fn(tower=inception)
        if "CLIPScore" in want:
            embed_fn = towers.clip_embed_fn(clip_weights, **kw)
        self.metrics: Dict[float, Dict[str, Any]] = {}
        for g in self.guidance_scales:
            copies: Dict[str, Any] = {}
            if feature_fn:
                copies["FrechetInceptionDistance"] = \
                    FrechetInceptionDistance(feature_fn)
            if logits_fn:
                copies["InceptionScore"] = InceptionScore(logits_fn)
            if embed_fn:
                copies["CLIPScore"] = CLIPScore(embed_fn)
            self.metrics[g] = copies

    # ---- Trainer.eval protocol -----------------------------------------
    def eval_batch(self, trainer, evaluator, state,
                   batch: Dict[str, torch.Tensor], index: int) -> None:
        if not self.guidance_scales:
            return
        real = batch.get("image")
        captions = batch["captions"]
        valid = batch.get("_valid")
        if valid is not None:
            # padded rows trail the real ones
            n = int(torch.as_tensor(valid).sum())
            real = None if real is None else real[:n]
            captions = captions[:n]
        shape = (captions.shape[0], self.height // 8, self.width // 8,
                 self.model.vae.config.latent_channels)
        for g, copies in self.metrics.items():
            latents = (self.latents_fn(index, shape) if self.latents_fn
                       else None)
            fake = self.model.generate(
                captions, height=self.height, width=self.width,
                guidance_scale=g,
                num_inference_steps=self.num_inference_steps,
                seed=self.model.val_seed, latents=latents)
            if "FrechetInceptionDistance" in copies and real is not None:
                copies["FrechetInceptionDistance"].update(real, real=True)
                copies["FrechetInceptionDistance"].update(fake, real=False)
            if "InceptionScore" in copies:
                copies["InceptionScore"].update(fake)
            if "CLIPScore" in copies:
                copies["CLIPScore"].update(fake, captions)

    def close(self) -> None:
        """Drop the metrics and, with them, the towers: nothing of the
        hook keeps a tower after this."""
        self.metrics = {}

    def eval_end(self, trainer, evaluator, state) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for g, copies in self.metrics.items():
            for name, metric in copies.items():
                key = f"metrics/{evaluator.label}/{scale_suffix(name, g)}"
                out[key] = metric.compute()
                metric.reset()
        return out
