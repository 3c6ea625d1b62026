"""Text-to-image serving endpoint.

Counterpart of `diffusion_tpu/inference/inference_model.py`: `predict`
parses prompt/negative_prompt/ints/floats, generates, and returns base64
PNGs; `predict_many` merges several mergeable requests into one generate
call, padded to a power-of-two batch. A request with a base64 `image` and
a `strength` is img2img (SDEdit); with a grayscale `mask` as well (white =
regenerate), inpainting. A request may name its `scheduler` (`ddim`,
`dpm++2m` or `dpm`, `euler`) and a `guidance_rescale` in [0, 1]; both join
the batch key, so requests with different samplers never merge. Each
sampler other than the model's own is built once, like the model's (its
betas, prediction type and spacing), over the same modules. PyTorch runs
eagerly, so there is no compile cache; `generate` runs under
`torch.inference_mode()`.

Weights are random (flax-like init from `seed`), published ones
(`pretrained=True, model_name=<local diffusers directory>`, through the
builder), or, with `jax_params`, the JAX package's `(params, frozen)`
trees moved over by `models/port_jax.py`. `checkpoint_path` then replaces
the UNet's weights with a checkpoint's parameters: a Trainer checkpoint
(`ba<N>/`, written EMA-active, so it serves the EMA) or a weights-only
directory holding a bare `params.safetensors`; an `s3://`, `gs://` or
`file://` path is fetched once into a cache (`train/checkpoint.py`). A
checkpoint holds no frozen towers, so one over random towers raises
unless `allow_random_frozen=True`. A LoRA model (`lora_rank=8,
train_lora_only=True` among the builder's keywords, as the JAX endpoint
passes them) takes an adapter checkpoint: its parameters are the
adapters', and they load into the adapters over the base that
`pretrained=True` loaded, as JAX's partial restore of the trainable tree.
"""

from __future__ import annotations

import base64
import dataclasses
import io
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from diffusion_torch.models.models import (_make_inference_scheduler,
                                           canonical_scheduler_name,
                                           stable_diffusion_2)
from diffusion_torch.models.lora import lora_parameters
from diffusion_torch.models.port_jax import (clip_text_from_jax,
                                             unet_from_jax, vae_from_jax)
from diffusion_torch.train.checkpoint import fetch_checkpoint_dir, load_params

__all__ = ["StableDiffusionInference", "image_to_base64_png"]


def image_to_base64_png(image01: np.ndarray) -> str:
    """float [0, 1] HWC -> base64 PNG string (a copy of the JAX module's
    helper, which cannot be imported without jax)."""
    from PIL import Image
    arr = (np.clip(np.asarray(image01), 0, 1) * 255).round().astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


class StableDiffusionInference:
    def __init__(self, checkpoint_path: Optional[str] = None,
                 model_name: Optional[str] = None, pretrained: bool = False,
                 default_size: int = 512, seed: int = 0,
                 allow_random_frozen: bool = False, builder: Any = None,
                 device: Any = None,
                 jax_params: Optional[Tuple[Dict, Dict]] = None,
                 **model_kwargs: Any):
        if checkpoint_path and not (pretrained or jax_params is not None
                                    or allow_random_frozen):
            # a checkpoint restores the UNet only: over random VAE and text
            # towers every request decodes noise
            raise RuntimeError(
                "checkpoint_path given but the frozen VAE/text-encoder "
                "towers are randomly initialized (the checkpoint only "
                "restores the trainable UNet params). Pass pretrained=True "
                "with model_name=<diffusers directory>, or "
                "allow_random_frozen=True for smoke serving where noise "
                "images are fine.")
        builder = builder or stable_diffusion_2
        # device None means CUDA; the builder raises where it is missing
        self.model = builder(model_name=model_name, pretrained=pretrained,
                             device=device, seed=seed, **model_kwargs)
        self.model.unet.eval().requires_grad_(False)     # served, not trained
        if jax_params is not None:
            params, frozen = jax_params
            self.model.unet.load_state_dict(unet_from_jax(params))
            self.model.vae.load_state_dict(vae_from_jax(frozen["vae"]))
            self.model.text_encoder.load_state_dict(
                clip_text_from_jax(frozen["text_encoder"]))
        self.checkpoint_file = None
        if checkpoint_path:
            local = fetch_checkpoint_dir(checkpoint_path)
            # a checkpoint holds what the Trainer trained: the adapters
            # alone when only they required grad
            params = (lora_parameters(self.model.unet)
                      if getattr(self.model, "train_lora_only", False)
                      else dict(self.model.unet.named_parameters()))
            self.checkpoint_file = load_params(local, params)
        self.default_size = default_size
        self.seed = seed
        # sampler name -> the model over that sampler (same modules)
        self._models: Dict[str, Any] = {}

    def _model_for(self, scheduler: Optional[str]):
        """The model whose sampler is `scheduler` (a canonical name, None
        for the model's own), built once per name."""
        if scheduler is None:
            return self.model
        if scheduler not in self._models:
            self._models[scheduler] = dataclasses.replace(
                self.model, inference_scheduler=_make_inference_scheduler(
                    scheduler, like=self.model.inference_scheduler))
        return self._models[scheduler]

    def _normalize_scheduler(self, requested: Any) -> Optional[str]:
        """A request's sampler, canonical (lower case, 'dpm' ->
        'dpm++2m'), or None for the model's own, so equivalent requests
        share one batch key. An unknown name, or a sampler the model's
        schedule refuses (zero terminal SNR), raises ValueError here, a
        client error, not in the batch worker."""
        if not requested:
            return None
        name = canonical_scheduler_name(str(requested))
        if name == canonical_scheduler_name(self.model.inference_scheduler):
            return None
        self._model_for(name)       # built here, once: a refusal raises now
        return name

    def _parse(self, inputs: Dict[str, Any]):
        """-> (prompts, negatives_or_None, images_and_masks, key).
        `images_and_masks` is None or (image_b64s, mask_b64s_or_None).
        Requests with equal keys share one generate call (same program and
        same RNG seed)."""
        prompt = inputs.get("prompt")
        if not prompt:
            raise ValueError("prompt required")
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        negative = inputs.get("negative_prompt")
        negatives = ([negative] * len(prompts) if isinstance(negative, str)
                     else (list(negative) if negative else None))
        if negatives is not None and len(negatives) != len(prompts):
            raise ValueError("negative_prompt count != prompt count")
        g_rescale = float(inputs.get("guidance_rescale", 0.0))
        if not 0.0 <= g_rescale <= 1.0:
            raise ValueError(
                f"guidance_rescale must be in [0, 1], got {g_rescale}")
        steps = int(inputs.get("num_inference_steps", 50))
        image = inputs.get("image")
        images = masks = strength = None
        if image:
            # img2img: one base64 PNG/JPEG per prompt (a single image is
            # broadcast across the request's prompts)
            images = ([image] * len(prompts) if isinstance(image, str)
                      else list(image))
            if len(images) != len(prompts):
                raise ValueError("image count != prompt count")
            strength = float(inputs.get("strength", 0.8))
            if not 0.0 < strength <= 1.0:
                raise ValueError(f"strength must be in (0, 1], got {strength}")
            # generate depends on strength only through init_timestep =
            # int(steps * strength): fold equivalent strengths into one
            # batch key; (k + 0.5) / steps gives back k
            init_t = min(int(steps * strength), steps)
            strength = min(1.0, (init_t + 0.5) / steps)
            mask = inputs.get("mask")
            if mask:
                # inpainting: grayscale base64, white = regenerate
                masks = ([mask] * len(prompts) if isinstance(mask, str)
                         else list(mask))
                if len(masks) != len(prompts):
                    raise ValueError("mask count != prompt count")
        elif "strength" in inputs:
            raise ValueError("strength requires an image (img2img)")
        elif inputs.get("mask"):
            raise ValueError("mask (inpainting) requires an image")
        key = (steps,
               int(inputs.get("height", self.default_size)),
               int(inputs.get("width", self.default_size)),
               float(inputs.get("guidance_scale", 7.5)),
               int(inputs.get("seed", self.seed)),
               int(inputs.get("num_images_per_prompt", 1)),
               negatives is not None,
               self._normalize_scheduler(inputs.get("scheduler")),
               strength,               # None: text-to-image
               masks is not None,
               g_rescale)
        return prompts, negatives, (
            (images, masks) if images else None), key

    def batch_key(self, inputs: Dict[str, Any]) -> tuple:
        """Requests with equal keys are mergeable into one generate call."""
        return self._parse(inputs)[3]

    @staticmethod
    def _decode_image(b64: str, height: int, width: int) -> np.ndarray:
        """base64 PNG/JPEG -> float32 (H, W, 3) in [0, 1], resized to the
        request's size."""
        from PIL import Image
        img = Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB")
        if img.size != (width, height):
            img = img.resize((width, height), Image.BICUBIC)
        return np.asarray(img, np.float32) / 255.0

    @staticmethod
    def _decode_mask(b64: str, height: int, width: int) -> np.ndarray:
        """base64 PNG/JPEG -> float32 (H, W) in [0, 1] (grayscale; white =
        regenerate), resized to the request's size."""
        from PIL import Image
        img = Image.open(io.BytesIO(base64.b64decode(b64))).convert("L")
        if img.size != (width, height):
            img = img.resize((width, height), Image.BILINEAR)
        return np.asarray(img, np.float32) / 255.0

    def predict_many(self, requests: List[Dict[str, Any]]) -> List[List[str]]:
        """One generate call for several requests that share `batch_key`:
        prompts are concatenated, padded up to the next power of two (so a
        batch size seen before reuses the same shapes), generated together
        and sliced back per request. A request's images depend on the
        batch it rode in (its noise is drawn for the whole batch); the seed
        makes the batch reproducible."""
        if not requests:
            return []
        parsed = [self._parse(r) for r in requests]
        keys = {p[3] for p in parsed}
        if len(keys) > 1:
            raise ValueError(f"unmergeable requests: {sorted(keys, key=repr)}")
        (steps, height, width, scale, seed, n_per, has_neg, sched,
         strength, has_mask, g_rescale) = parsed[0][3]
        prompts = [p for pr, _, _, _ in parsed for p in pr]
        n = len(prompts)
        padded = 1 << (n - 1).bit_length()
        tok = self.model.tokenizer
        prompt_ids = torch.from_numpy(
            tok(prompts + [prompts[-1]] * (padded - n))["input_ids"])
        negative_ids = None
        if has_neg:
            negatives = [x for _, ng, _, _ in parsed for x in ng]
            negative_ids = torch.from_numpy(
                tok(negatives + [negatives[-1]] * (padded - n))["input_ids"])
        gen_kwargs: Dict[str, Any] = {}
        if strength is not None:            # img2img
            arrs = [self._decode_image(b, height, width)
                    for _, _, im, _ in parsed for b in im[0]]
            gen_kwargs["image"] = torch.from_numpy(
                np.stack(arrs + [arrs[-1]] * (padded - n)))
            gen_kwargs["strength"] = strength
            if has_mask:                    # inpainting
                marrs = [self._decode_mask(b, height, width)
                         for _, _, im, _ in parsed for b in im[1]]
                gen_kwargs["mask"] = torch.from_numpy(
                    np.stack(marrs + [marrs[-1]] * (padded - n)))
        images = self._model_for(sched).generate(
            prompt_ids, negative_ids=negative_ids, height=height, width=width,
            guidance_scale=scale, num_inference_steps=steps,
            num_images_per_prompt=n_per, seed=seed,
            guidance_rescale=g_rescale, **gen_kwargs)
        # repeat_interleave keeps prompt-major order: prompt i's copies are
        # rows [i*n_per, (i+1)*n_per); padded prompts trail
        arrays = images[:n * n_per].float().cpu().numpy()
        encoded = [image_to_base64_png(img) for img in arrays]
        out, i = [], 0
        for pr, _, _, _ in parsed:
            out.append(encoded[i:i + len(pr) * n_per])
            i += len(pr) * n_per
        return out

    def predict(self, **inputs: Any) -> List[str]:
        """Inputs: prompt (str | list), negative_prompt, height, width,
        num_inference_steps, guidance_scale, seed, num_images_per_prompt,
        scheduler (ddim | dpm++2m | dpm | euler), guidance_rescale in
        [0, 1];
        `image` (base64 PNG/JPEG, str or list) and `strength` in (0, 1]
        for img2img; with `mask` (grayscale base64, white = regenerate,
        str or list) inpainting: only the white region is synthesized anew,
        the rest kept from the image (strength 1.0 frees it fully)."""
        return self.predict_many([inputs])[0]
