"""Text-to-image serving endpoint.

Counterpart of `diffusion_tpu/inference/inference_model.py`: `predict`
parses prompt/negative_prompt/ints/floats, generates, and returns base64
PNGs; `predict_many` merges several mergeable requests into one generate
call, padded to a power-of-two batch. PyTorch runs eagerly, so there is no
compile cache; `generate` runs under `torch.inference_mode()`.

Weights are random (flax-like init from `seed`) or, with `jax_params`, the
JAX package's `(params, frozen)` trees moved over by `models/port_jax.py`.
Not ported yet: checkpoint loading, img2img/inpainting, per-request
samplers and guidance rescale (each raises NotImplementedError naming its
ROADMAP.md item).
"""

from __future__ import annotations

import base64
import io
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from diffusion_torch.models.models import stable_diffusion_2
from diffusion_torch.models.port_jax import (clip_text_from_jax,
                                             unet_from_jax, vae_from_jax)

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
    def __init__(self, builder: Any = None, default_size: int = 512,
                 seed: int = 0, device: Any = None,
                 jax_params: Optional[Tuple[Dict, Dict]] = None,
                 checkpoint_path: Optional[str] = None,
                 **model_kwargs: Any):
        if checkpoint_path:
            raise NotImplementedError(
                "checkpoint loading comes with ROADMAP.md queue 1 item 3 "
                "(checkpoints and pretrained weights)")
        builder = builder or stable_diffusion_2
        self.model = builder(device=device, seed=seed, **model_kwargs)
        if jax_params is not None:
            params, frozen = jax_params
            self.model.unet.load_state_dict(unet_from_jax(params))
            self.model.vae.load_state_dict(vae_from_jax(frozen["vae"]))
            self.model.text_encoder.load_state_dict(
                clip_text_from_jax(frozen["text_encoder"]))
        self.default_size = default_size
        self.seed = seed

    def _parse(self, inputs: Dict[str, Any]):
        """-> (prompts, negatives_or_None, key). Requests with equal keys
        share one generate call (same program and same RNG seed)."""
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
        if g_rescale > 0.0:
            raise NotImplementedError(
                "guidance_rescale comes with ROADMAP.md queue 1 item 5 "
                "(DPM++/Euler samplers and guidance rescale)")
        sched = inputs.get("scheduler")
        if sched and str(sched).lower() != "ddim":
            raise NotImplementedError(
                f"sampler {sched!r} comes with ROADMAP.md queue 1 item 5 "
                f"(DPM++/Euler samplers and guidance rescale)")
        if inputs.get("image") or inputs.get("mask") or "strength" in inputs:
            raise NotImplementedError(
                "img2img and inpainting come with ROADMAP.md queue 1 item 4 "
                "(VAE encoder, img2img and inpainting)")
        key = (int(inputs.get("num_inference_steps", 50)),
               int(inputs.get("height", self.default_size)),
               int(inputs.get("width", self.default_size)),
               float(inputs.get("guidance_scale", 7.5)),
               int(inputs.get("seed", self.seed)),
               int(inputs.get("num_images_per_prompt", 1)),
               negatives is not None)
        return prompts, negatives, key

    def batch_key(self, inputs: Dict[str, Any]) -> tuple:
        """Requests with equal keys are mergeable into one generate call."""
        return self._parse(inputs)[2]

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
        keys = {p[2] for p in parsed}
        if len(keys) > 1:
            raise ValueError(f"unmergeable requests: {sorted(keys, key=repr)}")
        steps, height, width, scale, seed, n_per, has_neg = parsed[0][2]
        prompts = [p for pr, _, _ in parsed for p in pr]
        n = len(prompts)
        padded = 1 << (n - 1).bit_length()
        tok = self.model.tokenizer
        prompt_ids = torch.from_numpy(
            tok(prompts + [prompts[-1]] * (padded - n))["input_ids"])
        negative_ids = None
        if has_neg:
            negatives = [x for _, ng, _ in parsed for x in ng]
            negative_ids = torch.from_numpy(
                tok(negatives + [negatives[-1]] * (padded - n))["input_ids"])
        images = self.model.generate(
            prompt_ids, negative_ids=negative_ids, height=height, width=width,
            guidance_scale=scale, num_inference_steps=steps,
            num_images_per_prompt=n_per, seed=seed)
        # repeat_interleave keeps prompt-major order: prompt i's copies are
        # rows [i*n_per, (i+1)*n_per); padded prompts trail
        arrays = images[:n * n_per].float().cpu().numpy()
        encoded = [image_to_base64_png(img) for img in arrays]
        out, i = [], 0
        for pr, _, _ in parsed:
            out.append(encoded[i:i + len(pr) * n_per])
            i += len(pr) * n_per
        return out

    def predict(self, **inputs: Any) -> List[str]:
        """Inputs: prompt (str | list), negative_prompt, height, width,
        num_inference_steps, guidance_scale, seed, num_images_per_prompt."""
        return self.predict_many([inputs])[0]
