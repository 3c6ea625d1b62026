"""`generate` under DPM-Solver++(2M), Euler and guidance rescale: the
port's against the JAX package's on the same tiny weights and the same
draws (text-to-image, img2img and inpainting), and the endpoint's
per-request `scheduler` and `guidance_rescale` against JAX's
`StableDiffusionInference` parse, batch keys included."""

import base64
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffusion_tpu.inference.inference_model import \
    StableDiffusionInference as JaxInference
from diffusion_tpu.models import models as jmodels
from diffusion_tpu.models.models import stable_diffusion_tiny as jax_tiny
from diffusion_torch.inference.inference_model import StableDiffusionInference
from diffusion_torch.models.models import stable_diffusion_tiny

torch.set_num_threads(1)

SIZE, SEED = 64, 3
LAT = (SIZE // 8, SIZE // 8, 4)


@pytest.fixture(scope="module")
def pair():
    """JAX's tiny model and weights, and the port's endpoint on them."""
    jsd = jax_tiny()
    params, frozen = jsd.init_params(jax.random.key(0), image_size=SIZE)
    port = StableDiffusionInference(builder=stable_diffusion_tiny,
                                    device="cpu", default_size=SIZE,
                                    jax_params=(params, frozen))
    return jsd, params, frozen, port


def _with(jsd, name):
    """JAX's model over the named sampler, built like its own."""
    import dataclasses
    return dataclasses.replace(jsd, inference_scheduler=(
        jmodels._make_inference_scheduler(name,
                                          like=jsd.inference_scheduler)))


def _ids(tok):
    return tok(["a red fox in the snow", "a lighthouse"])["input_ids"]


def _init(b=2):
    return np.random.default_rng(0).uniform(
        0, 1, (b, SIZE, SIZE, 3)).astype(np.float32)


def _mask(b=2):
    m = np.zeros((b, SIZE, SIZE), np.float32)
    m[:, :, SIZE // 2:] = 1.0
    return m


def _run(pair, monkeypatch, name, steps, **kw):
    """JAX's generate and the port's on the same draws: text-to-image's
    noise from key(seed), img2img's posterior eps from the second key of
    split(key(seed)) and its noise from the first, as JAX draws them."""
    monkeypatch.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "0")
    jsd, params, frozen, port = pair
    ids = _ids(jsd.tokenizer)
    common = dict(height=SIZE, width=SIZE, guidance_scale=7.5,
                  num_inference_steps=steps,
                  guidance_rescale=kw.pop("guidance_rescale", 0.0))
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    want = _with(jsd, name).generate(params, frozen, jnp.asarray(ids),
                                     seed=SEED, **common, **jkw)
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    if "image" in kw:
        rng, enc = jax.random.split(jax.random.key(SEED))
        tkw["latent_noise"] = torch.from_numpy(np.array(
            jax.random.normal(enc, (len(ids), *LAT), jnp.float32)))
    else:
        rng = jax.random.key(SEED)
    noise = np.array(jax.random.normal(rng, (len(ids), *LAT), jnp.float32))
    model = port._model_for(None if name == "ddim" else name)
    got = model.generate(torch.from_numpy(ids),
                         latents=torch.from_numpy(noise), **common, **tkw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("name,steps,rescale", [
    ("dpm++2m", 4, 0.0), ("dpm++2m", 16, 0.0), ("euler", 4, 0.0),
    ("ddim", 4, 0.7), ("dpm++2m", 4, 0.7)])
def test_text_to_image_matches_jax(pair, monkeypatch, name, steps, rescale):
    """16 DPM++ steps run the second-order terminal step (>= 15), 4 the
    first-order one. fp32 both ways; the guidance scale (7.5) amplifies
    the UNet's rounding, then the decoder: atol 2e-4 on [0, 1] images, as
    the img2img tests hold DDIM."""
    got, want = _run(pair, monkeypatch, name, steps,
                     guidance_rescale=rescale)
    assert got.shape == (2, SIZE, SIZE, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


@pytest.mark.parametrize("name", ["dpm++2m", "euler"])
@pytest.mark.parametrize("inpaint", [False, True])
def test_img2img_and_inpaint_match_jax(pair, monkeypatch, name, inpaint):
    """img2img enters at the sampler's own `noise_to` (sigma space for
    Euler), and inpainting blends in that space after every step."""
    kw = dict(image=_init(), strength=0.75)
    if inpaint:
        kw["mask"] = _mask()
    got, want = _run(pair, monkeypatch, name, 4, **kw)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def test_rescale_uses_population_std(pair):
    """At guidance_rescale 1 the CFG prediction takes the conditional
    branch's population std (correction 0, as jnp.std); with torch's
    default (correction 1) the images would differ."""
    *_, port = pair
    model = port.model
    ids = torch.from_numpy(_ids(model.tokenizer))
    calls = []
    real = torch.Tensor.std

    def spy(self, *a, **k):
        calls.append(k.get("correction"))
        return real(self, *a, **k)

    torch.Tensor.std = spy
    try:
        model.generate(ids, height=SIZE, width=SIZE, num_inference_steps=2,
                       seed=1, guidance_rescale=1.0)
    finally:
        torch.Tensor.std = real
    assert calls == [0] * 4          # cond and CFG std, two steps


class _JaxStub:
    """Enough of a JAX endpoint for its `_parse` (no params, no
    compile)."""

    def __init__(self, model):
        self.model = model

    def _normalize_scheduler(self, requested):
        return JaxInference._normalize_scheduler(self, requested)


def _b64(arr) -> str:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


@pytest.mark.parametrize("extra", [
    {}, {"scheduler": "ddim"}, {"scheduler": "DDIM"}, {"scheduler": "dpm"},
    {"scheduler": "dpm++2m"}, {"scheduler": "Euler"},
    {"guidance_rescale": 0.7}, {"scheduler": "euler", "guidance_rescale": 1},
    {"scheduler": "dpm", "strength": 0.5, "image": True}])
def test_endpoint_batch_keys_match_jax(pair, extra):
    """The port's batch key is JAX's for every sampler and rescale: an
    explicit request for the model's own sampler folds to None, 'dpm' to
    'dpm++2m', and the sampler and rescale are both in the key."""
    jsd, *_, port = pair
    req = {"prompt": "a cat", "num_inference_steps": 4, "seed": 2, **extra}
    if extra.get("image"):
        req["image"] = _b64(np.zeros((SIZE, SIZE, 3), np.uint8))
    want = JaxInference._parse(_JaxStub(jsd), req, SIZE, 0)[3]
    assert port.batch_key(req) == want


def test_endpoint_serves_each_sampler(pair):
    """A request's PNGs are the generate of the model over its sampler
    with its rescale; one model per sampler name is kept (same modules,
    never rebuilt); different samplers never merge; unknown names and
    samplers the schedule refuses are client errors (ValueError), as in
    JAX."""
    jsd, *_, port = pair
    kw = dict(prompt="a cat in the snow", num_inference_steps=4,
              guidance_scale=3.0, seed=2)
    ids = torch.from_numpy(port.model.tokenizer([kw["prompt"]])["input_ids"])
    for name, rescale in (("dpm++2m", 0.0), ("euler", 0.7), ("ddim", 0.7)):
        out = port.predict(scheduler=name, guidance_rescale=rescale, **kw)
        model = port._model_for(None if name == "ddim" else name)
        direct = model.generate(ids, height=SIZE, width=SIZE,
                                guidance_scale=3.0, num_inference_steps=4,
                                seed=2, guidance_rescale=rescale)
        from diffusion_torch.inference.inference_model import \
            image_to_base64_png
        assert out == [image_to_base64_png(direct[0].numpy())]
    dpm = port._model_for("dpm++2m")
    port.predict(scheduler="dpm", **kw)
    assert port._model_for("dpm++2m") is dpm and sorted(port._models) == [
        "dpm++2m", "euler"]
    assert dpm.unet is port.model.unet and dpm.vae is port.model.vae
    assert type(dpm.inference_scheduler).__name__ == \
        "DPMSolverMultistepScheduler"
    assert port.model.inference_scheduler.__class__.__name__ == \
        "DDIMScheduler"
    with pytest.raises(ValueError, match="unmergeable"):
        port.predict_many([dict(kw, scheduler="euler"),
                           dict(kw, scheduler="dpm++2m")])
    for bad in ("heun", "k_lms"):
        with pytest.raises(ValueError) as want:
            JaxInference._normalize_scheduler(_JaxStub(jsd), bad)
        with pytest.raises(ValueError) as got:
            port.predict(scheduler=bad, **kw)
        assert str(got.value) == str(want.value)
    zsnr = StableDiffusionInference(
        builder=stable_diffusion_tiny, device="cpu", default_size=SIZE,
        prediction_type="v_prediction", rescale_betas_zero_snr=True)
    with pytest.raises(ValueError, match="zero terminal SNR"):
        zsnr.batch_key(dict(kw, scheduler="euler"))
