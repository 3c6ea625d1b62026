"""img2img (SDEdit) and inpainting: the port's `generate` against the JAX
package's on the same weights and the same draws (tiny geometry, 4 DDIM
steps, CFG 7.5), the reference's validation errors, the mask extremes,
and the endpoint, its HTTP server and its batcher with image, strength
and mask (the counterparts of tests/test_model.py:87-180 and
tests/test_inference.py:128-204)."""

import base64
import io
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffusion_tpu.inference.inference_model import \
    StableDiffusionInference as JaxInference
from diffusion_tpu.models.models import stable_diffusion_tiny as jax_tiny
from diffusion_torch.inference.inference_model import (
    StableDiffusionInference, image_to_base64_png)
from diffusion_torch.inference.serve import Batcher
from diffusion_torch.models.models import stable_diffusion_tiny

torch.set_num_threads(1)

SIZE, STEPS, SEED = 64, 4, 3


@pytest.fixture(scope="module")
def pair():
    """JAX's tiny model and weights, and the port's endpoint on them."""
    jsd = jax_tiny()
    params, frozen = jsd.init_params(jax.random.key(0), image_size=SIZE)
    port = StableDiffusionInference(builder=stable_diffusion_tiny,
                                    device="cpu", default_size=SIZE,
                                    jax_params=(params, frozen))
    return jsd, params, frozen, port


def _ids(tok):
    return tok(["a red fox in the snow", "a lighthouse"])["input_ids"]


def _init(b=2):
    return np.random.default_rng(0).uniform(
        0, 1, (b, SIZE, SIZE, 3)).astype(np.float32)


def _jax_draws(seed, n_images, n_per):
    """img2img's draws as JAX's generate splits them: the posterior's eps
    from the second key of split(key(seed)), the noise from the first."""
    rng, enc = jax.random.split(jax.random.key(seed))
    lat = (SIZE // 8, SIZE // 8, 4)
    eps = np.array(jax.random.normal(enc, (n_images, *lat), jnp.float32))
    noise = np.array(jax.random.normal(rng, (n_images * n_per, *lat),
                                       jnp.float32))
    return torch.from_numpy(eps), torch.from_numpy(noise)


def _both(pair, monkeypatch, n_per=1, **kw):
    monkeypatch.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "0")
    jsd, params, frozen, port = pair
    ids = _ids(jsd.tokenizer)
    common = dict(height=SIZE, width=SIZE, guidance_scale=7.5,
                  num_inference_steps=STEPS, num_images_per_prompt=n_per)
    jkw = {k: None if v is None else jnp.asarray(v) if isinstance(
        v, np.ndarray) else v for k, v in kw.items()}
    want = jsd.generate(params, frozen, jnp.asarray(ids), seed=SEED,
                        **common, **jkw)
    eps, noise = _jax_draws(SEED, len(ids), n_per)
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    got = port.model.generate(torch.from_numpy(ids), latents=noise,
                              latent_noise=eps, **common, **tkw)
    return got, np.asarray(want)


@pytest.mark.parametrize("strength,n_per", [(0.5, 1), (0.5, 2), (1.0, 1),
                                            (0.1, 1), (0.1, 2)])
def test_img2img_matches_jax(pair, monkeypatch, strength, n_per):
    """strength 0.5 runs the last 2 of 4 steps, 1.0 all 4; 0.1 rounds to no
    step at all: the output is the VAE reconstruction."""
    got, want = _both(pair, monkeypatch, n_per, image=_init(),
                      strength=strength)
    assert got.shape == (2 * n_per, SIZE, SIZE, 3)
    # fp32 both ways, as test_generate_matches_jax: the encoder, up to 4
    # UNet calls amplified by the guidance scale, then the decoder
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)


def _half_mask(b=2):
    m = np.ones((b, SIZE, SIZE), np.float32)
    m[:, :, :SIZE // 2] = 0.0
    m[:, 10:21, 40:45] = 0.5            # soft edges, pooled 8x8
    return m


@pytest.mark.parametrize("mask_kind,n_per", [("image", 1), ("image", 2),
                                             ("latent", 1)])
def test_inpaint_matches_jax(pair, monkeypatch, mask_kind, n_per):
    mask = _half_mask()
    if mask_kind == "latent":
        mask = mask.reshape(2, 8, 8, 8, 8).mean((2, 4))[..., None]
    got, want = _both(pair, monkeypatch, n_per, image=_init(), strength=0.75,
                      mask=mask)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)


def test_mask_extremes(pair):
    """All ones is img2img bit for bit (the blend is the identity); all
    zeros is the VAE reconstruction decode(lat0) bit for bit, whatever the
    prompt (the reference's tests/test_model.py:142)."""
    *_, port = pair
    model = port.model
    ids = torch.from_numpy(_ids(model.tokenizer))
    init = torch.from_numpy(_init())
    kw = dict(height=SIZE, width=SIZE, guidance_scale=7.5,
              num_inference_steps=STEPS, seed=1, image=init, strength=1.0)
    plain = model.generate(ids, **kw)
    ones = model.generate(ids, mask=torch.ones(2, SIZE, SIZE), **kw)
    assert torch.equal(plain, ones)
    zeros = model.generate(ids, mask=torch.zeros(2, SIZE // 8, SIZE // 8, 1),
                           **kw)
    other = model.generate(ids.flip(0), mask=torch.zeros(2, SIZE, SIZE), **kw)
    assert torch.equal(zeros, other)
    # the same posterior draw the generator makes first
    gen = torch.Generator().manual_seed(1)
    with torch.inference_mode():
        lat0 = model.encode_images(init * 2.0 - 1.0, generator=gen)
        recon = model.vae.decode(lat0.permute(0, 3, 1, 2) / model.latent_scale)
    recon = (recon * 0.5 + 0.5).clamp(0.0, 1.0).permute(0, 2, 3, 1)
    assert torch.equal(zeros, recon)
    half = model.generate(ids, mask=torch.from_numpy(_half_mask()), **kw)
    assert not torch.equal(half, plain) and not torch.equal(half, zeros)


@pytest.mark.parametrize("kw,match", [
    ({"strength": 0.0}, "strength"),
    ({"strength": 1.5}, "strength"),
    ({"image": None, "mask": np.ones((2, SIZE, SIZE), np.float32)},
     "requires an init image"),
    ({"mask": np.ones((2, 5, 7), np.float32)}, "mask spatial dims"),
])
def test_validation_matches_jax(pair, kw, match):
    """The reference's ValueErrors, raised by both packages."""
    jsd, params, frozen, port = pair
    ids = _ids(jsd.tokenizer)
    kw = {"image": _init(), "strength": 0.5, **kw}
    common = dict(height=SIZE, width=SIZE, num_inference_steps=2)
    with pytest.raises(ValueError, match=match):
        jsd.generate(params, frozen, jnp.asarray(ids), **common, **{
            k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()})
    with pytest.raises(ValueError, match=match):
        port.model.generate(torch.from_numpy(ids), **common, **{
            k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()})


def _b64(arr, mode=None):
    buf = io.BytesIO()
    Image.fromarray(arr, mode=mode).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


class _Stub:
    """Enough of a JAX endpoint for its `_parse` (no model, no compile)."""

    @staticmethod
    def _normalize_scheduler(requested):
        return None


def test_predict_img2img(pair):
    """The endpoint's strength canonicalization and batch keys are JAX's;
    its image decode is JAX's bit for bit; a request's PNGs are the
    model's generate on the decoded image at the canonical strength."""
    *_, port = pair
    rng = np.random.default_rng(7)
    src = (rng.uniform(0, 1, (48, 40, 3)) * 255).astype(np.uint8)  # resized
    b64 = _b64(src)
    kw = dict(prompt="a cat in the snow", num_inference_steps=STEPS,
              guidance_scale=3.0, seed=2)
    for strength in (0.5, 0.501, 0.25, 0.3, 1.0, 0.05):
        req = kw | {"image": b64, "strength": strength}
        want = JaxInference._parse(_Stub(), req, SIZE, 0)[3]
        got = port.batch_key(req)
        assert got[7] == want[8] and got[8] == want[9] is False
    np.testing.assert_array_equal(
        port._decode_image(b64, SIZE, SIZE),
        JaxInference._decode_image(b64, SIZE, SIZE))

    k_txt = port.batch_key(kw)
    k_i50 = port.batch_key(kw | {"image": b64, "strength": 0.5})
    k_i25 = port.batch_key(kw | {"image": b64, "strength": 0.25})
    assert k_txt != k_i50 != k_i25
    assert port.batch_key(kw | {"image": b64, "strength": 0.501}) == k_i50

    out = port.predict(image=b64, strength=0.5, **kw)
    image = torch.from_numpy(port._decode_image(b64, SIZE, SIZE))[None]
    ids = torch.from_numpy(port.model.tokenizer([kw["prompt"]])["input_ids"])
    direct = port.model.generate(
        ids, height=SIZE, width=SIZE, guidance_scale=3.0,
        num_inference_steps=STEPS, seed=2, image=image,
        strength=(2 + 0.5) / STEPS)
    assert out == [image_to_base64_png(direct[0].numpy())]

    with pytest.raises(ValueError, match="strength"):
        port.predict(image=b64, strength=1.5, **kw)
    with pytest.raises(ValueError, match="strength requires an image"):
        port.predict(strength=0.5, **kw)
    with pytest.raises(ValueError, match="image count"):
        port.predict(prompt=["a", "b", "c"], image=[b64, b64],
                     num_inference_steps=STEPS)


def test_predict_inpaint(pair):
    """A black mask keeps every pixel whatever the prompt; a half mask
    synthesizes anew; mask presence keys the batch; the mask decode is
    JAX's bit for bit."""
    *_, port = pair
    src = (np.random.default_rng(11).uniform(0, 1, (SIZE, SIZE, 3))
           * 255).astype(np.uint8)
    img = _b64(src)
    black = _b64(np.zeros((SIZE, SIZE), np.uint8), "L")
    half = np.zeros((SIZE, SIZE), np.uint8)
    half[SIZE // 2:] = 255
    halfmask = _b64(half, "L")
    np.testing.assert_array_equal(
        port._decode_mask(halfmask, SIZE, SIZE),
        JaxInference._decode_mask(halfmask, SIZE, SIZE))

    kw = dict(num_inference_steps=STEPS, guidance_scale=3.0, seed=2,
              image=img, strength=1.0)
    keep_a = port.predict(prompt="a cat in the snow", mask=black, **kw)
    keep_b = port.predict(prompt="a dog in the rain", mask=black, **kw)
    assert keep_a == keep_b
    out = port.predict(prompt="a cat in the snow", mask=halfmask, **kw)
    assert out != keep_a
    assert port.batch_key({"prompt": "x", **kw}) != port.batch_key(
        {"prompt": "x", "mask": halfmask, **kw})
    with pytest.raises(ValueError, match="mask .*requires an image"):
        port.predict(prompt="x", mask=halfmask, num_inference_steps=STEPS)
    with pytest.raises(ValueError, match="mask count"):
        port.predict(prompt=["a", "b"], image=[img, img], mask=[halfmask],
                     num_inference_steps=STEPS)


def test_batcher_keeps_img2img_apart(pair):
    """Concurrent text-to-image, img2img and inpainting requests ride in
    separate dispatches; two img2img requests with one key merge."""
    *_, port = pair
    img = _b64(np.full((SIZE, SIZE, 3), 128, np.uint8))
    mask = _b64(np.full((SIZE, SIZE), 255, np.uint8), "L")
    base = {"num_inference_steps": 1, "height": 32, "width": 32}
    reqs = [base | {"prompt": "text"},
            base | {"prompt": "i2i a", "image": img, "strength": 0.5},
            base | {"prompt": "i2i b", "image": img, "strength": 1.0},
            base | {"prompt": "inpaint", "image": img, "strength": 1.0,
                    "mask": mask}]
    calls = []
    real = port.predict_many

    def spy(batch):
        calls.append(sorted(r["prompt"] for r in batch))
        return real(batch)

    port.predict_many = spy
    batcher = Batcher(port, max_batch_size=4, batch_wait_ms=500.0)
    try:
        results = [None] * len(reqs)

        def run(i):
            results[i] = batcher.submit(reqs[i])
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert all(r and len(r) == 1 for r in results)
    finally:
        del port.predict_many
        batcher.close()
    assert sorted(calls) == [["i2i a"], ["i2i b"], ["inpaint"], ["text"]]
    two = [base | {"prompt": p, "image": img, "strength": 0.5}
           for p in ("x", "y")]
    assert port.batch_key(two[0]) == port.batch_key(two[1])
    assert len(port.predict_many(two)) == 2


def test_http_img2img_and_inpaint(pair):
    """img2img and inpainting requests over the port's HTTP server: 200
    and PNGs of the request's size; a strength without an image is a 400
    naming it."""
    import json
    from http.client import HTTPConnection

    from diffusion_torch.inference.serve import make_server

    *_, port = pair
    server = make_server(port, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    img = _b64(np.full((40, 24, 3), 90, np.uint8))
    mask = _b64(np.tile(np.array([255, 0], np.uint8).repeat(16), (32, 1)),
                "L")
    try:
        conn = HTTPConnection("127.0.0.1", server.server_address[1],
                              timeout=120)
        base = {"prompt": "hi", "num_inference_steps": 2, "height": 32,
                "width": 32, "image": img, "strength": 0.5}
        for body in (base, dict(base, mask=mask)):
            conn.request("POST", "/predict", body=json.dumps(body),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 200
            out = json.loads(resp.read())["images"]
            png = Image.open(io.BytesIO(base64.b64decode(out[0])))
            assert png.size == (32, 32)
        conn.request("POST", "/predict", body=json.dumps(
            {"prompt": "hi", "strength": 0.5}))
        resp = conn.getresponse()
        assert resp.status == 400
        assert "strength requires an image" in json.loads(resp.read())["error"]
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
