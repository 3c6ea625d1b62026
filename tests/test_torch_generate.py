"""The slice as a whole: the port's text-to-image `generate` against the JAX
package's on the same weights and the same initial noise (tiny geometry,
4 DDIM steps, 2 prompts with CFG), and the port's serving endpoint and HTTP
server."""

import base64
import io
import json
import threading
from http.client import HTTPConnection

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffusion_tpu.models.models import stable_diffusion_tiny as jax_tiny
from diffusion_torch.inference.inference_model import StableDiffusionInference
from diffusion_torch.inference.serve import Batcher, make_server
from diffusion_torch.models.models import stable_diffusion_tiny

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def endpoint():
    return StableDiffusionInference(builder=stable_diffusion_tiny,
                                    default_size=32, seed=0, device="cpu")


def _png(b64: str) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


@pytest.mark.parametrize("negative", [False, True])
def test_generate_matches_jax(monkeypatch, negative):
    monkeypatch.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "0")
    jsd = jax_tiny()
    params, frozen = jsd.init_params(jax.random.key(0), image_size=64)
    tok = jsd.tokenizer
    ids = tok(["a red fox in the snow", "a lighthouse"])["input_ids"]
    neg = tok(["blurry", "dark"])["input_ids"] if negative else None
    seed, shape = 3, (2, 8, 8, 4)
    want = jsd.generate(params, frozen, jnp.asarray(ids),
                        negative_ids=None if neg is None else jnp.asarray(neg),
                        height=64, width=64, guidance_scale=7.5,
                        num_inference_steps=4, seed=seed)
    # the JAX initial noise, as generate draws it from its seed
    noise = np.array(jax.random.normal(jax.random.key(seed), shape,
                                       jnp.float32))

    port = StableDiffusionInference(builder=stable_diffusion_tiny,
                                    device="cpu",
                                    jax_params=(params, frozen),
                                    default_size=64)
    got = port.model.generate(
        torch.from_numpy(ids),
        negative_ids=None if neg is None else torch.from_numpy(neg),
        height=64, width=64, guidance_scale=7.5, num_inference_steps=4,
        latents=torch.from_numpy(noise))
    assert got.shape == (2, 64, 64, 3)
    # fp32 both ways; 4 UNet calls amplified by the guidance scale (7.5x the
    # cond-uncond difference), then the decoder
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-4, rtol=0)


def test_generate_seeded_and_unsupported(endpoint):
    model = endpoint.model
    ids = torch.from_numpy(model.tokenizer(["a", "b"])["input_ids"])
    a = model.generate(ids, height=32, width=32, num_inference_steps=2, seed=4)
    b = model.generate(ids, height=32, width=32, num_inference_steps=2, seed=4)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    c = model.generate(ids, height=32, width=32, num_inference_steps=2, seed=5)
    assert not torch.equal(a, c)
    # img2img is ported: seeded like text-to-image, a valid image out
    init = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    d = model.generate(ids, image=init, strength=0.5, height=32, width=32,
                       num_inference_steps=2, seed=4)
    e = model.generate(ids, image=init, strength=0.5, height=32, width=32,
                       num_inference_steps=2, seed=4)
    torch.testing.assert_close(d, e, rtol=0, atol=0)
    assert d.shape == (2, 32, 32, 3) and not torch.equal(a, d)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.generate(ids, guidance_rescale=0.7)
    png = io.BytesIO()
    Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(png, format="PNG")
    served = endpoint.predict(
        prompt="x", num_inference_steps=1, strength=0.5,
        image=base64.b64encode(png.getvalue()).decode("ascii"))
    assert _png(served[0]).shape == (32, 32, 3)
    for extra in ({"scheduler": "dpm++2m"}, {"guidance_rescale": 0.5}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            endpoint.predict(prompt="x", num_inference_steps=1, **extra)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        stable_diffusion_tiny(inference_scheduler="euler", device="cpu")


def test_predict_many_merges_and_slices(endpoint):
    """Mergeable requests run as one padded generate call (4 prompts here,
    a power of two) and slice back per request; unmergeable ones raise."""
    calls = []
    real = endpoint.model.generate

    def spy(prompt_ids, **kw):
        calls.append(prompt_ids.shape[0])
        return real(prompt_ids, **kw)

    endpoint.model.generate = spy
    try:
        reqs = [{"prompt": "a", "num_inference_steps": 1,
                 "guidance_scale": 1.0},
                {"prompt": ["b", "c"], "num_inference_steps": 1,
                 "guidance_scale": 1.0},
                {"prompt": "d", "num_inference_steps": 1,
                 "guidance_scale": 1.0}]
        out = endpoint.predict_many(reqs)
    finally:
        del endpoint.model.generate
    assert calls == [4]
    assert [len(o) for o in out] == [1, 2, 1]
    for o in out:
        for b64 in o:
            arr = _png(b64)
            assert arr.shape == (32, 32, 3) and arr.dtype == np.uint8
    three = endpoint.predict(prompt=["x", "y", "z"], num_inference_steps=1,
                             num_images_per_prompt=2)
    assert len(three) == 6
    with pytest.raises(ValueError, match="unmergeable"):
        endpoint.predict_many([{"prompt": "a", "num_inference_steps": 1},
                               {"prompt": "b", "num_inference_steps": 2}])
    with pytest.raises(ValueError, match="prompt required"):
        endpoint.predict(guidance_scale=1.0)


def test_batcher_coalesces_and_closes(endpoint):
    calls = []
    real = endpoint.predict_many

    def spy(reqs):
        calls.append(len(reqs))
        return real(reqs)

    batcher = Batcher(endpoint, max_batch_size=4, batch_wait_ms=300.0)
    endpoint.predict_many = spy
    try:
        results = [None] * 3

        def run(i):
            results[i] = batcher.submit({"prompt": f"p{i}",
                                         "num_inference_steps": 1})
        threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert all(r and len(r) == 1 for r in results)
        assert sum(calls) == 3 and len(calls) <= 2
    finally:
        del endpoint.predict_many
        batcher.close()
    assert not batcher._worker.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        batcher.submit({"prompt": "late", "num_inference_steps": 1})


def test_http_round_trip(endpoint):
    server = make_server(endpoint, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        conn = HTTPConnection("127.0.0.1", server.server_address[1],
                              timeout=120)
        conn.request("GET", "/health")
        assert json.loads(conn.getresponse().read())["status"] == "ok"
        body = json.dumps({"prompt": "hi", "num_inference_steps": 2,
                           "guidance_scale": 3.0, "height": 32, "width": 32})
        conn.request("POST", "/predict", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        assert _png(json.loads(resp.read())["images"][0]).shape == (32, 32, 3)
        conn.request("POST", "/predict", body="{}")
        resp = conn.getresponse()
        assert resp.status == 400
        assert "prompt" in json.loads(resp.read())["error"]
        conn.request("POST", "/nope", body="{}")
        assert conn.getresponse().status == 404
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        assert stats["requests_total"] == 1 and stats["queue_depth"] == 0
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
    assert not server.batcher._worker.is_alive()
