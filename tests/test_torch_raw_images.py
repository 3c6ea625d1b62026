"""Training on raw images: the port's forward and loss on an `image` +
`captions` batch (encoded by the frozen VAE and CLIP towers) against the
JAX package's, on the same weights through `port_jax` and JAX's own draws
(the posterior's eps, timesteps, noise) handed to the port; the UNet's
gradient, none for the towers; JAX's RuntimeError when the towers were not
built; and the recipe's COCO eval set (yamls/SD-2-base-256.yaml) through
`eval_forward` on both sides. Tiny geometry, fp32."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffusion_tpu.data import coco as jcoco
from diffusion_tpu.models.models import stable_diffusion_tiny as jax_tiny
from diffusion_torch.data import coco as tcoco
from diffusion_torch.data.mds import MDSWriter
from diffusion_torch.models.models import stable_diffusion_tiny
from diffusion_torch.models.port_jax import (clip_text_from_jax,
                                             unet_from_jax, vae_from_jax)

torch.set_num_threads(1)

HW = 64


def _jax_draws(rng, b, hw=HW):
    """(eps, timesteps, noise) as JAX's `forward` draws them: split into
    (encode, timesteps, noise)."""
    r_enc, r_t, r_noise = jax.random.split(rng, 3)
    lat = (b, hw // 8, hw // 8, 4)
    eps = jax.random.normal(r_enc, lat, jnp.float32)
    t = jax.random.randint(r_t, (b,), 0, 1000)
    noise = jax.random.normal(r_noise, lat, jnp.float32)
    return tuple(torch.from_numpy(np.array(a)) for a in (eps, t, noise))


def _port(params, frozen, **kw):
    model = stable_diffusion_tiny(device="cpu", **kw)
    model.unet.load_state_dict(unet_from_jax(params))
    model.vae.load_state_dict(vae_from_jax(frozen["vae"]))
    model.text_encoder.load_state_dict(
        clip_text_from_jax(frozen["text_encoder"]))
    return model


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.fixture(scope="module")
def towers():
    jsd = jax_tiny()
    params, frozen = jsd.init_params(jax.random.key(0), image_size=HW)
    return jsd, params, frozen


def _raw_batch(tok, seed=3, b=2):
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(-1, 1, (b, HW, HW, 3)).astype(np.float32),
            "captions": tok(["a red fox", "a lighthouse at dusk"][:b])[
                "input_ids"].astype(np.int32)}


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_raw_forward_and_loss_match_jax(monkeypatch, towers, prediction_type):
    monkeypatch.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "0")
    _, params, frozen = towers
    jsd = jax_tiny(prediction_type=prediction_type)
    batch = _raw_batch(jsd.tokenizer)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.key(11)
    pred, target, t = jsd.forward(params, frozen, jbatch, rng)
    want_loss, want_grads = jax.value_and_grad(jsd.loss_fn)(
        params, frozen, jbatch, rng)
    eps, t_draw, noise = _jax_draws(rng, 2)

    model = _port(params, frozen, prediction_type=prediction_type)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = model.forward(tbatch, noise=noise, timesteps=t_draw,
                        latent_noise=eps)
    assert np.array_equal(got[2].numpy(), np.asarray(t))
    for name, g, w in (("prediction", got[0], pred),
                       ("target", got[1], target)):
        assert tuple(g.shape) == w.shape
        assert _rel(g.detach().numpy(), w) <= 1e-5, name
    loss = model.loss_fn(tbatch, None, noise, t_draw, eps)
    assert abs(loss.item() - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    loss.backward()
    # the towers are frozen: no gradient, and nothing kept for one
    assert all(p.grad is None for p in (*model.vae.parameters(),
                                        *model.text_encoder.parameters()))
    want = unet_from_jax(want_grads)
    scale = max(float(w.abs().max()) for w in want.values())
    for name, p in model.unet.named_parameters():
        # test_torch_train_step's tolerance for the UNet gradient
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=1e-5 * scale, rtol=1e-3,
                                   err_msg=name)


def test_encode_images_matches_jax(monkeypatch, towers):
    """`encode_images` is JAX's: a posterior sample times 0.18215."""
    monkeypatch.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "0")
    jsd, params, frozen = towers
    x = _raw_batch(jsd.tokenizer)["image"]
    rng = jax.random.key(5)
    want = jsd.encode_images(frozen, jnp.asarray(x), rng)
    eps = torch.from_numpy(np.array(jax.random.normal(rng, want.shape)))
    got = _port(params, frozen).encode_images(torch.from_numpy(x), eps)
    assert got.is_contiguous() and not got.requires_grad
    assert _rel(got.numpy(), want) <= 1e-5


def test_raw_batch_without_towers_raises_jax_error(towers):
    jsd_p = jax_tiny(precomputed_latents=True)
    params, frozen = jsd_p.init_params(jax.random.key(0), image_size=HW)
    batch = _raw_batch(jsd_p.tokenizer)
    with pytest.raises(RuntimeError) as want:
        jsd_p.forward(params, frozen, {k: jnp.asarray(v)
                                       for k, v in batch.items()},
                      jax.random.key(0))
    model = stable_diffusion_tiny(device="cpu", precomputed_latents=True)
    with pytest.raises(RuntimeError) as got:
        model.forward({k: torch.from_numpy(v) for k, v in batch.items()})
    assert str(got.value) == str(want.value)
    # reference fault 9 in both recipe yamls: their model sections
    # (precomputed latents, `val_guidance_scales: []`) build no towers, so
    # their raw COCO eval batches raise the same error on both sides
    import os
    from diffusion_torch.config import load_config
    for name in ("SD-2-base-256.yaml", "SD-2-base-512.yaml"):
        section = load_config(os.path.join(os.path.dirname(__file__),
                                           os.pardir, "yamls", name))["model"]
        assert section["precomputed_latents"] is True, name
        assert section["val_guidance_scales"] == [], name
        assert "init_frozen_towers" not in section, name
        kw = {k: section[k] for k in ("precomputed_latents",
                                      "val_guidance_scales")}
        jsd_y = jax_tiny(**kw)
        params, frozen = jsd_y.init_params(jax.random.key(0), image_size=HW)
        assert "vae" not in frozen, name
        with pytest.raises(RuntimeError) as want_y:
            jsd_y.forward(params, frozen, {k: jnp.asarray(v)
                                           for k, v in batch.items()},
                          jax.random.key(0))
        model = stable_diffusion_tiny(device="cpu", **kw)
        assert model.vae is None, name
        with pytest.raises(RuntimeError) as got_y:
            model.forward({k: torch.from_numpy(v) for k, v in batch.items()})
        assert str(got_y.value) == str(want_y.value) == str(want.value), name


def _coco_shards(path, n=6):
    rng = np.random.default_rng(8)
    with MDSWriter(str(path), {"image": "bytes", "captions": "json"},
                   size_limit=1 << 14) as w:
        for i in range(n):
            buf = io.BytesIO()
            hw = (48 + 8 * (i % 3), 80 - 8 * (i % 2))
            Image.fromarray(rng.integers(0, 255, (*hw, 3), np.uint8)).save(
                buf, format="JPEG")
            w.write({"image": buf.getvalue(),
                     "captions": [f"a photo number {i}", f"other {i}"]})
    return str(path)


def test_coco_eval_batches_match_jax(monkeypatch, towers, tmp_path):
    """The recipe's eval set: COCO batches, [0, 1] images as the reader
    gives them (no +-1 normalization, ROADMAP.md queue 3), through both
    packages' `eval_forward` with JAX's eval draws."""
    monkeypatch.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "0")
    jsd, params, frozen = towers
    kw = dict(remote=_coco_shards(tmp_path / "coco"), batch_size=3,
              resize_size=HW, num_workers=1)
    jbatches = list(jcoco.build_streaming_cocoval_dataloader(**kw))
    tbatches = list(tcoco.build_streaming_cocoval_dataloader(**kw))
    assert len(jbatches) == len(tbatches) == 2
    model = _port(params, frozen)
    for i, (jb, tb) in enumerate(zip(jbatches, tbatches)):
        assert sorted(tb) == ["captions", "image"]
        assert 0.0 <= tb["image"].min() and tb["image"].max() <= 1.0
        rng = jax.random.fold_in(jax.random.key(1138), i)
        want = jsd.eval_forward(params, frozen,
                                {k: jnp.asarray(v) for k, v in jb.items()},
                                rng)
        eps, t, noise = _jax_draws(rng, 3)
        got = model.eval_forward({k: torch.from_numpy(v)
                                  for k, v in tb.items()}, None, noise, t,
                                 eps)
        assert got["generated"] == want["generated"] == {}
        assert np.array_equal(got["timesteps"].numpy(),
                              np.asarray(want["timesteps"]))
        for name in ("pred", "target"):
            assert _rel(got[name].numpy(), want[name]) <= 1e-5, (i, name)
