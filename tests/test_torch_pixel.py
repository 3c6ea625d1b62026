"""Pixel-space diffusion in the port against the JAX package: the
continuous-time scheduler (`tangent_schedule`, `add_noise`,
`get_velocity`, the ODE and SDE `step`), `PixelDiffusion.forward`'s
prediction and target for the three prediction types in discrete and
continuous time, and `generate` under DDIM, the SDE and the ODE. Tiny
geometry (tests/common.py's pixel model), fp32, JAX's weights through
`port_jax`; JAX's timesteps, noise, initial latents and per-step SDE noise
are drawn from the keys JAX's functions split and handed to the port."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_tpu.schedulers import continuous as jcont
from diffusion_torch.models import models as tmodels
from diffusion_torch.models.clip import CLIPTextConfig, CLIPTextModel
from diffusion_torch.models.pixel_diffusion import PixelDiffusion
from diffusion_torch.models.port_jax import clip_text_from_jax, unet_from_jax
from diffusion_torch.models.unet import PIXEL_UNET, UNet2DCondition, UNetConfig
from diffusion_torch.schedulers import (ContinuousTimeScheduler,
                                        DDIMScheduler, DDPMScheduler)
from diffusion_torch.schedulers import continuous as tcont
from tests.common import tiny_pixel_diffusion

torch.set_num_threads(1)

HW = 8


def _t(a):
    return torch.from_numpy(np.array(a))


def test_tangent_schedule_matches_jax():
    t = np.linspace(0.0, 1.5707, 37, dtype=np.float32)
    for got, want in zip(tcont.tangent_schedule(t),
                         jcont.tangent_schedule(t)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction",
                                             "sample"])
@pytest.mark.parametrize("use_ode", [False, True])
def test_continuous_scheduler_matches_jax(prediction_type, use_ode):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, HW, HW, 3)).astype(np.float32)
    eps = rng.standard_normal(x.shape).astype(np.float32)
    out = rng.standard_normal(x.shape).astype(np.float32)
    t = np.array([0.3, 1.2], np.float32)
    kw = dict(t_max=1.56, prediction_type=prediction_type, use_ode=use_ode,
              num_inference_timesteps=20)
    js, ts = jcont.ContinuousTimeScheduler(**kw), ContinuousTimeScheduler(**kw)
    np.testing.assert_allclose(ts.add_noise(_t(x), _t(eps), _t(t)).numpy(),
                               np.asarray(js.add_noise(x, eps, t)),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        ts.get_velocity(_t(x), _t(eps), _t(t)).numpy(),
        np.asarray(js.get_velocity(x, eps, t)), atol=1e-6, rtol=0)
    grid, prev = ts.timesteps(20)
    jgrid, jprev = js.timesteps(20)
    np.testing.assert_array_equal(grid, jgrid)
    np.testing.assert_array_equal(prev, jprev)
    noise = None if use_ode else eps
    for t_step in (grid[0], grid[7], grid[-1], np.float32(0.0)):
        want = np.asarray(js.step(out, t_step, t_step - 0.078, x,
                                  noise=noise))
        got = ts.step(_t(out), t_step, t_step - 0.078, _t(x),
                      noise=None if noise is None else _t(noise))
        # fp32 both ways; the score divides by sin^2 t (large near t = 0)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    # t == 0 returns x unchanged; the SDE refuses a missing noise
    assert torch.equal(ts.step(_t(out), np.float32(0.0), -0.078, _t(x),
                               noise=None if use_ode else _t(eps)), _t(x))
    if not use_ode:
        with pytest.raises(ValueError, match="noise"):
            ts.step(_t(out), grid[0], prev[0], _t(x))


def _port_pixel(jmodel, params, frozen):
    """The port's PixelDiffusion with tests/common.py's geometry and the
    JAX model's schedulers and weights."""
    ucfg = UNetConfig(**{f: getattr(jmodel.unet.config, f)
                         for f in UNetConfig.__dataclass_fields__})
    tcfg = CLIPTextConfig(**{f: getattr(jmodel.text_encoder.config, f)
                             for f in ("vocab_size", "hidden_size",
                                       "intermediate_size",
                                       "num_hidden_layers",
                                       "num_attention_heads",
                                       "max_position_embeddings")})
    unet, text = UNet2DCondition(ucfg), CLIPTextModel(tcfg)
    unet.load_state_dict(unet_from_jax(params))
    text.load_state_dict(clip_text_from_jax(frozen["text_encoder"]))
    text.eval().requires_grad_(False)

    def sched(s):
        if isinstance(s, jcont.ContinuousTimeScheduler):
            return ContinuousTimeScheduler(**dataclasses.asdict(s))
        cls = DDPMScheduler if type(s).__name__ == "DDPMScheduler" \
            else DDIMScheduler
        return cls(prediction_type=s.prediction_type)

    return PixelDiffusion(unet=unet, text_encoder=text,
                          tokenizer=jmodel.tokenizer,
                          noise_scheduler=sched(jmodel.noise_scheduler),
                          inference_scheduler=sched(
                              jmodel.inference_scheduler),
                          prediction_type=jmodel.prediction_type,
                          continuous_time=jmodel.continuous_time)


def _batch(jmodel, seed=2, b=2):
    rng = np.random.default_rng(seed)
    ids = jmodel.tokenizer(["a red square", "two blue dots"][:b])[
        "input_ids"]
    return {"image": rng.uniform(-1, 1, (b, HW, HW, 3)).astype(np.float32),
            "captions": np.asarray(ids, np.int32)}


@pytest.mark.parametrize("continuous", [False, True])
@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction",
                                             "sample"])
def test_forward_matches_jax(monkeypatch, continuous, prediction_type):
    monkeypatch.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "0")
    jmodel = tiny_pixel_diffusion(continuous_time=continuous,
                                  prediction_type=prediction_type)
    params, frozen = jmodel.init_params(jax.random.key(1), image_size=HW)
    batch = _batch(jmodel)
    rng = jax.random.key(12)
    pred, target, t = jmodel.forward(
        params, frozen, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    # the draws JAX's forward makes: timesteps, then noise
    r_t, r_noise = jax.random.split(rng)
    if continuous:
        want_t = jax.random.uniform(r_t, (2,), jnp.float32, 0.0,
                                    jmodel.noise_scheduler.t_max)
    else:
        want_t = jax.random.randint(r_t, (2,), 0, 1000)
    np.testing.assert_array_equal(np.asarray(t), np.asarray(want_t))
    noise = jax.random.normal(r_noise, batch["image"].shape, jnp.float32)

    model = _port_pixel(jmodel, params, frozen)
    got_pred, got_target, got_t = model.forward(
        {k: torch.from_numpy(v) for k, v in batch.items()},
        noise=_t(noise), timesteps=_t(want_t))
    assert got_t.dtype == (torch.float32 if continuous else torch.int32)
    np.testing.assert_allclose(got_target.numpy(), np.asarray(target),
                               atol=1e-6, rtol=0)
    # fp32 both ways through the tiny UNet and text tower
    np.testing.assert_allclose(got_pred.detach().numpy(), np.asarray(pred),
                               atol=1e-5, rtol=0)
    loss = model.loss_fn({k: torch.from_numpy(v) for k, v in batch.items()},
                         noise=_t(noise), timesteps=_t(want_t))
    assert float(loss.detach()) == pytest.approx(
        float(jmodel.loss((pred, target))), rel=1e-5)


@pytest.mark.parametrize("kind", ["ddim", "sde", "ode"])
def test_generate_matches_jax(monkeypatch, kind):
    monkeypatch.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "0")
    jmodel = tiny_pixel_diffusion(continuous_time=kind != "ddim",
                                  use_ode=kind == "ode")
    params, frozen = jmodel.init_params(jax.random.key(3), image_size=HW)
    ids = _batch(jmodel)["captions"]
    steps, seed = 5, 21
    want = jmodel.generate(params, frozen, jnp.asarray(ids), height=HW,
                           width=HW, guidance_scale=3.0,
                           num_inference_steps=steps, seed=seed)
    # JAX's draws: the initial latents from r_init, then one key split off
    # r_loop per SDE step
    r_init, key = jax.random.split(jax.random.key(seed))
    shape = (2, HW, HW, 3)
    latents = jax.random.normal(r_init, shape, jnp.float32)
    sde_noise = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        sde_noise.append(_t(jax.random.normal(sub, shape, jnp.float32)))

    model = _port_pixel(jmodel, params, frozen)
    got = model.generate(torch.from_numpy(ids), height=HW, width=HW,
                         guidance_scale=3.0, num_inference_steps=steps,
                         latents=_t(latents),
                         sde_noise=sde_noise if kind == "sde" else None)
    assert got.shape == shape and float(got.min()) >= 0.0 \
        and float(got.max()) <= 1.0
    # fp32 both ways, 5 CFG steps
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=0)
    # drawn from the seed, the port's own stream: deterministic, clipped
    a = model.generate(torch.from_numpy(ids), height=HW, width=HW,
                       num_inference_steps=2, seed=seed)
    b = model.generate(torch.from_numpy(ids), height=HW, width=HW,
                       num_inference_steps=2, seed=seed)
    assert torch.equal(a, b)


def test_eval_forward_uses_val_seed(monkeypatch):
    monkeypatch.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "0")
    jmodel = tiny_pixel_diffusion(continuous_time=True)
    params, frozen = jmodel.init_params(jax.random.key(5), image_size=HW)
    model = dataclasses.replace(_port_pixel(jmodel, params, frozen),
                                val_guidance_scales=(2.0,))
    batch = {k: torch.from_numpy(v) for k, v in _batch(jmodel).items()}
    a = model.eval_forward(batch, num_inference_steps=2, height=HW,
                           width=HW)
    b = model.eval_forward(batch, num_inference_steps=2, height=HW,
                           width=HW)
    assert torch.equal(a["timesteps"], b["timesteps"])
    assert torch.equal(a["generated"][2.0], b["generated"][2.0])
    assert a["generated"][2.0].shape == (2, HW, HW, 3)
    assert float(a["timesteps"].max()) < 1.570795


def test_pixel_builders(monkeypatch):
    """The full-width builders' UNet and text configs, dtype and schedulers
    as the JAX builders configure them (`_pixel`, which draws the weights,
    is stubbed: a full-width model is the card's), and `_pixel` itself at
    the tiny geometry on the CPU."""
    from diffusion_tpu.models import models as jmodels
    built = {}

    def stub(unet_cfg, text_cfg, tokenizer, dtype, device, seed, **fields):
        built.update(unet_cfg=unet_cfg, text_cfg=text_cfg, dtype=dtype,
                     device=device, **fields)

    monkeypatch.setattr(tmodels, "_pixel", stub)
    for name in ("discrete_pixel_diffusion", "continuous_pixel_diffusion"):
        jm = getattr(jmodels, name)(prediction_type="v_prediction")
        built.clear()
        getattr(tmodels, name)(prediction_type="v_prediction", device="cpu")
        assert built["unet_cfg"] == UNetConfig(**{
            f: getattr(jm.unet.config, f)
            for f in UNetConfig.__dataclass_fields__}) == PIXEL_UNET
        assert built["dtype"] == torch.bfloat16
        assert built["text_cfg"] == CLIPTextConfig(**{
            f: getattr(jm.text_encoder.config, f)
            for f in CLIPTextConfig.__dataclass_fields__})
        assert built.get("continuous_time", False) == jm.continuous_time
        assert built["prediction_type"] == "v_prediction"
        for attr in ("noise_scheduler", "inference_scheduler"):
            js, ts = getattr(jm, attr), built[attr]
            for f in ("t_max", "use_ode", "prediction_type",
                      "num_train_timesteps", "beta_start", "beta_end",
                      "beta_schedule", "steps_offset"):
                if hasattr(js, f):
                    assert getattr(ts, f) == getattr(js, f), (name, attr, f)
    monkeypatch.undo()
    jm = tiny_pixel_diffusion()
    model = tmodels._pixel(
        UNetConfig(**{f: getattr(jm.unet.config, f)
                      for f in UNetConfig.__dataclass_fields__}),
        CLIPTextConfig(vocab_size=514, hidden_size=16, intermediate_size=32,
                       num_hidden_layers=2, num_attention_heads=2),
        jm.tokenizer, torch.float32, "cpu", 0,
        noise_scheduler=ContinuousTimeScheduler(t_max=1.570795),
        inference_scheduler=ContinuousTimeScheduler(t_max=1.56),
        continuous_time=True)
    assert model.unet.training and all(
        p.requires_grad for p in model.unet.parameters())
    assert not model.text_encoder.training and not any(
        p.requires_grad for p in model.text_encoder.parameters())
    # the device is CUDA unless the caller asks for the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        tmodels.continuous_pixel_diffusion()
