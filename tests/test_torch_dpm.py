"""The port's DPM-Solver++(2M) and Euler samplers against
`diffusion_tpu/schedulers/dpm.py`: grids, input scaling, `noise_to`,
`init_sigma`, whole multistep trajectories from fixed model outputs, the
zero-SNR refusals, and the builders' sampler registry."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_tpu.models import models as jmodels
from diffusion_tpu.schedulers import dpm as jdpm
from diffusion_tpu.schedulers.ddpm import DDPMScheduler as JaxDDPM
from diffusion_torch.models import models as tmodels
from diffusion_torch.schedulers import (DDIMScheduler, DDPMScheduler,
                                        DPMSolverMultistepScheduler,
                                        EulerDiscreteScheduler)

torch.set_num_threads(1)

PAIRS = {"dpm++2m": (jdpm.DPMSolverMultistepScheduler,
                     DPMSolverMultistepScheduler),
         "euler": (jdpm.EulerDiscreteScheduler, EulerDiscreteScheduler)}
SHAPE = (2, 4, 8, 8)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / np.linalg.norm(want))


@pytest.mark.parametrize("name", sorted(PAIRS))
@pytest.mark.parametrize("steps,spacing,offset", [
    (20, "leading", 1), (10, "leading", 1), (7, "trailing", 0)])
def test_grid_scaling_noise_to(name, steps, spacing, offset):
    jcls, tcls = PAIRS[name]
    kw = dict(timestep_spacing=spacing, steps_offset=offset)
    js, ts = jcls(**kw), tcls(**kw)
    np.testing.assert_array_equal(ts.alphas_cumprod,
                                  np.asarray(js.alphas_cumprod))
    grid = ts.timesteps(steps)
    for g, w in zip(grid, js.timesteps(steps)):
        np.testing.assert_array_equal(g, w)
    assert ts.init_noise_sigma == js.init_noise_sigma
    if name == "euler":
        assert ts.init_sigma(steps) == js.init_sigma(steps)
    rng = np.random.default_rng(steps)
    x0 = rng.standard_normal(SHAPE).astype(np.float32)
    eps = rng.standard_normal(SHAPE).astype(np.float32)
    for t in (int(grid[0][0]), int(grid[0][-1])):
        got = ts.noise_to(torch.from_numpy(x0), torch.from_numpy(eps), t)
        want = js.noise_to(jnp.asarray(x0), jnp.asarray(eps), t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
        got = ts.scale_model_input(torch.from_numpy(x0), t)
        want = js.scale_model_input(jnp.asarray(x0), t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=0)


def test_euler_init_sigma_is_the_grid_top():
    """x_T's scale is sigma at the inference grid's first step (about
    14.6 at 20 steps), not the full grid's sigma(999)."""
    s = EulerDiscreteScheduler()
    assert 1.3 < s.init_noise_sigma / s.init_sigma(20) < 1.4
    assert s.init_sigma(20) == pytest.approx(
        float(np.sqrt((1 - s.alphas_cumprod[951].astype(np.float64))
                      / s.alphas_cumprod[951])), rel=1e-6)


def _trajectory(sched, outputs, x, jax_side: bool):
    ts, tps = sched.timesteps(len(outputs))
    n = len(ts)
    lat = jnp.asarray(x) if jax_side else torch.from_numpy(x)
    multistep = hasattr(sched, "init_state")
    state = sched.init_state(lat) if multistep else None
    path = []
    for i, (t, tp) in enumerate(zip(ts, tps)):
        out = (jnp.asarray(outputs[i]) if jax_side
               else torch.from_numpy(outputs[i]))
        if multistep:
            lat, state = sched.step_with_state(out, int(t), int(tp), lat,
                                               state, i, n)
        else:
            lat = sched.step(out, int(t), int(tp), lat)
        path.append(np.asarray(lat))
    return path


@pytest.mark.parametrize("name", sorted(PAIRS))
@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction",
                                             "sample"])
@pytest.mark.parametrize("steps", [10, 20])
def test_trajectory_matches_jax(name, prediction_type, steps):
    """Every latent of a whole run from the same fixed model outputs, on
    both sides of DPM++'s `num_steps < 15` terminal first-order gate.
    fp32 on both sides, from the same fp32 alpha-bar table. numpy's fp32
    log and XLA's differ by an ulp at some timesteps, so a lambda can be
    one ulp apart; h is a difference of two lambdas and the 2M correction
    divides by h_last / h, which amplifies that to about 1e-6 after 20
    steps (the worst case measured on the CPU: 2.6e-6, epsilon at 20
    steps). Bound: 1e-5 relative L2 at every step."""
    jcls, tcls = PAIRS[name]
    js, ts = jcls(prediction_type=prediction_type), \
        tcls(prediction_type=prediction_type)
    rng = np.random.default_rng(steps)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    if name == "euler":
        x = x * np.float32(ts.init_sigma(steps))
    outputs = [rng.standard_normal(SHAPE).astype(np.float32)
               for _ in range(steps)]
    want = _trajectory(js, outputs, x, True)
    got = _trajectory(ts, outputs, x, False)
    assert len(got) == len(want) == steps
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.isfinite(g).all()
        assert _rel(g, w) <= 1e-5, (i, _rel(g, w))


def test_dpm_gate_and_second_order():
    """The terminal step is first order below 15 steps and second order
    from 15 on; an interior step differs from the stateless first-order
    one only by the 2M correction."""
    s = DPMSolverMultistepScheduler()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(SHAPE).astype(np.float32))
    out = torch.from_numpy(rng.standard_normal(SHAPE).astype(np.float32))
    prev = (torch.from_numpy(rng.standard_normal(SHAPE).astype(np.float32)),
            np.float32(-2.0))
    for n, first_order in ((14, True), (15, False)):
        ts, tps = s.timesteps(n)
        last = n - 1
        a, _ = s.step_with_state(out, int(ts[last]), int(tps[last]), x, prev,
                                 last, n)
        b = s.step(out, int(ts[last]), int(tps[last]), x)
        assert torch.equal(a, b) is first_order
    ts, tps = s.timesteps(20)
    a, (x0, lam) = s.step_with_state(out, int(ts[3]), int(tps[3]), x, prev,
                                     3, 20)
    b = s.step(out, int(ts[3]), int(tps[3]), x)
    assert not torch.equal(a, b) and lam.dtype == np.float32
    # a first-order terminal step lands on the denoised prediction
    # (sigma -> 0 with the 1e-12 floor)
    ts, tps = s.timesteps(10)
    assert int(tps[-1]) < 0
    last, (x0, _) = s.step_with_state(out, int(ts[-1]), int(tps[-1]), x,
                                      prev, 9, 10)
    torch.testing.assert_close(last, x0, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_zero_snr_refusals(name):
    jcls, tcls = PAIRS[name]
    kw = dict(rescale_betas_zero_snr=True, prediction_type="v_prediction",
              timestep_spacing="trailing")
    with pytest.raises(ValueError) as want:
        jcls(**kw)
    with pytest.raises(ValueError) as got:
        tcls(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("requested,canonical", [
    ("ddim", "ddim"), ("DPM", "dpm++2m"), ("dpm++2m", "dpm++2m"),
    ("Euler", "euler")])
def test_canonical_scheduler_name(requested, canonical):
    assert tmodels.canonical_scheduler_name(requested) == canonical \
        == jmodels.canonical_scheduler_name(requested)
    sched = tmodels._make_inference_scheduler(requested)
    assert tmodels.canonical_scheduler_name(sched) == canonical
    assert tmodels.canonical_scheduler_name(DDPMScheduler()) is None
    with pytest.raises(ValueError, match="unknown inference_scheduler"):
        tmodels.canonical_scheduler_name("heun")
    with pytest.raises(ValueError, match="unknown inference_scheduler"):
        jmodels.canonical_scheduler_name("heun")


@pytest.mark.parametrize("name", ["ddim", "dpm++2m", "euler"])
def test_make_inference_scheduler_like(name):
    """`like=` carries the betas, prediction type, offset, spacing and
    zero-SNR flag across, as JAX's does; the builders use it."""
    jlike = JaxDDPM(beta_start=0.001, beta_end=0.02, beta_schedule="linear",
                    prediction_type="v_prediction",
                    timestep_spacing="trailing")
    tlike = DDPMScheduler(beta_start=0.001, beta_end=0.02,
                          beta_schedule="linear",
                          prediction_type="v_prediction",
                          timestep_spacing="trailing")
    want = jmodels._make_inference_scheduler(name, like=jlike)
    got = tmodels._make_inference_scheduler(name, like=tlike)
    for field in ("num_train_timesteps", "beta_start", "beta_end",
                  "beta_schedule", "prediction_type", "steps_offset",
                  "rescale_betas_zero_snr", "timestep_spacing"):
        assert getattr(got, field) == getattr(want, field), field
    assert tmodels.canonical_scheduler_name(got) == name
    model = tmodels.stable_diffusion_tiny(
        device="cpu", inference_scheduler=name.upper(),
        prediction_type="v_prediction", precomputed_latents=True)
    assert tmodels.canonical_scheduler_name(model.inference_scheduler) == name
    assert model.inference_scheduler.prediction_type == "v_prediction"
    # zero terminal SNR: DDIM takes it, the other two refuse it
    if name == "ddim":
        assert isinstance(tmodels.stable_diffusion_tiny(
            device="cpu", inference_scheduler=name,
            prediction_type="v_prediction", rescale_betas_zero_snr=True,
            precomputed_latents=True).inference_scheduler, DDIMScheduler)
    else:
        with pytest.raises(ValueError, match="zero terminal SNR"):
            tmodels.stable_diffusion_tiny(
                device="cpu", inference_scheduler=name,
                prediction_type="v_prediction", rescale_betas_zero_snr=True,
                precomputed_latents=True)


@pytest.mark.parametrize("cls", [DDIMScheduler, DPMSolverMultistepScheduler,
                                 EulerDiscreteScheduler])
def test_alpha_table_built_once(cls):
    """The fp32 alpha-bar table the samplers index every step is one
    read-only array per schedule, shared by every sampler object of it."""
    a, b = cls(), cls()
    assert a.alphas_cumprod is b.alphas_cumprod
    assert a.alphas_cumprod.dtype == np.float32
    assert not a.alphas_cumprod.flags.writeable
    assert cls(beta_end=0.02).alphas_cumprod is not a.alphas_cumprod
