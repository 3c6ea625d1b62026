"""The port's DDPM tables and DDIM sampler against the JAX schedulers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_tpu.schedulers import ddpm as jddpm
from diffusion_tpu.schedulers.ddim import DDIMScheduler as JaxDDIM
from diffusion_torch.schedulers import ddpm as tddpm
from diffusion_torch.schedulers.ddim import DDIMScheduler

torch.set_num_threads(1)


@pytest.mark.parametrize("schedule", ["linear", "scaled_linear",
                                      "squaredcos_cap_v2"])
@pytest.mark.parametrize("rescale", [False, True])
def test_alphas_cumprod_match(schedule, rescale):
    want = jddpm.DDPMScheduler(beta_schedule=schedule,
                               rescale_betas_zero_snr=rescale).alphas_cumprod
    got = tddpm.DDPMScheduler(beta_schedule=schedule,
                              rescale_betas_zero_snr=rescale).alphas_cumprod
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("steps,spacing,offset", [
    (50, "leading", 1), (4, "leading", 1), (1000, "leading", 1),
    (25, "trailing", 0), (7, "trailing", 0)])
def test_timestep_grid_matches(steps, spacing, offset):
    want = jddpm.uniform_timestep_grid(1000, steps, offset, spacing)
    got = tddpm.uniform_timestep_grid(1000, steps, offset, spacing)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


@pytest.mark.parametrize("prediction_type,rescale,spacing", [
    ("epsilon", False, "leading"), ("sample", False, "leading"),
    ("v_prediction", True, "trailing")])
def test_ddim_steps_match(prediction_type, rescale, spacing):
    kw = dict(prediction_type=prediction_type, rescale_betas_zero_snr=rescale,
              timestep_spacing=spacing)
    jsched, tsched = JaxDDIM(**kw), DDIMScheduler(**kw)
    ts, tps = tsched.timesteps(5)
    np.testing.assert_array_equal(ts, JaxDDIM(**kw).timesteps(5)[0])
    assert tsched.init_noise_sigma == jsched.init_noise_sigma
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    for t, tp in zip(ts, tps):                   # the last step has tp < 0
        out = rng.standard_normal(x.shape).astype(np.float32)
        want = jsched.step(jnp.asarray(out), jnp.asarray(t), jnp.asarray(tp),
                           jnp.asarray(x))
        got = tsched.step(torch.from_numpy(out), t, tp, torch.from_numpy(x))
        # fp32 coefficients both ways; XLA may fuse the multiply-adds
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
        x = np.array(want)                       # writable, for from_numpy


def test_ddim_rejects_what_jax_rejects():
    with pytest.raises(ValueError, match="v_prediction"):
        DDIMScheduler(rescale_betas_zero_snr=True, timestep_spacing="trailing")
    with pytest.raises(ValueError, match="trailing"):
        DDIMScheduler(rescale_betas_zero_snr=True,
                      prediction_type="v_prediction")


def test_ddpm_fields_and_betas_match():
    """The training scheduler carries the JAX dataclass's fields (all but
    `clip_sample`, which no sampler of the port reads) and defaults, and the
    same fp32 betas."""
    want, got = jddpm.DDPMScheduler(), tddpm.DDPMScheduler()
    fields = set(tddpm.DDPMScheduler.__dataclass_fields__)
    assert fields == set(jddpm.DDPMScheduler.__dataclass_fields__) - {
        "clip_sample"}
    assert all(getattr(got, f) == getattr(want, f) for f in fields)
    np.testing.assert_array_equal(got.betas.numpy(), np.asarray(want.betas))
    assert len(got) == len(want) and got.init_noise_sigma == 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rescale", [False, True])
def test_add_noise_and_velocity_match(dtype, rescale):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 4, 4, 4)).astype(np.float32)
    eps = rng.standard_normal(x.shape).astype(np.float32)
    t = np.array([0, 517, 999], np.int64)
    jsched = jddpm.DDPMScheduler(rescale_betas_zero_snr=rescale)
    tsched = tddpm.DDPMScheduler(rescale_betas_zero_snr=rescale)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    for name in ("add_noise", "get_velocity"):
        want = getattr(jsched, name)(jx, jnp.asarray(eps), jnp.asarray(t))
        got = getattr(tsched, name)(tx, torch.from_numpy(eps),
                                    torch.from_numpy(t))
        assert got.dtype == tx.dtype
        # fp32 arithmetic on both sides, then one cast to the sample's dtype
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want).astype(np.float32),
                                   atol=1e-6 if dtype == "float32" else 1e-2,
                                   rtol=1e-6 if dtype == "float32" else 1e-2)
