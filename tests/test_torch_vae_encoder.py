"""The port's VAE encoder and posterior against the JAX package (tiny
geometry, fp32, the same weights through `port_jax`, JAX's own eps handed
to `sample`), against the diffusers goldens' `latent_mean`, and the DDIM
`noise_to` that img2img enters the trajectory with."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_tpu.models.models import stable_diffusion_tiny as jax_tiny
from diffusion_tpu.models.vae import DiagonalGaussian as JaxPosterior
from diffusion_tpu.schedulers.ddim import DDIMScheduler as JaxDDIM
from diffusion_torch.models.port_jax import vae_from_jax
from diffusion_torch.models.vae import (AutoencoderKL, DiagonalGaussian,
                                        VAEConfig)
from diffusion_torch.schedulers import DDIMScheduler
from tools.capture_goldens import VAE_GOLDENS

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _port_vae(jvae, params):
    vae = AutoencoderKL(VAEConfig(**{f: getattr(jvae.config, f)
                                     for f in VAEConfig.__dataclass_fields__}))
    vae.load_state_dict(vae_from_jax(params))
    return vae


@pytest.mark.parametrize("hw", [(32, 32), (32, 48), (40, 24)])
def test_encoder_matches_jax(monkeypatch, hw):
    """mean, logvar and sample(eps) of the posterior at square and
    asymmetric sizes (the (0, 1) pad of each stride-2 downsample)."""
    monkeypatch.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "0")
    jvae = jax_tiny().vae
    params = jvae.init(jax.random.key(4), jnp.zeros((1, 32, 32, 3)),
                       jax.random.key(5))
    rng = np.random.default_rng(hw[1])
    x = rng.uniform(-1, 1, (2, *hw, 3)).astype(np.float32)
    post = jvae.apply(params, jnp.asarray(x), method=jvae.encode)
    key = jax.random.key(9)
    want_sample = post.sample(key)
    eps = np.array(jax.random.normal(key, post.mean.shape, jnp.float32))

    vae = _port_vae(jvae, params)
    with torch.no_grad():
        got = vae.encode(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert isinstance(got, DiagonalGaussian)
    assert got.mean.shape == (2, 4, hw[0] // 8, hw[1] // 8)
    nhwc = lambda t: t.permute(0, 2, 3, 1).numpy()   # noqa: E731
    # fp32 both ways: summation order through ~12 convs
    for name, g, w in (("mean", nhwc(got.mean), post.mean),
                       ("logvar", nhwc(got.logvar), post.logvar),
                       ("sample", nhwc(got.sample(
                           torch.from_numpy(eps).permute(0, 3, 1, 2))),
                        want_sample)):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=1e-3,
                                   err_msg=name)


def test_posterior_matches_jax():
    """The split, the logvar clip to [-30, 20], std, mode and kl, on
    moments that reach both clips."""
    rng = np.random.default_rng(0)
    m = rng.standard_normal((2, 3, 5, 8)).astype(np.float32) * 20.0
    want = JaxPosterior(jnp.asarray(m))
    got = DiagonalGaussian(torch.from_numpy(m).permute(0, 3, 1, 2))
    assert float(got.logvar.min()) == -30.0 and float(got.logvar.max()) == 20.0
    for name, g, w in (("mean", got.mode(), want.mode()),
                       ("logvar", got.logvar, want.logvar),
                       ("std", got.std, want.std)):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), rtol=1e-6, err_msg=name)
    np.testing.assert_allclose(got.kl().numpy(), np.asarray(want.kl()),
                               rtol=1e-5)


@pytest.mark.parametrize("name", sorted(VAE_GOLDENS))
def test_encoder_golden_fixture(name):
    """The diffusers goldens' posterior mean, with the whole published VAE
    state_dict loaded (encoder and quant_conv included)."""
    data = np.load(os.path.join(FIXTURES, name), allow_pickle=True)
    weights = {k[2:]: torch.from_numpy(data[k]) for k in data.files
               if k.startswith("w:")}
    vae = AutoencoderKL(VAEConfig(**VAE_GOLDENS[name]["spec"]))
    vae.load_state_dict(weights)
    with torch.no_grad():
        got = vae.encode(torch.from_numpy(data["image"])).mean
    # the tolerance tests/test_hf_parity.py holds the JAX VAE to
    np.testing.assert_allclose(got.numpy(), data["latent_mean"],
                               atol=1e-4, rtol=1e-3)


def test_encoder_keeps_channels_last():
    """Every GroupNorm on the card reads a contiguous NHWC slab: the
    encoder's activations stay channels_last through the asymmetric pad."""
    vae = AutoencoderKL(VAEConfig(block_out_channels=(8, 8, 8, 8),
                                  layers_per_block=1, norm_num_groups=4))
    seen = []
    for module in vae.encoder.modules():
        if type(module).__name__ == "GroupNorm":
            module.register_forward_pre_hook(lambda m, inp: seen.append(
                inp[0].is_contiguous(memory_format=torch.channels_last)))
    with torch.no_grad():
        vae.encode(torch.zeros(1, 3, 24, 40))
    # 2 per resnet (4 blocks of 1, 2 in the mid block), the attention's,
    # conv_norm_out's (22 at SD2's 2 resnets a block)
    assert len(seen) == 14 and all(seen)


@pytest.mark.parametrize("t", [999, 500, 1])
def test_noise_to_matches_jax(t):
    rng = np.random.default_rng(t)
    x0, eps = (rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
               for _ in range(2))
    want = JaxDDIM().noise_to(jnp.asarray(x0), jnp.asarray(eps), t)
    got = DDIMScheduler().noise_to(torch.from_numpy(x0),
                                   torch.from_numpy(eps), t)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
