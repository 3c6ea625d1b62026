"""The port's VAE decoder and CLIP text tower against the JAX package
(tiny geometry, fp32, same weights through `port_jax`) and the VAE golden
fixtures' `decoded` field."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_tpu.models.models import stable_diffusion_tiny as jax_tiny
from diffusion_tpu.text.tokenizer import tiny_tokenizer
from diffusion_torch.models.clip import CLIPTextConfig, CLIPTextModel
from diffusion_torch.models.port_jax import clip_text_from_jax, vae_from_jax
from diffusion_torch.models.vae import AutoencoderKL, VAEConfig
from tools.capture_goldens import VAE_GOLDENS

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _port_config(cls, jax_cfg):
    return cls(**{f: getattr(jax_cfg, f) for f in cls.__dataclass_fields__})


@pytest.mark.parametrize("hw", [(4, 4), (4, 6)])
def test_decoder_matches_jax(monkeypatch, hw):
    monkeypatch.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "0")
    jvae = jax_tiny().vae
    params = jvae.init(jax.random.key(1), jnp.zeros((1, 32, 32, 3)),
                       jax.random.key(2))
    z = np.random.default_rng(hw[1]).standard_normal(
        (2, *hw, 4)).astype(np.float32)
    want = jvae.apply(params, jnp.asarray(z), method=jvae.decode)
    vae = AutoencoderKL(_port_config(VAEConfig, jvae.config))
    vae.load_state_dict(vae_from_jax(params))
    with torch.no_grad():
        got = vae.decode(torch.from_numpy(z).permute(0, 3, 1, 2))
    # fp32 both ways: summation order through ~15 convs
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", sorted(VAE_GOLDENS))
def test_decoder_golden_fixture(name):
    data = np.load(os.path.join(FIXTURES, name), allow_pickle=True)
    weights = {k[2:]: torch.from_numpy(data[k]) for k in data.files
               if k.startswith(("w:decoder.", "w:post_quant_conv."))}
    vae = AutoencoderKL(VAEConfig(**VAE_GOLDENS[name]["spec"]))
    vae.load_state_dict(weights)
    with torch.no_grad():
        got = vae.decode(torch.from_numpy(data["latent"]))
    # the tolerance tests/test_hf_parity.py holds the JAX VAE to
    np.testing.assert_allclose(got.numpy(), data["decoded"],
                               atol=1e-4, rtol=1e-3)


def test_clip_text_matches_jax():
    jtext = jax_tiny().text_encoder
    ids = tiny_tokenizer()(["a photo of a cat", "", "zebra stripes!"])[
        "input_ids"]
    params = jtext.init(jax.random.key(3), jnp.asarray(ids))
    want_hidden, want_pooled = jtext.apply(params, jnp.asarray(ids))
    text = CLIPTextModel(_port_config(CLIPTextConfig, jtext.config))
    text.load_state_dict(clip_text_from_jax(params))
    with torch.no_grad():
        hidden, pooled = text(torch.from_numpy(ids))
    # fp32 both ways; flax LayerNorm takes the one-pass variance
    np.testing.assert_allclose(hidden.numpy(), np.asarray(want_hidden),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pooled),
                               atol=1e-4, rtol=1e-4)
