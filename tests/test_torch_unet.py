"""The port's UNet2DCondition against the JAX UNet (tiny geometry, fp32,
same weights through `port_jax`) and against the committed diffusers-named
golden fixtures, loaded straight into the port."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_tpu.models.models import stable_diffusion_tiny as jax_tiny
from diffusion_torch.models.port_jax import unet_from_jax
from diffusion_torch.models.unet import UNet2DCondition, UNetConfig
from tools.capture_goldens import UNET_GOLDENS

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.mark.parametrize("hw", [(8, 8), (8, 16)])
def test_unet_matches_jax(monkeypatch, hw):
    monkeypatch.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "0")
    junet = jax_tiny().unet
    rng = np.random.default_rng(hw[1])
    sample = rng.standard_normal((2, *hw, 4)).astype(np.float32)
    t = np.array([3, 871], np.int32)
    ctx = rng.standard_normal((2, 9, 32)).astype(np.float32)
    params = junet.init(jax.random.key(hw[1]), jnp.asarray(sample),
                        jnp.asarray(t), jnp.asarray(ctx))
    want = junet.apply(params, jnp.asarray(sample), jnp.asarray(t),
                       jnp.asarray(ctx))
    cfg = UNetConfig(**{f: getattr(junet.config, f)
                        for f in UNetConfig.__dataclass_fields__})
    unet = UNet2DCondition(cfg)
    unet.load_state_dict(unet_from_jax(params))
    with torch.no_grad():
        got = unet(torch.from_numpy(sample).permute(0, 3, 1, 2),
                   torch.from_numpy(t), torch.from_numpy(ctx))
    assert got.dtype == torch.float32
    # fp32 both ways: summation order through ~20 layers
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", sorted(UNET_GOLDENS))
def test_unet_golden_fixture(name):
    """diffusers-named `w:*` tensors load into the port as they are (strict)
    and reproduce the golden output; the convproj/pixel fixtures cover the
    1x1-conv transformer projections."""
    data = np.load(os.path.join(FIXTURES, name), allow_pickle=True)
    weights = {k[2:]: torch.from_numpy(data[k]) for k in data.files
               if k.startswith("w:")}
    unet = UNet2DCondition(UNetConfig(**UNET_GOLDENS[name]["spec"]))
    unet.load_state_dict(weights)
    with torch.no_grad():
        got = unet(torch.from_numpy(data["sample"]).contiguous(
            memory_format=torch.channels_last),
            torch.from_numpy(data["timesteps"]),
            torch.from_numpy(data["encoder_hidden_states"]))
    # the tolerance tests/test_hf_parity.py holds the JAX UNet to
    np.testing.assert_allclose(got.numpy(), data["expected"],
                               atol=1e-4, rtol=1e-3)
