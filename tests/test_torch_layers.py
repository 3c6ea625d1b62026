"""The port's layers against the JAX package's, at the tiny geometry, fp32:
JAX `init` -> `port_jax` -> the port, and the ResnetBlock, Transformer2D,
Upsample and GroupNorm outputs compared inside one UNet forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diffusion_tpu.models import layers as jlayers
from diffusion_tpu.models.models import stable_diffusion_tiny as jax_tiny
from diffusion_torch.models import layers as tlayers
from diffusion_torch.models.port_jax import unet_from_jax
from diffusion_torch.models.unet import UNet2DCondition, UNetConfig

torch.set_num_threads(1)


def _tiny_unet_config(jax_cfg) -> UNetConfig:
    return UNetConfig(**{f: getattr(jax_cfg, f)
                         for f in UNetConfig.__dataclass_fields__})


@pytest.fixture(scope="module")
def tiny():
    """(JAX UNet, its params, the port's UNet with those weights, inputs)."""
    jsd = jax_tiny()
    rng = np.random.default_rng(0)
    sample = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([10, 500], np.int32)
    ctx = rng.standard_normal((2, 7, 32)).astype(np.float32)
    params = jsd.unet.init(jax.random.key(0), jnp.asarray(sample),
                           jnp.asarray(t), jnp.asarray(ctx))
    unet = UNet2DCondition(_tiny_unet_config(jsd.unet.config))
    unet.load_state_dict(unet_from_jax(params))
    return jsd.unet, params, unet, (sample, t, ctx)


def _nchw(x):
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2)


# which port submodule produced each JAX scope's output
_BLOCKS = {
    "down_0_res_0": lambda u: u.down_blocks[0].resnets[0],
    "down_0_attn_0": lambda u: u.down_blocks[0].attentions[0],
    "mid_res_1": lambda u: u.mid_block.resnets[1],
    "mid_attn": lambda u: u.mid_block.attentions[0],
    "up_0_upsample": lambda u: u.up_blocks[0].upsamplers[0],
    "up_1_attn_1": lambda u: u.up_blocks[1].attentions[1],
    "conv_norm_out": lambda u: u.conv_norm_out,
}


@pytest.mark.parametrize("scope", sorted(_BLOCKS))
def test_block_outputs_match_jax(monkeypatch, tiny, scope):
    monkeypatch.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "0")
    junet, params, unet, (sample, t, ctx) = tiny
    _, state = junet.apply(params, jnp.asarray(sample), jnp.asarray(t),
                           jnp.asarray(ctx), capture_intermediates=True,
                           mutable=["intermediates"])
    want = np.asarray(state["intermediates"][scope]["__call__"][0])
    got = {}
    handle = _BLOCKS[scope](unet).register_forward_hook(
        lambda mod, inp, out: got.setdefault("out", out))
    try:
        with torch.no_grad():
            unet(_nchw(sample), torch.from_numpy(t), torch.from_numpy(ctx))
    finally:
        handle.remove()
    out = got["out"]
    assert out.is_contiguous(memory_format=torch.channels_last)
    # fp32 both ways; the blocks' outputs are O(1)-O(10), summation order
    # differs across a few convs and matmuls
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-4, rtol=1e-4)


def test_timestep_embedding_matches_jax():
    t = np.array([0, 1, 10, 500, 999], np.int32)
    for dim, flip, shift in ((32, True, 0.0), (33, False, 1.0)):
        want = jlayers.timestep_embedding(jnp.asarray(t), dim, flip, shift)
        got = tlayers.timestep_embedding(torch.from_numpy(t), dim, flip, shift)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)


def test_nearest_upsample_matches_jax_resize_exactly():
    x = np.random.default_rng(1).standard_normal((2, 5, 3, 4)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, 10, 6, 4), method="nearest")
    got = F.interpolate(_nchw(x), scale_factor=2.0, mode="nearest")
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


def test_group_norm_module_matches_jax(monkeypatch):
    monkeypatch.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "0")
    x = np.random.default_rng(2).standard_normal((2, 4, 6, 16)).astype(np.float32)
    jmod = jlayers.GroupNorm(4, 1e-6, act="silu")
    jp = jmod.init(jax.random.key(1), jnp.asarray(x))
    rng = np.random.default_rng(3)
    jp = {"params": {"scale": rng.standard_normal(16).astype(np.float32),
                     "bias": rng.standard_normal(16).astype(np.float32)}}
    want = jmod.apply(jp, jnp.asarray(x))
    mod = tlayers.GroupNorm(4, 16, 1e-6, act="silu")
    mod.load_state_dict({"weight": torch.from_numpy(jp["params"]["scale"]),
                         "bias": torch.from_numpy(jp["params"]["bias"])})
    with torch.no_grad():
        got = mod(_nchw(x))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-5, rtol=1e-5)
