"""Remat and ResnetBlock dropout in the port against the JAX package (tiny
geometry, fp32, weights through `port_jax`, JAX's own draws handed over):

- remat: the tiny model's loss and UNet gradient with `remat=True` against
  JAX's with `remat=True`, at the train-step test's tolerance; the port's
  remat gradient against its own without remat; the flash forward (a
  dispatcher op the remat policy keeps) runs once per attention call, not
  again in the backward;
- dropout, as JAX's `tests/test_model.py::test_unet_dropout_wired`: no key
  (or eval mode) is JAX's deterministic output; a key perturbs the output,
  the output depends on the key and reproduces under it; the kept share is
  within 3 sigma of 1 - p; remat with dropout gives the gradient without
  remat under the same key. The masks are never compared with JAX's
  (threefry is not Philox)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_tpu.models.models import stable_diffusion_tiny as jax_tiny
from diffusion_tpu.models.unet import UNet2DCondition as JaxUNet
from diffusion_torch.models.layers import dropout
from diffusion_torch.models.models import stable_diffusion_tiny
from diffusion_torch.models.port_jax import unet_from_jax
from diffusion_torch.models.unet import UNet2DCondition
from diffusion_torch.ops import attention
from diffusion_torch.ops import flash_attention as fa

torch.set_num_threads(1)


def _batch(seed=3, b=2, hw=8):
    rng = np.random.default_rng(seed)
    return {"image_latents": rng.standard_normal((b, hw, hw, 4)).astype(
                np.float32),
            "caption_latents": rng.standard_normal((b, 8, 32)).astype(
                np.float32)}


def _port(unet_cfg=None, remat=False, weights=None, **kwargs):
    model = stable_diffusion_tiny(device="cpu", precomputed_latents=True,
                                  **kwargs)
    cfg = unet_cfg or model.unet.config
    unet = UNet2DCondition(cfg, remat=remat)
    unet.load_state_dict(weights if weights is not None
                         else model.unet.state_dict())
    return dataclasses.replace(model, unet=unet)


def _grads(model, batch, **draws):
    model.unet.zero_grad(set_to_none=True)
    loss = model.loss_fn({k: torch.from_numpy(v) for k, v in batch.items()},
                         **draws)
    loss.backward()
    return loss, {n: p.grad.clone() for n, p in model.unet.named_parameters()}


def test_remat_loss_and_grad_match_jax(monkeypatch):
    monkeypatch.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "0")
    jsd = jax_tiny(precomputed_latents=True, prediction_type="v_prediction")
    jsd = dataclasses.replace(jsd, unet=JaxUNet(jsd.unet.config,
                                                dtype=jsd.unet.dtype,
                                                remat=True))
    params, frozen = jsd.init_params(jax.random.key(0), image_size=64)
    batch = _batch()
    rng = jax.random.key(11)
    want_loss, want_grads = jax.value_and_grad(jsd.loss_fn)(
        params, frozen, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    _, r_t, r_noise = jax.random.split(rng, 3)
    t = np.array(jax.random.randint(r_t, (2,), 0, 1000))
    noise = np.array(jax.random.normal(r_noise, (2, 8, 8, 4), jnp.float32))

    model = _port(remat=True, weights=unet_from_jax(params),
                  prediction_type="v_prediction")
    assert model.unet.remat
    loss, got = _grads(model, batch, noise=torch.from_numpy(noise),
                       timesteps=torch.from_numpy(t))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = unet_from_jax(want_grads)
    assert sorted(got) == sorted(want)
    # tests/test_torch_train_step.py's gradient tolerance
    scale = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                   atol=1e-5 * scale, rtol=1e-3,
                                   err_msg=name)


def _draws(seed=5, b=2, hw=8):
    rng = np.random.default_rng(seed)
    return {"noise": torch.from_numpy(rng.standard_normal(
                (b, hw, hw, 4)).astype(np.float32)),
            "timesteps": torch.tensor([17, 803])}


@pytest.mark.parametrize("drop", [0.0, 0.3])
def test_remat_gradient_equals_no_remat(drop):
    """The rematerialized UNet's gradient is the plain one's (1e-6), with
    dropout under the same key too."""
    base = _port()
    cfg = dataclasses.replace(base.unet.config, dropout=drop)
    weights = base.unet.state_dict()
    key = {"dropout_key": (7, 1)} if drop else {}
    plain_loss, plain = _grads(_port(cfg, False, weights), _batch(),
                               **_draws(), **key)
    remat_loss, remat = _grads(_port(cfg, True, weights), _batch(),
                               **_draws(), **key)
    assert remat_loss.item() == pytest.approx(plain_loss.item(), abs=1e-6)
    for name, g in plain.items():
        np.testing.assert_allclose(remat[name].numpy(), g.numpy(), atol=1e-6,
                                   rtol=0, err_msg=name)


def test_remat_keeps_the_flash_forward(monkeypatch):
    """With every unmasked attention sent to `flash_attention` (on the CPU
    its plain version), a remat forward and backward call the flash
    forward once per attention call: the policy keeps its (out, lse), as
    JAX's names flash_out/flash_lse. Without the policy's op list the
    backward would call it again."""
    calls = []
    real = fa.flash_attention_reference

    def counted(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(fa, "flash_attention_reference", counted)
    monkeypatch.setattr(attention, "flash_eligible", lambda *a: True)
    model = _port(remat=True)
    sample = torch.randn(2, 4, 8, 8).contiguous(
        memory_format=torch.channels_last)
    out = model.unet(sample, torch.tensor([3, 500]), torch.randn(2, 8, 32))
    n_fwd = len(calls)
    out.square().mean().backward()
    # 4 transformers, each a self- and a cross-attention
    assert n_fwd == 8 and len(calls) == n_fwd
    import diffusion_torch.models.unet as unet_mod
    monkeypatch.setattr(unet_mod, "remat_saved_ops", frozenset)
    calls.clear()
    model.unet(sample, torch.tensor([3, 500]),
               torch.randn(2, 8, 32)).square().mean().backward()
    assert len(calls) == 2 * n_fwd            # recomputed without it


def _jax_dropout_unet(p):
    cfg = jax_tiny().unet.config
    return JaxUNet(dataclasses.replace(cfg, dropout=p))


def test_dropout_eval_is_jax_deterministic_output(monkeypatch):
    monkeypatch.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "0")
    junet = _jax_dropout_unet(0.5)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([7, 300], np.int32)
    ctx = rng.standard_normal((2, 8, 32)).astype(np.float32)
    params = junet.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(t),
                        jnp.asarray(ctx))
    want = np.asarray(junet.apply(params, jnp.asarray(x), jnp.asarray(t),
                                  jnp.asarray(ctx)))
    unet = UNet2DCondition(junet.config)
    unet.load_state_dict(unet_from_jax(params))
    args = (torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t),
            torch.from_numpy(ctx))
    with torch.no_grad():
        for mode in (unet.train, unet.eval):
            mode()
            got = unet(*args).permute(0, 2, 3, 1).numpy()
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        # the models' forwards key the UNet only where it drops: training
        # mode (JAX: train=True, deterministic=False)
        assert not unet.drops
        unet.train()
        assert unet.drops


def test_dropout_perturbs_depends_on_the_key_and_reproduces():
    base = _port()
    cfg = dataclasses.replace(base.unet.config, dropout=0.5)
    unet = UNet2DCondition(cfg)
    unet.load_state_dict(base.unet.state_dict())
    assert unet.drops
    sample = torch.randn(1, 4, 8, 8).contiguous(
        memory_format=torch.channels_last)
    args = (sample, torch.tensor([7]), torch.randn(1, 8, 32))
    with torch.no_grad():
        det = unet(*args)
        a, a2, b = (unet(*args, dropout_key=k) for k in ((1,), (1,), (2,)))
    assert (a - det).abs().max() > 0 and (a - b).abs().max() > 0
    assert torch.equal(a, a2)
    # the model's training forward keys it: the same key, the same loss
    model = dataclasses.replace(base, unet=unet)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    losses = [model.loss_fn(batch, **_draws(), dropout_key=k).item()
              for k in ((3, 0), (3, 0), (4, 0))]
    assert losses[0] == losses[1] != losses[2]


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_keeps_one_minus_p(p):
    """The kept share over 2^18 elements is within 3 sigma of 1 - p, and
    the kept values are scaled by 1 / (1 - p), as flax's Dropout."""
    h = torch.ones(4, 16, 64, 64).contiguous(
        memory_format=torch.channels_last)
    out = dropout(h, p, (11, 2))
    kept = out != 0
    n = kept.numel()
    share = kept.float().mean().item()
    assert abs(share - (1 - p)) <= 3 * (p * (1 - p) / n) ** 0.5
    np.testing.assert_allclose(out[kept].numpy(), 1.0 / (1.0 - p), rtol=1e-6)
    assert out.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(out, dropout(h, p, (11, 2)))
    assert not torch.equal(out, dropout(h, p, (11, 3)))
