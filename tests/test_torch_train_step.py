"""The training slice's step against the JAX package: `loss_fn` and the
UNet gradient on the tiny geometry, with the same weights (through
`port_jax`) and JAX's own timesteps and noise, drawn as its `forward` draws
them and handed to the port explicitly. Also the builders' training
arguments and the device default."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_tpu.models.models import stable_diffusion_tiny as jax_tiny
from diffusion_torch.models import models as tmodels
from diffusion_torch.models.models import stable_diffusion_tiny
from diffusion_torch.models.port_jax import unet_from_jax
from diffusion_torch.models.unet import UNet2DCondition
from diffusion_torch.utils import device as tdevice

torch.set_num_threads(1)


def _batch(seed, b=2, hw=8, ctx_len=8):
    rng = np.random.default_rng(seed)
    return {"image_latents": rng.standard_normal((b, hw, hw, 4)).astype(
                np.float32),
            "caption_latents": rng.standard_normal((b, ctx_len, 32)).astype(
                np.float32)}


def _jax_draws(rng, shape):
    """(timesteps, noise) as `StableDiffusion.forward` draws them."""
    _, r_t, r_noise = jax.random.split(rng, 3)
    t = jax.random.randint(r_t, (shape[0],), 0, 1000)
    noise = jax.random.normal(r_noise, shape, jnp.float32)
    return np.array(t), np.array(noise)           # writable copies


@pytest.mark.parametrize("prediction_type,gamma", [
    ("epsilon", None), ("v_prediction", None), ("epsilon", 5.0),
    ("v_prediction", 5.0), ("sample", 5.0)])
def test_loss_and_unet_grad_match_jax(monkeypatch, prediction_type, gamma):
    # the fused Pallas GroupNorm's backward raises on its cotangent shape
    # (ROADMAP.md queue 3, fault 1): take JAX's gradient on the XLA paths
    monkeypatch.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "0")
    kwargs = dict(precomputed_latents=True, prediction_type=prediction_type,
                  min_snr_gamma=gamma)
    jsd = jax_tiny(**kwargs)
    params, frozen = jsd.init_params(jax.random.key(0), image_size=64)
    assert frozen == {}                  # no towers on the latent path
    batch = _batch(seed=3)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.key(11)
    want_loss, want_grads = jax.value_and_grad(jsd.loss_fn)(
        params, frozen, jbatch, rng)
    t, noise = _jax_draws(rng, batch["image_latents"].shape)

    model = stable_diffusion_tiny(device="cpu", **kwargs)
    assert model.vae is None and model.text_encoder is None
    unet = model.unet
    assert unet.training and all(p.requires_grad for p in unet.parameters())
    unet.load_state_dict(unet_from_jax(params))
    loss = model.loss_fn({k: torch.from_numpy(v) for k, v in batch.items()},
                         noise=torch.from_numpy(noise),
                         timesteps=torch.from_numpy(t))
    loss.backward()
    # fp32 both ways: summation order through ~20 layers and their VJPs
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = unet_from_jax(want_grads)
    got = {n: p.grad for n, p in unet.named_parameters()}
    assert sorted(got) == sorted(want)
    scale = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                   atol=1e-5 * scale, rtol=1e-3,
                                   err_msg=name)


def test_forward_draws_from_the_generator():
    """Without explicit draws, timesteps then noise come from the given
    generator: the same seed gives the same loss."""
    model = stable_diffusion_tiny(device="cpu", precomputed_latents=True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(seed=4).items()}
    with torch.no_grad():
        a, b, c = (model.loss_fn(batch, torch.Generator().manual_seed(s))
                   for s in (5, 5, 6))
    assert a.item() == b.item() != c.item()
    pred, target, t = model.forward(batch, torch.Generator().manual_seed(5))
    assert pred.shape == target.shape == batch["image_latents"].shape
    assert pred.dtype == torch.float32 and t.shape == (2,)


def test_unported_training_paths_raise():
    model = stable_diffusion_tiny(device="cpu", precomputed_latents=True)
    raw = {"image": torch.zeros(2, 64, 64, 3),
           "captions": torch.zeros(2, 77, dtype=torch.int64)}
    # a raw batch on a model built without its towers: JAX's RuntimeError
    with pytest.raises(RuntimeError, match="init_frozen_towers=True"):
        model.loss_fn(raw)
    towers = stable_diffusion_tiny(device="cpu", precomputed_latents=True,
                                   init_frozen_towers=True)
    loss = towers.loss_fn(raw, torch.Generator().manual_seed(0))
    loss.backward()
    assert torch.isfinite(loss) and all(
        p.grad is None for p in (*towers.vae.parameters(),
                                 *towers.text_encoder.parameters()))
    with pytest.raises(RuntimeError, match="init_frozen_towers"):
        model.generate(torch.zeros(1, 77, dtype=torch.int64))
    # remat builds and computes the same function
    remat = UNet2DCondition(model.unet.config, remat=True)
    remat.load_state_dict(model.unet.state_dict())
    sample = torch.randn(1, 4, 8, 8).contiguous(
        memory_format=torch.channels_last)
    assert torch.equal(remat(sample, torch.tensor([3]), torch.ones(1, 8, 32)),
                       model.unet(sample, torch.tensor([3]),
                                  torch.ones(1, 8, 32)))
    assert stable_diffusion_tiny(device="cpu").vae is not None   # serving
    model = stable_diffusion_tiny(device="cpu", precomputed_latents=True,
                                  init_frozen_towers=True)
    assert not any(p.requires_grad for p in model.vae.parameters())
    # dropout in training: a loss that depends on the key; eval drops none
    model.unet.mid_block.resnets[0].dropout = 0.1
    batch = {"image_latents": torch.ones(1, 8, 8, 4),
             "caption_latents": torch.ones(1, 8, 32)}
    draws = (torch.ones(1, 8, 8, 4), torch.tensor([100]))
    a, b = (model.loss_fn(batch, None, *draws, dropout_key=(k,))
            for k in (1, 2))
    assert torch.isfinite(a) and not torch.equal(a, b)
    assert torch.equal(a, model.loss_fn(batch, None, *draws,
                                        dropout_key=(1,)))
    model.unet.eval()
    assert torch.equal(*(model.loss_fn(batch, None, *draws, dropout_key=(k,))
                         for k in (1, 2)))


@pytest.mark.parametrize("builder", ["stable_diffusion_tiny",
                                     "stable_diffusion_2"])
def test_builders_default_to_cuda_and_raise_without_it(monkeypatch, builder):
    """`device=None` means CUDA: without a CUDA device a builder raises,
    naming the CPU argument, before it builds anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        getattr(tmodels, builder)()
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tdevice.resolve_device(None) == torch.device("cuda")
