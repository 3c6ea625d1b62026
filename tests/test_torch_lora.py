"""LoRA in the port against the JAX package (tiny geometry, fp32, weights
moved through `port_jax`, inputs and draws from numpy seeds or JAX's own
keys): a fresh adapter is the base model; the adapter UNet's output;
`fold_lora`; the refusals; two adapter-only training steps through both
Trainers; a pretrained base with a fresh adapter; and the endpoint serving
an adapter checkpoint."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from diffusion_tpu.models import lora as jlora
from diffusion_tpu.models.models import stable_diffusion_tiny as jax_tiny
from diffusion_tpu.models.pretrained import load_pretrained_params as jload
from diffusion_tpu.parallel.mesh import create_mesh
from diffusion_tpu.train import optim as joptim
from diffusion_tpu.train.events import Callback as JaxCallback
from diffusion_tpu.train.trainer import Trainer as JaxTrainer
from diffusion_torch.inference.inference_model import StableDiffusionInference
from diffusion_torch.models import lora as tlora
from diffusion_torch.models.layers import LoRALinear
from diffusion_torch.models.models import stable_diffusion_tiny
from diffusion_torch.models.port_jax import lora_jax_path, unet_from_jax
from diffusion_torch.models.unet import UNet2DCondition, UNetConfig
from diffusion_torch.train import optim as toptim
from diffusion_torch.train.events import Callback
from diffusion_torch.train.trainer import Trainer
from diffusion_torch.utils import safetensors as tsafe

torch.set_num_threads(1)

RANK = 4
SEED = 7


def _inputs(seed, b=2, hw=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hw, hw, 4)).astype(np.float32),
            np.array([5, 640], np.int32)[:b],
            rng.standard_normal((b, 9, 32)).astype(np.float32))


def _jax_lora_params(alpha, seed=3):
    """JAX's tiny adapter UNet with its own init, B then redrawn (a fresh
    B is zero, which would hide the branch)."""
    junet = jax_tiny(lora_rank=RANK, lora_alpha=alpha).unet
    sample, t, ctx = _inputs(seed)
    params = junet.init(jax.random.key(seed), jnp.asarray(sample),
                        jnp.asarray(t), jnp.asarray(ctx))
    flat = traverse_util.flatten_dict(jax.tree.map(np.array, params))
    rng = np.random.default_rng(seed)
    for k, v in flat.items():
        if k[-2].endswith("_lora_b"):
            flat[k] = rng.normal(0.0, 0.05, v.shape).astype(np.float32)
    return junet, traverse_util.unflatten_dict(flat)


def _port_unet(junet):
    cfg = UNetConfig(**{f: getattr(junet.config, f)
                        for f in UNetConfig.__dataclass_fields__})
    return UNet2DCondition(cfg)


def _run(unet, sample, t, ctx):
    with torch.no_grad():
        return unet(torch.from_numpy(sample).permute(0, 3, 1, 2),
                    torch.from_numpy(t), torch.from_numpy(ctx)
                    ).permute(0, 2, 3, 1).numpy()


def test_fresh_adapter_is_the_base_model():
    """`init_like_flax_` draws A ~ N(0, 0.02) and B = 0 (flax's
    kernel_init): a fresh adapter's output equals the rank-0 UNet's with
    the same base weights, bit for bit."""
    base = stable_diffusion_tiny(device="cpu", precomputed_latents=True)
    model = stable_diffusion_tiny(device="cpu", precomputed_latents=True,
                                  lora_rank=RANK)
    lora = tlora.lora_parameters(model.unet)
    # 4 transformers (down, mid, two up), 2 attentions (self, cross) each,
    # 4 projections each, A and B
    assert len(lora) == 4 * 2 * 4 * 2
    for name, p in lora.items():
        if name.endswith("_lora_b.weight"):
            assert torch.count_nonzero(p) == 0, name
        else:
            assert p.shape[0] == RANK and 0.01 < float(p.detach().std()) < 0.03, name
    assert all(isinstance(m, LoRALinear) and m.bias is None
               for n, m in model.unet.named_modules() if "_lora_" in n)
    missing, unexpected = model.unet.load_state_dict(
        base.unet.state_dict(), strict=False)
    assert sorted(missing) == sorted(lora) and not unexpected
    sample, t, ctx = _inputs(1)
    np.testing.assert_array_equal(_run(model.unet, sample, t, ctx),
                                  _run(base.unet, sample, t, ctx))


@pytest.mark.parametrize("alpha", [None, 8.0])
def test_lora_unet_matches_jax(monkeypatch, alpha):
    monkeypatch.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "0")
    junet, params = _jax_lora_params(alpha)
    sample, t, ctx = _inputs(5)
    want = np.asarray(junet.apply(params, jnp.asarray(sample),
                                  jnp.asarray(t), jnp.asarray(ctx)))
    unet = _port_unet(junet)
    state = unet_from_jax(params)
    assert sum(tlora.is_lora_key(k) for k in state) == 64
    unet.load_state_dict(state)           # strict: every adapter mapped
    for name in tlora.lora_parameters(unet):
        assert lora_jax_path(name).split("/") in [
            list(k) for k in traverse_util.flatten_dict(params["params"])]
    got = _run(unet, sample, t, ctx)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the branches matter: the base alone is far from that
    base = _port_unet(jax_tiny().unet)
    base.load_state_dict({k: v for k, v in state.items()
                          if not tlora.is_lora_key(k)})
    assert np.abs(_run(base, sample, t, ctx) - want).max() > 1e-3


def test_fold_matches_jax_and_the_adapter_unet(monkeypatch):
    monkeypatch.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "0")
    junet, params = _jax_lora_params(8.0)
    want = unet_from_jax(jlora.fold_lora(params["params"],
                                         config=junet.config))
    unet = _port_unet(junet)
    unet.load_state_dict(unet_from_jax(params))
    folded = tlora.fold_lora(unet, config=unet.config)
    assert sorted(folded) == sorted(want)
    assert not any(tlora.is_lora_key(k) for k in folded)
    for k, w in want.items():
        np.testing.assert_array_max_ulp(folded[k].numpy(), w.numpy(),
                                        maxulp=1)
    # the folded rank-0 UNet serves what the adapter UNet serves
    plain = UNet2DCondition(UNetConfig(**{
        f: getattr(unet.config, f) for f in UNetConfig.__dataclass_fields__
        if f not in ("lora_rank", "lora_alpha")}))
    plain.load_state_dict(folded)
    sample, t, ctx = _inputs(6)
    with_adapter = _run(unet, sample, t, ctx)
    assert np.abs(with_adapter - _run(_port_unet(junet), sample, t,
                                      ctx)).max() > 1e-3
    np.testing.assert_allclose(_run(plain, sample, t, ctx), with_adapter,
                               atol=1e-5, rtol=0)
    # a state_dict folds as the module does
    for k, v in tlora.fold_lora(unet.state_dict(), alpha=8.0).items():
        assert torch.equal(v, folded[k]), k


def test_refusals_match_jax():
    junet, params = _jax_lora_params(8.0)
    unet = _port_unet(junet)
    unet.load_state_dict(unet_from_jax(params))
    with pytest.raises(ValueError, match="conflicts"):
        jlora.fold_lora(params["params"], alpha=4.0, config=junet.config)
    with pytest.raises(ValueError, match="conflicts"):
        tlora.fold_lora(unet, alpha=4.0, config=unet.config)
    # an adapter without its B factor
    flat = traverse_util.flatten_dict(params["params"])
    b_key = next(k for k in flat if k[-2] == "to_q_lora_b")
    del flat[b_key]
    with pytest.raises(ValueError, match="incomplete LoRA triplet"):
        jlora.fold_lora(traverse_util.unflatten_dict(flat))
    state = unet.state_dict()
    del state[next(k for k in state if k.endswith("to_q_lora_b.weight"))]
    with pytest.raises(ValueError, match="incomplete LoRA triplet"):
        tlora.fold_lora(state)
    # train_lora_only without adapters trains nothing: both refuse
    with pytest.raises(ValueError, match="no LoRA params"):
        jax_tiny(train_lora_only=True).init_params(jax.random.key(0),
                                                   image_size=64)
    with pytest.raises(ValueError, match="no LoRA params"):
        stable_diffusion_tiny(device="cpu", train_lora_only=True)
    assert tlora.is_lora_key("a.attn1.to_out_lora_b.weight")
    assert not tlora.is_lora_key("a.attn1.to_out.0.weight")


def test_builders_take_the_lora_keywords():
    full = stable_diffusion_tiny(device="cpu", lora_rank=RANK,
                                 train_lora_only=False)
    assert not full.train_lora_only
    assert all(p.requires_grad for p in full.unet.parameters())
    only = stable_diffusion_tiny(device="cpu", lora_rank=RANK,
                                 lora_alpha=2.0)
    assert only.train_lora_only and only.unet.config.lora_alpha == 2.0
    trainable = {n for n, p in only.unet.named_parameters()
                 if p.requires_grad}
    assert trainable == set(tlora.lora_parameters(only.unet))
    attn = only.unet.down_blocks[0].attentions[0].transformer_blocks[0].attn2
    assert attn.lora_scale == 0.5
    assert tuple(attn.to_k_lora_a.weight.shape) == (RANK, 32)   # context
    assert tuple(attn.to_out_lora_b.weight.shape) == (32, RANK)


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_adapter_gradient_matches_jax(monkeypatch, prediction_type):
    """The loss and every adapter's gradient of the adapter-only model
    (B redrawn, so A gets gradient too) against `jax.grad` of JAX's
    `loss_fn` over its trainable (adapter) tree, on JAX's XLA GroupNorm
    path (ROADMAP.md queue 3, fault 1), with JAX's draws handed over; the
    base gets no gradient."""
    monkeypatch.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "0")
    jsd = jax_tiny(precomputed_latents=True, lora_rank=RANK, lora_alpha=8.0,
                   prediction_type=prediction_type)
    params, frozen = jsd.init_params(jax.random.key(0), image_size=64)
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: rng.normal(0.0, 0.05, a.shape).astype(np.float32), params)
    batch = _batches()[0]
    key = jax.random.key(4)
    want_loss, want_grads = jax.value_and_grad(jsd.loss_fn)(
        params, frozen, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    _, r_t, r_noise = jax.random.split(key, 3)
    t = jax.random.randint(r_t, (4,), 0, 1000)
    noise = jax.random.normal(r_noise, (4, 8, 8, 4), jnp.float32)

    model = stable_diffusion_tiny(device="cpu", precomputed_latents=True,
                                  lora_rank=RANK, lora_alpha=8.0,
                                  prediction_type=prediction_type)
    model.unet.load_state_dict({**unet_from_jax(frozen["unet_base"]),
                                **unet_from_jax(params)})
    loss = model.loss_fn({k: torch.from_numpy(v) for k, v in batch.items()},
                         noise=torch.from_numpy(np.array(noise)),
                         timesteps=torch.from_numpy(np.array(t)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = unet_from_jax(want_grads)
    got = {n: p.grad for n, p in model.unet.named_parameters()
           if p.grad is not None}
    assert sorted(got) == sorted(want) == sorted(
        tlora.lora_parameters(model.unet))
    # tests/test_torch_train_step.py's gradient tolerance
    scale = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                   atol=1e-5 * scale, rtol=1e-3,
                                   err_msg=name)


class _JaxSteps(JaxCallback):
    def __init__(self):
        self.steps = []

    def batch_end(self, state, logger):
        self.steps.append((
            {k: float(np.asarray(v)) for k, v in state.metrics.items()},
            unet_from_jax(jax.tree.map(np.array, state.train_state.params))))


class _Steps(Callback):
    def __init__(self):
        self.steps = []

    def batch_end(self, state, logger):
        self.steps.append((
            {k: float(v) for k, v in state.metrics.items()},
            {n: p.detach().clone()
             for n, p in state.train_state.params.items()}))


def _batches():
    rng = np.random.default_rng(0)
    return [{"image_latents": rng.standard_normal((4, 8, 8, 4)).astype(
                np.float32),
             "caption_latents": rng.standard_normal((4, 8, 32)).astype(
                 np.float32)} for _ in range(2)]


def _jax_draws(step, micro, n_accum, mb):
    rng = jax.random.split(jax.random.fold_in(jax.random.key(SEED), step),
                           n_accum)[micro]
    _, r_t, r_noise = jax.random.split(rng, 3)
    shape = tuple(mb["image_latents"].shape)
    t = jax.random.randint(r_t, (shape[0],), 0, 1000)
    noise = jax.random.normal(r_noise, shape, jnp.float32)
    return torch.from_numpy(np.array(noise)), torch.from_numpy(np.array(t))


@pytest.fixture(scope="module")
def lora_runs():
    with pytest.MonkeyPatch.context() as mp:
        # JAX gradients on the XLA paths (ROADMAP.md queue 3, fault 1:
        # tests/test_lora.py's own training test fails on the Pallas path)
        mp.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "0")
        jrec = _JaxSteps()
        jtr = JaxTrainer(
            model=jax_tiny(precomputed_latents=True, lora_rank=RANK,
                           lora_alpha=8.0),
            train_dataloader=_batches(),
            optimizers=joptim.adamw(lr=1e-3, weight_decay=0.0),
            callbacks=[jrec], max_duration="2ba",
            device_train_microbatch_size=2, seed=SEED, image_size=64,
            mesh=create_mesh(fsdp=1, data=1, dcn=1,
                             devices=jax.devices()[:1]))
        adapter = unet_from_jax(jax.tree.map(np.array,
                                             jtr.train_state.params))
        base = unet_from_jax(jax.tree.map(np.array,
                                          jtr.frozen["unet_base"]))
        jtr.fit()

    model = stable_diffusion_tiny(device="cpu", precomputed_latents=True,
                                  lora_rank=RANK, lora_alpha=8.0)
    model.unet.load_state_dict({**base, **adapter})
    rec = _Steps()
    tr = Trainer(model=model, train_dataloader=_batches(),
                 optimizers=toptim.adamw(lr=1e-3, weight_decay=0.0),
                 callbacks=[rec], max_duration="2ba",
                 device_train_microbatch_size=2, seed=SEED, device="cpu",
                 noise_hook=_jax_draws)
    tr.fit()
    return jrec.steps, rec.steps, base, adapter, tr


def test_adapter_steps_match_jax(lora_runs):
    want, got, _, adapter, tr = lora_runs
    assert len(got) == len(want) == 2
    assert sorted(tr.train_state.params) == sorted(adapter) == sorted(
        tlora.lora_parameters(tr.model.unet))
    assert len(tr.train_state.optimizer.mu) == len(adapter) == 64
    for i, ((gm, gp), (wm, wp)) in enumerate(zip(got, want)):
        for k in ("loss/train/total", "grad/global_norm"):
            assert gm[k] == pytest.approx(wm[k], rel=1e-5), (i, k)
        assert sorted(gp) == sorted(wp)
        for name, wv in wp.items():
            np.testing.assert_allclose(gp[name].numpy(), wv.numpy(),
                                       atol=1e-6, rtol=1e-5,
                                       err_msg=f"step {i} {name}")
    # the adapters learned: B left zero, A moved at step 2
    last = got[-1][1]
    assert all(torch.count_nonzero(v) > 0 for k, v in last.items())
    assert any(not torch.equal(last[k], adapter[k]) for k in adapter
               if k.endswith("_lora_a.weight"))


def test_adapter_training_leaves_the_base_bit_unchanged(lora_runs):
    *_, base, _, tr = lora_runs
    live = {n: p for n, p in tr.model.unet.named_parameters()
            if not tlora.is_lora_key(n)}
    assert sorted(live) == sorted(base)
    for n, p in live.items():
        assert not p.requires_grad and p.grad is None, n
        assert torch.equal(p.detach(), base[n]), n


@pytest.fixture(scope="module")
def pretrained_dir(tmp_path_factory):
    """A tiny diffusers directory (rank 0) from the port's own modules,
    written by the port's safetensors writer."""
    root = tmp_path_factory.mktemp("lora_pretrained")
    source = stable_diffusion_tiny(device="cpu", seed=4)
    with torch.no_grad():            # norms and biases off their init
        gen = torch.Generator().manual_seed(4)
        for part in ("unet", "vae", "text_encoder"):
            for p in getattr(source, part).parameters():
                p.add_(torch.randn(p.shape, generator=gen) * 0.05)
    for name, fname in (("unet", "diffusion_pytorch_model.safetensors"),
                        ("vae", "diffusion_pytorch_model.safetensors"),
                        ("text_encoder", "model.safetensors")):
        os.makedirs(root / name)
        tsafe.save_file(getattr(source, name).state_dict(),
                        str(root / name / fname))
    return str(root), source


def test_pretrained_base_and_fresh_adapter_match_jax(pretrained_dir):
    path, source = pretrained_dir
    jmodel = jax_tiny(pretrained=True, model_name=path, lora_rank=RANK)
    jparams, jfrozen = jload(jmodel, image_size=64)
    model = stable_diffusion_tiny(device="cpu", pretrained=True,
                                  model_name=path, lora_rank=RANK)
    want_adapter = unet_from_jax(jparams)
    got = model.unet.state_dict()
    assert sorted(want_adapter) == sorted(tlora.lora_parameters(model.unet))
    for k, v in want_adapter.items():
        assert torch.equal(got[k], v), k
    for k, v in unet_from_jax(jfrozen["unet_base"]).items():
        assert torch.equal(got[k], v), k
        assert torch.equal(got[k], source.unet.state_dict()[k]), k
    # step 0 is the pretrained model exactly
    sample, t, ctx = _inputs(2)
    np.testing.assert_array_equal(_run(model.unet, sample, t, ctx),
                                  _run(source.unet, sample, t, ctx))


def test_endpoint_serves_an_adapter_checkpoint(pretrained_dir, tmp_path):
    """The endpoint (`lora_rank`, `train_lora_only`, the pretrained
    directory) loads an adapter-only checkpoint into the adapters, as JAX's
    partial restore of the trainable tree does, and generates what JAX's
    model generates from the same base, adapter and draws."""
    path, _ = pretrained_dir
    jmodel = jax_tiny(pretrained=True, model_name=path, lora_rank=RANK)
    jparams, jfrozen = jload(jmodel, image_size=64)
    rng = np.random.default_rng(9)
    trained = jax.tree.map(
        lambda a: rng.normal(0.0, 0.05, a.shape).astype(np.float32), jparams)
    ckpt_dir = tmp_path / "adapter"
    os.makedirs(ckpt_dir)
    tsafe.save_file(unet_from_jax(trained),
                    str(ckpt_dir / "params.safetensors"))
    endpoint = StableDiffusionInference(
        builder=stable_diffusion_tiny, model_name=path, pretrained=True,
        checkpoint_path=str(ckpt_dir), lora_rank=RANK, train_lora_only=True,
        default_size=32, device="cpu")
    state = endpoint.model.unet.state_dict()
    for k, v in unet_from_jax(trained).items():
        assert torch.equal(state[k], v), k
    for k, v in unet_from_jax(jfrozen["unet_base"]).items():
        assert torch.equal(state[k], v), k
    ids = jmodel.tokenizer(["a red cube"])["input_ids"]
    want = jmodel.generate(trained, jfrozen, jnp.asarray(ids), height=32,
                           width=32, num_inference_steps=2, seed=3)
    # JAX's initial noise, as its generate draws it from the seed
    latents = np.array(jax.random.normal(jax.random.key(3), (1, 4, 4, 4),
                                         jnp.float32))
    got = endpoint.model.generate(torch.from_numpy(ids), height=32,
                                  width=32, num_inference_steps=2,
                                  latents=torch.from_numpy(latents))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=0)
    # the parent's load into every UNet parameter finds no base key there
    from diffusion_torch.train.checkpoint import load_params
    with pytest.raises(ValueError, match="missing"):
        load_params(str(ckpt_dir), dict(endpoint.model.unet.named_parameters()))
