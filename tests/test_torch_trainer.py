"""The port's Trainer against the JAX Trainer, side by side on the tiny
model and the same fixed latent batches: grad accumulation (global batch 4,
microbatch 2), AdamW with a warmup/milestone schedule and global-norm
clipping, EMA (smoothing 0.9 from batch 0), and a non-finite batch that
both skip without advancing the LR schedule's count. The port is handed
JAX's per-step, per-microbatch draws through its `noise_hook`. Also the
port's AdamW and schedules against optax and the JAX schedules."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffusion_tpu.algorithms.ema import EMA as JaxEMA
from diffusion_tpu.models.models import stable_diffusion_tiny as jax_tiny
from diffusion_tpu.parallel.mesh import create_mesh
from diffusion_tpu.train import optim as joptim
from diffusion_tpu.train.events import Callback as JaxCallback
from diffusion_tpu.train.trainer import Trainer as JaxTrainer
from diffusion_torch.algorithms.ema import EMA
from diffusion_torch.models.models import stable_diffusion_tiny
from diffusion_torch.models.port_jax import unet_from_jax
from diffusion_torch.train import optim as toptim
from diffusion_torch.train.events import Callback
from diffusion_torch.train.trainer import Trainer, grad_accum_steps

torch.set_num_threads(1)

SEED = 7
LR = 1e-3
CLIP = 3.0
NAN_BATCH = 2


def _batches():
    rng = np.random.default_rng(0)
    out = []
    for i in range(4):
        lat = rng.standard_normal((4, 8, 8, 4)).astype(np.float32)
        if i == NAN_BATCH:
            lat[1, 2, 3, 0] = np.nan
        out.append({"image_latents": lat,
                    "caption_latents": rng.standard_normal(
                        (4, 8, 32)).astype(np.float32)})
    return out


def _schedule(mod):
    # warmup over 2 batches, x0.5 from count 3: the skipped step must leave
    # the last update at count 2 (no decay) on both sides
    return mod.multi_step_with_warmup(t_warmup="2ba", milestones=["3ba"],
                                      gamma=0.5)


class _JaxRecorder(JaxCallback):
    def __init__(self):
        self.steps = []

    def batch_end(self, state, logger):
        ts = state.train_state
        self.steps.append({
            "metrics": {k: float(np.asarray(v))
                        for k, v in state.metrics.items()},
            "lr": state.lr,
            "params": unet_from_jax(jax.tree.map(np.array, ts.params)),
            "ema": unet_from_jax(jax.tree.map(np.array, ts.ema_params))})


class _Recorder(Callback):
    def __init__(self):
        self.steps = []

    def batch_end(self, state, logger):
        ts = state.train_state
        self.steps.append({
            "metrics": {k: float(v) for k, v in state.metrics.items()},
            "lr": state.lr,
            "params": {n: p.detach().clone() for n, p in ts.params.items()},
            "ema": {n: e.clone() for n, e in ts.ema_params.items()}})


def _jax_draws(step, micro, n_accum, mb):
    """The JAX train step's draws for (step, microbatch): fold_in the step,
    split per microbatch, then the split inside `forward`."""
    rng = jax.random.split(jax.random.fold_in(jax.random.key(SEED), step),
                           n_accum)[micro]
    _, r_t, r_noise = jax.random.split(rng, 3)
    shape = tuple(mb["image_latents"].shape)
    t = jax.random.randint(r_t, (shape[0],), 0, 1000)
    noise = jax.random.normal(r_noise, shape, jnp.float32)
    return torch.from_numpy(np.array(noise)), torch.from_numpy(np.array(t))


@pytest.fixture(scope="module")
def runs():
    with pytest.MonkeyPatch.context() as mp:
        # JAX gradients on the XLA paths (ROADMAP.md queue 3, fault 1)
        mp.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "0")
        jrec = _JaxRecorder()
        jtr = JaxTrainer(
            model=jax_tiny(precomputed_latents=True),
            train_dataloader=_batches(),
            optimizers=joptim.adamw(lr=LR, weight_decay=0.01),
            schedulers=_schedule(joptim),
            algorithms=[JaxEMA(smoothing=0.9, ema_start="0ba")],
            callbacks=[jrec], max_duration="4ba",
            device_train_microbatch_size=2, seed=SEED, image_size=64,
            grad_clip_norm=CLIP, skip_nonfinite_updates=True,
            mesh=create_mesh(fsdp=1, data=1, dcn=1,
                             devices=jax.devices()[:1]))
        initial = unet_from_jax(jax.tree.map(np.array,
                                             jtr.train_state.params))
        jtr.fit()

    model = stable_diffusion_tiny(device="cpu", precomputed_latents=True)
    model.unet.load_state_dict(initial)
    rec = _Recorder()
    tr = Trainer(model=model, train_dataloader=_batches(),
                 optimizers=toptim.adamw(lr=LR, weight_decay=0.01),
                 schedulers=_schedule(toptim),
                 algorithms=[EMA(smoothing=0.9, ema_start="0ba")],
                 callbacks=[rec], max_duration="4ba",
                 device_train_microbatch_size=2, seed=SEED,
                 grad_clip_norm=CLIP, skip_nonfinite_updates=True,
                 device="cpu", noise_hook=_jax_draws)
    tr.fit()
    return jrec.steps, rec.steps, initial, tr


def test_metrics_match_jax_each_step(runs):
    want, got, _, _ = runs
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g["metrics"]) == sorted(w["metrics"]) == [
            "grad/global_norm", "loss/train/total",
            "trainer/nonfinite_skipped"]
        assert g["metrics"]["trainer/nonfinite_skipped"] == \
            w["metrics"]["trainer/nonfinite_skipped"] == float(i == NAN_BATCH)
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-6)
        if i == NAN_BATCH:
            assert np.isnan(g["metrics"]["loss/train/total"])
            continue
        # fp32 both ways: the tiny UNet's forward and VJP in another order
        for k in ("loss/train/total", "grad/global_norm"):
            assert g["metrics"][k] == pytest.approx(w["metrics"][k],
                                                    rel=1e-5), (i, k)
    # the clip threshold splits the steps: both branches of the clip ran
    norms = [w["metrics"]["grad/global_norm"] for i, w in enumerate(want)
             if i != NAN_BATCH]
    assert min(norms) < CLIP < max(norms)


def test_params_and_ema_match_jax_each_step(runs):
    want, got, initial, _ = runs
    for i, (g, w) in enumerate(zip(got, want)):
        for key in ("params", "ema"):
            assert sorted(g[key]) == sorted(w[key])
            for name, wv in w[key].items():
                # fp32 both ways; an Adam update is ~lr per element whatever
                # the gradient's size, so gradients that agree to ~1e-5
                # relative give updates that agree to ~1e-5 * lr
                np.testing.assert_allclose(g[key][name].numpy(), wv.numpy(),
                                           atol=1e-6, rtol=1e-5,
                                           err_msg=f"step {i} {key} {name}")
    # step 0 ran at LR 0 (warmup): params unchanged; later steps moved them
    for name, p in initial.items():
        assert torch.equal(got[0]["params"][name], p)
    moved = sum(not torch.equal(got[-1]["params"][n], p)
                for n, p in initial.items())
    assert moved == len(initial)
    # the skipped step changed neither params nor EMA
    for key in ("params", "ema"):
        for name in initial:
            assert torch.equal(got[NAN_BATCH][key][name],
                               got[NAN_BATCH - 1][key][name])


def test_skip_holds_the_schedule_count(runs):
    _, _, _, tr = runs
    assert tr.train_state.step == 4
    assert tr.train_state.optimizer.count == 3      # one update skipped
    assert tr.state.timestamp.batch == 4 and tr.state.timestamp.sample == 16


def test_trainer_refuses_what_is_not_ported():
    """Every mesh axis is ported: a mesh of one process's axes trains as
    one rank, and axes that need more processes, tensor parallelism's
    too, raise JAX's ValueError."""
    model = stable_diffusion_tiny(device="cpu", precomputed_latents=True)
    with pytest.raises(ValueError) as want:
        create_mesh(tp=2, devices=jax.devices()[:1])
    with pytest.raises(ValueError, match=str(want.value)):
        Trainer(model=model, device="cpu", mesh_config={"tp": 2})
    tr = Trainer(model=model, device="cpu",
                 mesh_config={"fsdp": -1, "data": 1, "sp": 1})
    assert tr.mesh is None and not tr.train_state.shards
    tr.close()
    with pytest.raises(ValueError, match="does not cover 1 devices"):
        Trainer(model=model, device="cpu", mesh_config={"fsdp": 1, "sp": 2})


def test_trainer_defaults_to_cuda(monkeypatch):
    model = stable_diffusion_tiny(device="cpu", precomputed_latents=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Trainer(model=model)


@pytest.mark.parametrize("global_batch,micro", [(4, 2), (32, 16), (6, 4),
                                                (7, 2), (5, 8)])
def test_grad_accum_steps_match_jax(global_batch, micro):
    from diffusion_tpu.train.trainer import grad_accum_steps as jax_steps
    assert grad_accum_steps(global_batch, micro) == jax_steps(global_batch,
                                                              micro)


# ------------------------------------------------------------ optax parity


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
def test_adamw_matches_optax(mu_dtype):
    """Five updates of clip + adamw with a warmup schedule: the port's
    AdamW against optax's chain on a few tensors, gradients large and small
    so clipping both triggers and does not."""
    rng = np.random.default_rng(1)
    shapes = [(3, 4), (5,), (2, 3, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * scale
              for s in shapes] for scale in (3.0, 0.01, 1.0, 0.2, 5.0)]
    sched = joptim.constant_with_warmup(t_warmup="2ba")
    tx = joptim.build_optimizer(joptim.adamw(lr=0.1, mu_dtype=mu_dtype),
                                sched, grad_clip_norm=1.0)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = toptim.build_optimizer(
        tp, toptim.adamw(lr=0.1, mu_dtype=mu_dtype),
        toptim.constant_with_warmup(t_warmup="2ba"), grad_clip_norm=1.0)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        opt.step()
        # fp32 (a bf16 first moment rounds alike on both sides); each
        # update is ~lr = 0.1 per element, computed in another order
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       atol=1e-5, rtol=1e-5)
    assert opt.count == 5
    assert all(m.dtype == (torch.bfloat16 if mu_dtype else torch.float32)
               for m in opt.mu)


@pytest.mark.parametrize("name,kwargs", [
    ("multi_step_with_warmup", dict(t_warmup="10ba", milestones=["20ba",
                                                                 "30ba"])),
    ("multi_step_with_warmup", dict(t_warmup="10000ba", milestones=["200ep"])),
    ("linear_with_warmup", dict(t_warmup="5ba", t_max="40ba")),
    ("cosine_annealing_with_warmup", dict(t_warmup="5ba", alpha_f=0.1,
                                          t_max="40ba")),
    ("constant_with_warmup", dict(t_warmup="7ba")),
    ("constant_scheduler", dict())])
def test_schedules_match_jax(name, kwargs):
    want = getattr(joptim, name)(**kwargs)
    got = getattr(toptim, name)(**kwargs)
    for step in (0, 1, 4, 5, 9, 10, 19, 20, 25, 30, 39, 40, 50, 20000):
        assert float(got(step)) == float(np.asarray(want(step))), step
