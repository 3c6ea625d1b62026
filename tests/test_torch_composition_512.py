"""The recipe's phase 2, `yamls/SD-2-base-512.yaml`, warm-started from a
phase-1 (`yamls/SD-2-base-256.yaml`) checkpoint, composed by the JAX
package's `build_trainer` and by the port's `train(config)` side by side:
tiny geometry on the CPU, the unedited yamls with the same dotted
overrides on both sides.

Phase 1: 2 batches of 4 (microbatches of 2) on precomputed `latents_256`,
saved at `ba2` by each side's own Trainer, the port starting from JAX's
initial UNet weights with JAX's draws (`noise_hook`). Phase 2: the 512
yaml with `trainer.load_path` = that side's `ba2` (`load_weights_only:
true` in the yaml), `latents_512` (64x64 latents, the top stage's 4096
tokens), 3 batches of 4 in microbatches of 2, and one COCO eval at 512px
after batch 2 (raw JPEGs: `+model.init_frozen_towers=true`, reference
fault 9; the port holds JAX's tiny VAE and CLIP). The warm start takes the
saved weights on both sides, re-seeds the EMA from them, and starts the
optimizer and the clock afresh; losses, grad norms and the eval MSE match
JAX's at rel 1e-5, the weights at atol 1e-6 / rtol 1e-5. With `ema_start:
800000ba` the EMA copies the weights at every step. Data are written
under tmp_path from numpy seeds."""

import dataclasses
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffusion_tpu.config import load_config as jax_load_config
from diffusion_tpu.models import models as jmodels
from diffusion_tpu.parallel import mesh as jmesh
from diffusion_tpu.train import trainer as jtrainer
from diffusion_tpu.train.events import Callback as JaxCallback
from diffusion_tpu.train.train import build_trainer as jax_build_trainer
from diffusion_tpu.utils.logging import Logger as JaxLogger
from diffusion_torch.config import load_config
from diffusion_torch.data.mds import MDSWriter
from diffusion_torch.models.port_jax import (clip_text_from_jax,
                                             unet_from_jax, vae_from_jax)
from diffusion_torch.train import checkpoint as ckpt
from diffusion_torch.train import train as ttrain
from diffusion_torch.train.events import Callback
from diffusion_torch.utils import safetensors
from diffusion_torch.utils.logging import Logger

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
SEED = 17                        # both yamls' seed
N_TRAIN, N_COCO = 12, 8
TOL = dict(atol=1e-6, rtol=1e-5)
_BUILD_TRAINER = ttrain.build_trainer


def _yaml(name):
    return os.path.join(ROOT, "yamls", name)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("comp512")
    rng = np.random.default_rng(5)
    with MDSWriter(str(root / "laion"), {
            "jpg": "bytes", "caption": "str", "caption_latents": "bytes",
            "latents_256": "bytes", "latents_512": "bytes"},
            size_limit=1 << 17) as w:
        for i in range(N_TRAIN):
            w.write({"jpg": b"", "caption": f"c{i}",
                     "caption_latents": rng.standard_normal(
                         (77, 32)).astype(np.float16).tobytes(),
                     "latents_256": rng.standard_normal(
                         (4, 32, 32)).astype(np.float16).tobytes(),
                     "latents_512": rng.standard_normal(
                         (4, 64, 64)).astype(np.float16).tobytes()})
    with MDSWriter(str(root / "coco"), {"image": "bytes",
                                        "captions": "json"}) as w:
        for i in range(N_COCO):
            buf = io.BytesIO()
            Image.fromarray(rng.integers(0, 255, (48, 56 + 8 * (i % 2), 3),
                                         np.uint8)).save(buf, format="JPEG")
            w.write({"image": buf.getvalue(),
                     "captions": [f"a photo number {i}", f"other {i}"]})
    return {"laion": str(root / "laion"), "coco": str(root / "coco"),
            "root": root}


def _common(data):
    return ["model._target_="
            "diffusion_tpu.models.models.stable_diffusion_tiny",
            "+model.device=cpu", "+trainer.device=cpu", "~logger",
            "batch_size=4", "trainer.device_train_microbatch_size=2",
            f"dataset.train_dataset.remote={data['laion']}",
            f"dataset.train_dataset.local={data['laion']}",
            "dataset.train_dataset.num_workers=0",
            "+dataset.train_dataset.caption_latent_dim=32",
            "~callbacks.memory_monitor"]


def _phase1(data, side):
    return _common(data) + [
        "~dataset.eval_dataset", "trainer.max_duration=2ba",
        f"trainer.save_folder={data['root'] / side}",
        "trainer.save_interval=2ba"]


def _phase2(data, side):
    return _common(data) + [
        f"trainer.load_path={data['root'] / side / 'ba2'}",
        "+model.init_frozen_towers=true",
        "trainer.max_duration=3ba", "trainer.eval_interval=2ba",
        f"dataset.eval_dataset.remote={data['coco']}",
        f"dataset.eval_dataset.local={data['coco']}",
        "dataset.eval_dataset.num_workers=0", "dataset.eval_batch_size=8",
        "+trainer.eval_subset_num_batches=1"]


def _latent_draws(rng, shape):
    _, r_t, r_noise = jax.random.split(rng, 3)
    t = jax.random.randint(r_t, (shape[0],), 0, 1000)
    noise = jax.random.normal(r_noise, shape, jnp.float32)
    return torch.from_numpy(np.array(noise)), torch.from_numpy(np.array(t))


def _train_draws(step, micro, n_accum, mb):
    rng = jax.random.split(jax.random.fold_in(jax.random.key(SEED), step),
                           n_accum)[micro]
    return _latent_draws(rng, tuple(mb["image_latents"].shape))


def _eval_draws(index, batch):
    """JAX's raw-image eval draws: eps, timesteps, noise."""
    shape = tuple(batch["image"].shape)
    r_enc, r_t, r_noise = jax.random.split(
        jax.random.fold_in(jax.random.key(1138), index), 3)
    lat = (shape[0], shape[1] // 8, shape[2] // 8, 4)
    eps = jax.random.normal(r_enc, lat, jnp.float32)
    t = jax.random.randint(r_t, (shape[0],), 0, 1000)
    noise = jax.random.normal(r_noise, lat, jnp.float32)
    return tuple(torch.from_numpy(np.array(a)) for a in (noise, t, eps))


class _JaxSteps(JaxCallback):
    def __init__(self):
        self.steps = []

    def batch_end(self, state, logger):
        ts = state.train_state
        self.steps.append((
            {k: float(np.asarray(v)) for k, v in state.metrics.items()},
            unet_from_jax(jax.tree.map(np.array, ts.params)),
            unet_from_jax(jax.tree.map(np.array, ts.ema_params))
            if ts.ema_params is not None else None))


class _Steps(Callback):
    def __init__(self):
        self.steps = []

    def batch_end(self, state, logger):
        ts = state.train_state
        self.steps.append((
            {k: float(v) for k, v in state.metrics.items()},
            {n: p.detach().clone() for n, p in ts.params.items()},
            {n: e.clone() for n, e in ts.ema_params.items()}
            if ts.ema_params is not None else None))


def _evals(base):
    class Evals(base):
        def __init__(self):
            self.evals = []

        def log_metrics(self, metrics, step=None):
            if any(k.startswith("metrics/") for k in metrics):
                self.evals.append((step, dict(metrics)))
    return Evals()


def _jax_run(config):
    jtr = jax_build_trainer(config)
    start = {"params": unet_from_jax(jax.tree.map(
        np.array, jtr.train_state.params)),
        "frozen": jax.tree.map(np.array, jtr.frozen),
        "step": int(np.asarray(jtr.train_state.step)),
        "batch": jtr.state.timestamp.batch}
    if jtr.train_state.ema_params is not None:
        start["ema"] = unet_from_jax(jax.tree.map(
            np.array, jtr.train_state.ema_params))
    steps, evals = _JaxSteps(), _evals(JaxLogger)
    jtr.engine.callbacks.append(steps)
    jtr.logger.loggers.append(evals)
    try:
        jtr.fit()
    finally:
        jtr.close()
    return start, steps.steps, evals.evals


def _port_run(config, jax_start, monkeypatch):
    steps, evals, built = _Steps(), _evals(Logger), []

    def build(cfg):
        tr = _BUILD_TRAINER(cfg)
        ts = tr.train_state
        built.append({
            "params": {n: p.detach().clone() for n, p in ts.params.items()},
            "ema": ({n: e.clone() for n, e in ts.ema_params.items()}
                    if ts.ema_params is not None else None),
            "step": ts.step, "batch": tr.state.timestamp.batch,
            "count": ts.optimizer.count,
            "moments_zero": all(not m.any() for m in
                                ts.optimizer.mu + ts.optimizer.nu),
            "trainer": tr})
        if not cfg["trainer"].get("load_path"):
            # phase 1 starts from JAX's initial weights
            tr.model.unet.load_state_dict(jax_start["params"])
        frozen = jax_start["frozen"]
        if tr.model.vae is not None:
            tr.model.vae.load_state_dict(vae_from_jax(frozen["vae"]))
            tr.model.text_encoder.load_state_dict(
                clip_text_from_jax(frozen["text_encoder"]))
        tr.noise_hook, tr.eval_noise_hook = _train_draws, _eval_draws
        tr.engine.callbacks.append(steps)
        tr.logger.loggers.append(evals)
        return tr

    monkeypatch.setattr(ttrain, "build_trainer", build)
    tr = ttrain.train(config)
    assert built[0]["trainer"] is tr
    return built[0], steps.steps, evals.evals, tr


@pytest.fixture(scope="module")
def runs(data):
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        # JAX gradients on the XLA paths (ROADMAP.md queue 3, fault 1), on
        # one device
        mp.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "0")
        mp.setenv("WANDB_MODE", "disabled")
        mp.setattr(jtrainer, "create_mesh", lambda **_: jmesh.create_mesh(
            fsdp=1, data=1, dcn=1, devices=jax.devices()[:1]))
        # JAX's tiny builder drops `init_frozen_towers`, which its
        # full-width builder (the yaml's) takes: hand it to the model
        tiny = jmodels.stable_diffusion_tiny
        mp.setattr(jmodels, "stable_diffusion_tiny",
                   lambda init_frozen_towers=None, **kw: dataclasses.replace(
                       tiny(**kw), init_frozen_towers=init_frozen_towers))
        for phase, yaml, overrides in (
                (1, "SD-2-base-256.yaml", _phase1),
                (2, "SD-2-base-512.yaml", _phase2)):
            path = _yaml(yaml)
            jstart, jsteps, jevals = _jax_run(jax_load_config(
                path, overrides(data, "jax")))
            start, steps, evals, tr = _port_run(
                load_config(path, overrides(data, "port")), jstart, mp)
            out[phase] = {"jax": (jstart, jsteps, jevals),
                          "port": (start, steps, evals), "trainer": tr}
    return out


def _assert_steps_match(got, want, phase):
    assert len(got) == len(want)
    for i, ((gm, gp, ge), (wm, wp, we)) in enumerate(zip(got, want)):
        for k in ("loss/train/total", "grad/global_norm"):
            assert np.isfinite(gm[k])
            assert gm[k] == pytest.approx(wm[k], rel=1e-5), (phase, i, k)
        for name, wv in wp.items():
            np.testing.assert_allclose(gp[name].numpy(), wv.numpy(), **TOL,
                                       err_msg=f"{phase} step {i} {name}")


def test_phase1_saves_a_matching_checkpoint(runs, data):
    _, jsteps, _ = runs[1]["jax"]
    _, steps, _ = runs[1]["port"]
    _assert_steps_match(steps, jsteps, 1)
    assert ckpt.latest_checkpoint_path(str(data["root"] / "port")) == str(
        data["root"] / "port" / "ba2")
    assert os.path.isdir(data["root"] / "jax" / "ba2")


def test_phase2_warm_starts_from_the_saved_weights(runs, data):
    """Weights-only: the saved params (both sides within TOL of each
    other), a fresh optimizer and clock, the EMA seeded from the loaded
    weights; the 512 yaml's geometry and EMA start reach the Trainer."""
    jstart, _, _ = runs[2]["jax"]
    start, _, _ = runs[2]["port"]
    tr = runs[2]["trainer"]
    saved = safetensors.load_file(str(
        data["root"] / "port" / "ba2" / "state" / "params.safetensors"))
    assert sorted(start["params"]) == sorted(saved)
    for name, p in start["params"].items():
        assert torch.equal(p, saved[name].to(p.dtype)), name
        assert torch.equal(start["ema"][name], p), name
        np.testing.assert_allclose(p.numpy(), jstart["params"][name].numpy(),
                                   **TOL, err_msg=name)
        assert torch.equal(jstart["ema"][name], jstart["params"][name])
    # phase 1 trained them: they are not the builder's fresh weights
    _, p1_steps, _ = runs[1]["port"]
    _, last, _ = p1_steps[-1]
    assert all(torch.equal(start["params"][n], last[n]) for n in last)
    assert start["count"] == 0 and start["moments_zero"]
    assert start["step"] == jstart["step"] == 0
    assert start["batch"] == jstart["batch"] == 0
    assert tr.ema_algorithm is not None
    assert tr.state.ema_start_batch == 800000
    assert tr.micro_size == 2 and tr.max_batches == 3
    assert type(tr.train_dataloader.dataset).__name__ == \
        "StreamingLAIONDataset"
    assert tr.train_dataloader.dataset.image_size == 512


def test_phase2_steps_and_eval_match_jax(runs):
    _, jsteps, jevals = runs[2]["jax"]
    _, steps, evals = runs[2]["port"]
    _assert_steps_match(steps, jsteps, 2)
    for i, (_, gp, ge) in enumerate(steps):
        # before ema_start the EMA copies the weights
        assert all(torch.equal(ge[n], gp[n]) for n in gp), i
    assert [s for s, _ in evals] == [s for s, _ in jevals] == [2]
    (_, g), (_, w) = evals[0], jevals[0]
    assert sorted(g) == sorted(w)
    assert "metrics/eval/MeanSquaredError" in g
    for k in w:
        assert np.isfinite(g[k])
        assert g[k] == pytest.approx(w[k], rel=1e-5), k
