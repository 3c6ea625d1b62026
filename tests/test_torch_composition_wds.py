"""An online-encode run composed from one yaml, shaped like
yamls/SD-2-base-256-wds.yaml (raw images from webdataset tar shards, a
metadata filter strategy, the frozen VAE and CLIP towers encoding every
batch), by the JAX package's `build_trainer` and by the port's
`train(config)`, side by side: tiny geometry, shards written under
tmp_path from a numpy seed, grad accumulation 2x2, `eval_first` and one
more eval at batch 2 of 4. The port starts from JAX's initial UNet and
towers and is handed JAX's draws (the posterior's eps, timesteps, noise)
through `noise_hook` and `eval_noise_hook`."""

import io
import json
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffusion_tpu.config import loads_config as jax_loads_config
from diffusion_tpu.parallel import mesh as jmesh
from diffusion_tpu.train import trainer as jtrainer
from diffusion_tpu.train.events import Callback as JaxCallback
from diffusion_tpu.train.train import build_trainer as jax_build_trainer
from diffusion_tpu.utils.logging import Logger as JaxLogger
from diffusion_torch.config import loads_config
from diffusion_torch.data.wds import build_wds_dataloader
from diffusion_torch.models.port_jax import (clip_text_from_jax,
                                             unet_from_jax, vae_from_jax)
from diffusion_torch.train import train as ttrain
from diffusion_torch.train.events import Callback
from diffusion_torch.text.tokenizer import tiny_tokenizer
from diffusion_torch.utils.logging import Logger

torch.set_num_threads(1)

SEED = 7
N_TRAIN, N_EVAL, UNSAFE = 24, 8, (3, 11, 19)   # flagged samples, dropped

YAML = """
batch_size: 4
seed: 7
name: wds-parity
eval_first: true
model:
  _target_: diffusion_tpu.models.models.stable_diffusion_tiny
  precomputed_latents: false
  val_guidance_scales: []
  device: cpu
dataset:
  train_batch_size: ${batch_size}
  eval_batch_size: 4
  train_dataset:
    _target_: diffusion_tpu.data.wds.build_wds_dataloader
    meta_json: {root}/train.json
    batch_size: ${batch_size}
    filter_strategy: {root}/filter.json
    caption_drop_prob: 0.0
    resize_size: 64
    shuffle: true
    drop_last: true
  eval_dataset:
    _target_: diffusion_tpu.data.wds.build_wds_dataloader
    meta_json: {root}/eval.json
    batch_size: 4
    resize_size: 64
    shuffle: true
optimizer:
  _target_: diffusion_tpu.train.optim.adamw
  lr: 1.0e-3
  weight_decay: 0.01
scheduler:
  name: multi_step_with_warmup
  t_warmup: 1ba
  milestones: [3ba]
  gamma: 0.5
trainer:
  max_duration: 4ba
  eval_interval: 2ba
  device_train_microbatch_size: 2
  image_size: 64
  seed: ${seed}
  device: cpu
"""


def _tar(path, start, n, rng):
    """Non-square JPEGs, .txt captions and .json metadata."""
    with tarfile.open(path, "w") as tf:
        for i in range(start, start + n):
            w, h = (80, 64) if i % 2 else (64, 96)
            buf = io.BytesIO()
            Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(
                buf, format="JPEG")
            meta = {"width": w, "height": h,
                    "punsafe": 0.9 if i in UNSAFE else 0.05}
            for ext, data in (("jpg", buf.getvalue()),
                              ("txt", f"photo number {i}".encode()),
                              ("json", json.dumps(meta).encode())):
                info = tarfile.TarInfo(f"{i:05d}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    return str(path)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_wds_comp")
    rng = np.random.default_rng(0)
    for split, n, per in (("train", N_TRAIN, 8), ("eval", N_EVAL, 8)):
        base = 0 if split == "train" else 1000
        shards = [_tar(root / f"{split}-{k}.tar", base + k * per, per, rng)
                  for k in range(n // per)]
        with open(root / f"{split}.json", "w") as f:
            json.dump({"shards": shards}, f)
    with open(root / "filter.json", "w") as f:
        json.dump({"punsafe": {"max": 0.5, "default": True}}, f)
    return root


def _draws(rng, shape):
    """(noise, timesteps, eps) as JAX's forward draws them from `rng`."""
    r_enc, r_t, r_noise = jax.random.split(rng, 3)
    lat = (shape[0], shape[1] // 8, shape[2] // 8, 4)
    eps = jax.random.normal(r_enc, lat, jnp.float32)
    t = jax.random.randint(r_t, (shape[0],), 0, 1000)
    noise = jax.random.normal(r_noise, lat, jnp.float32)
    return tuple(torch.from_numpy(np.array(a)) for a in (noise, t, eps))


def _jax_train_draws(step, micro, n_accum, mb):
    rng = jax.random.split(jax.random.fold_in(jax.random.key(SEED), step),
                           n_accum)[micro]
    return _draws(rng, tuple(mb["image"].shape))


def _jax_eval_draws(index, batch):
    return _draws(jax.random.fold_in(jax.random.key(1138), index),
                  tuple(batch["image"].shape))


class _JaxSteps(JaxCallback):
    def __init__(self):
        self.steps, self.captions = [], []

    def after_dataloader(self, state, logger):
        self.captions.append(np.asarray(state.batch["captions"]).copy())

    def batch_end(self, state, logger):
        self.steps.append(
            ({k: float(np.asarray(v)) for k, v in state.metrics.items()},
             unet_from_jax(jax.tree.map(np.array,
                                        state.train_state.params))))


class _Steps(Callback):
    def __init__(self):
        self.steps, self.captions = [], []

    def after_dataloader(self, state, logger):
        self.captions.append(state.batch["captions"].cpu().numpy().copy())

    def batch_end(self, state, logger):
        self.steps.append(
            ({k: float(v) for k, v in state.metrics.items()},
             {n: p.detach().clone()
              for n, p in state.train_state.params.items()}))


def _eval_logger(base):
    class Evals(base):
        def __init__(self):
            self.evals = []

        def log_metrics(self, metrics, step=None):
            if any(k.startswith("metrics/") for k in metrics):
                self.evals.append((step, dict(metrics)))
    return Evals()


@pytest.fixture(scope="module")
def runs(root):
    text = YAML.replace("{root}", str(root))
    with pytest.MonkeyPatch.context() as mp:
        # JAX gradients on the XLA paths (ROADMAP.md queue 3, fault 1), on
        # one device of the virtual CPU mesh
        mp.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "0")
        mp.setattr(jtrainer, "create_mesh", lambda **_: jmesh.create_mesh(
            fsdp=1, data=1, dcn=1, devices=jax.devices()[:1]))
        jtr = jax_build_trainer(jax_loads_config(text))
        initial = jax.tree.map(np.array, (jtr.train_state.params,
                                          jtr.frozen))
        jsteps, jevals = _JaxSteps(), _eval_logger(JaxLogger)
        jtr.engine.callbacks.append(jsteps)
        jtr.logger.loggers.append(jevals)
        try:
            jtr.eval()
            jtr.fit()
        finally:
            jtr.close()

    steps, evals, built = _Steps(), _eval_logger(Logger), []
    real = ttrain.build_trainer

    def build(config):
        tr = real(config)
        params, frozen = initial
        tr.model.unet.load_state_dict(unet_from_jax(params))
        tr.model.vae.load_state_dict(vae_from_jax(frozen["vae"]))
        tr.model.text_encoder.load_state_dict(
            clip_text_from_jax(frozen["text_encoder"]))
        tr.noise_hook, tr.eval_noise_hook = _jax_train_draws, _jax_eval_draws
        tr.engine.callbacks.append(steps)
        tr.logger.loggers.append(evals)
        built.append(tr)
        return tr

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrain, "build_trainer", build)
        tr = ttrain.train(loads_config(text))
    assert built == [tr]
    return jsteps, jevals.evals, steps, evals.evals, tr


def test_composes_the_online_encode_run(runs):
    *_, tr = runs
    assert type(tr.train_dataloader).__module__ == \
        "diffusion_torch.data.datapipes"
    assert type(tr.evaluators[0].dataloader).__module__ == \
        "diffusion_torch.data.datapipes"
    model = tr.model
    assert not model.precomputed_latents and model.vae is not None
    assert hasattr(model.vae, "encoder")
    assert tr.state.timestamp.batch == 4 and tr.train_state.step == 4
    # the frozen towers: no gradient, no optimizer state, no trainer param
    towers = [*model.vae.parameters(), *model.text_encoder.parameters()]
    assert all(p.grad is None and not p.requires_grad for p in towers)
    n_unet = len(list(model.unet.parameters()))
    assert len(tr.train_state.params) == n_unet
    assert len(tr.train_state.optimizer.mu) == n_unet


def test_batches_and_filter_match_jax(runs, root):
    jsteps, _, steps, _, _ = runs
    assert len(steps.captions) == len(jsteps.captions) == 4
    for g, w in zip(steps.captions, jsteps.captions):
        np.testing.assert_array_equal(g, w)
    # the filter drops exactly the flagged samples
    tok = tiny_tokenizer()
    ids = lambda caps: {tuple(r) for r in tok(caps)["input_ids"]}  # noqa
    kept = ids([f"photo number {i}" for i in range(N_TRAIN)
                if i not in UNSAFE])
    assert {tuple(r) for r in np.concatenate(steps.captions)} <= kept
    loader = build_wds_dataloader(meta_json=str(root / "train.json"),
                                  filter_strategy=str(root / "filter.json"),
                                  batch_size=1, resize_size=16)
    assert {tuple(b["captions"][0]) for b in loader} == kept
    assert len(kept) == N_TRAIN - len(UNSAFE)


def test_steps_match_jax(runs):
    jsteps, _, steps, _, _ = runs
    for i, ((gm, gp), (wm, wp)) in enumerate(zip(steps.steps, jsteps.steps)):
        assert sorted(gm) == sorted(wm) == ["grad/global_norm",
                                            "loss/train/total"]
        for k in wm:
            assert np.isfinite(gm[k])
            assert gm[k] == pytest.approx(wm[k], rel=1e-5), (i, k)
    # the last step's parameters, at test_torch_composition.py's tolerance
    _, gp = steps.steps[-1]
    _, wp = jsteps.steps[-1]
    assert sorted(gp) == sorted(wp)
    for name, wv in wp.items():
        np.testing.assert_allclose(gp[name].numpy(), wv.numpy(), atol=1e-6,
                                   rtol=1e-5, err_msg=name)


def test_evals_match_jax(runs):
    _, want, _, got, _ = runs
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 2]
    name = "metrics/eval/MeanSquaredError"
    for (_, g), (_, w) in zip(got, want):
        assert sorted(g) == sorted(w)
        assert np.isfinite(g[name])
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=1e-5), k
    assert got[0][1][name] != got[1][1][name]


@pytest.mark.parametrize("name", ["SD-2-base-256-wds.yaml",
                                  "SD-2-base-256-pexels.yaml"])
def test_yaml_trainer_sections_reach_the_trainer(name):
    """The online-encode yamls' `trainer:` sections, with `log_traces:
    false`, build a Trainer (tiny model, CPU); `log_traces: true` (the JAX
    package's profiler callback) raises, naming its ROADMAP.md item."""
    import os
    from diffusion_torch.config import load_config
    from diffusion_torch.train.train import build_trainer
    full = load_config(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "yamls", name))
    section = dict(full["trainer"], device="cpu")
    assert section["log_traces"] is False
    config = {"seed": full["seed"], "trainer": section, "model": {
        "_target_": "diffusion_tpu.models.models.stable_diffusion_tiny",
        "device": "cpu"}}
    tr = build_trainer(config)
    assert tr.max_batches == 550000 and tr.model.vae is not None
    tr.close()
    config["trainer"] = dict(section, log_traces=True)
    with pytest.raises(NotImplementedError, match="item 11"):
        build_trainer(config)
