"""A training run composed from one yaml by the JAX package's
`build_trainer` and by the port's, side by side (the counterpart of
tests/test_composition.py::test_train_from_config): tiny geometry on
precomputed LAION latents written under tmp_path from a numpy seed, grad
accumulation 2x2, AdamW with warmup and a milestone, EMA, `eval_first`
and one more eval at batch 2 of 4. The port starts from JAX's initial
UNet weights and is handed JAX's draws through `noise_hook` and
`eval_noise_hook`. Also the port's CLI, its builders' yaml keywords and
its monitors against the JAX ones."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_tpu.callbacks import monitors as jmonitors
from diffusion_tpu.config import loads_config as jax_loads_config
from diffusion_tpu.data.mds import MDSWriter
from diffusion_tpu.parallel import mesh as jmesh
from diffusion_tpu.train import trainer as jtrainer
from diffusion_tpu.metrics.mse import MeanSquaredError as JaxMSE
from diffusion_tpu.train.events import Callback as JaxCallback
from diffusion_tpu.train.train import build_trainer as jax_build_trainer
from diffusion_tpu.utils.logging import Logger as JaxLogger
from diffusion_torch import run as trun
from diffusion_torch.callbacks import monitors as tmonitors
from diffusion_torch.config import loads_config
from diffusion_torch.metrics.mse import MeanSquaredError
from diffusion_torch.models import models as tmodels
from diffusion_torch.models.port_jax import unet_from_jax
from diffusion_torch.train import trainer as ttrainer
from diffusion_torch.train.events import Callback
from diffusion_torch.train.train import build_trainer
from diffusion_torch.utils.logging import Logger
from diffusion_torch.utils.time import Timestamp

torch.set_num_threads(1)

SEED = 7
BINS = ((0, 0.5), (0.5, 1))

YAML = """
batch_size: 4
seed: 7
name: comp-parity
eval_first: true
algorithms:
  low_precision_groupnorm:
    _target_: diffusion_tpu.algorithms.low_precision.LowPrecisionGroupNorm
    attribute: unet
    precision: amp_bf16
  ema:
    _target_: diffusion_tpu.algorithms.ema.EMA
    smoothing: 0.9
    ema_start: 0ba
model:
  _target_: diffusion_tpu.models.models.stable_diffusion_tiny
  precomputed_latents: true
  val_guidance_scales: []
  device: cpu
dataset:
  train_batch_size: ${batch_size}
  eval_batch_size: 4
  train_dataset:
    _target_: diffusion_tpu.data.laion.build_streaming_laion_dataloader
    remote: {root}/train
    batch_size: ${batch_size}
    resize_size: 64
    precomputed_latents: true
    caption_latent_dim: 32
    shuffle: true
    num_workers: 2
  eval_dataset:
    _target_: diffusion_tpu.data.laion.build_streaming_laion_dataloader
    remote: {root}/eval
    batch_size: 8
    resize_size: 64
    precomputed_latents: true
    caption_latent_dim: 32
    shuffle: false
    num_workers: 2
optimizer:
  _target_: diffusion_tpu.train.optim.adamw
  lr: 1.0e-3
  weight_decay: 0.01
scheduler:
  name: multi_step_with_warmup
  t_warmup: 1ba
  milestones: [3ba]
  gamma: 0.5
callbacks:
  lr_monitor:
    _target_: diffusion_tpu.callbacks.monitors.LRMonitor
trainer:
  max_duration: 4ba
  eval_interval: 2ba
  device_train_microbatch_size: 2
  image_size: 64
  seed: ${seed}
  device: cpu
"""


def _shards(path, n, seed):
    rng = np.random.default_rng(seed)
    with MDSWriter(str(path), {"jpg": "bytes", "caption": "str",
                               "latents_64": "bytes",
                               "caption_latents": "bytes"},
                   size_limit=1 << 14) as w:
        for i in range(n):
            w.write({"jpg": b"", "caption": f"c{i}",
                     "latents_64": rng.standard_normal(
                         (4, 8, 8)).astype(np.float16).tobytes(),
                     "caption_latents": rng.standard_normal(
                         (77, 32)).astype(np.float16).tobytes()})


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_comp")
    _shards(root / "train", 16, 0)
    _shards(root / "eval", 8, 1)     # two eval batches of 4
    with open(root / "run.yaml", "w") as f:
        f.write(YAML.replace("{root}", str(root)))
    return root


def _jax_train_draws(step, micro, n_accum, mb):
    """The JAX train step's draws for (step, microbatch)."""
    rng = jax.random.split(jax.random.fold_in(jax.random.key(SEED), step),
                           n_accum)[micro]
    return _draws(rng, tuple(mb["image_latents"].shape))


def _jax_eval_draws(index, batch):
    """The JAX eval step's draws for eval batch `index` (val_seed 1138)."""
    rng = jax.random.fold_in(jax.random.key(1138), index)
    return _draws(rng, tuple(batch["image_latents"].shape))


def _draws(rng, shape):
    _, r_t, r_noise = jax.random.split(rng, 3)
    t = jax.random.randint(r_t, (shape[0],), 0, 1000)
    noise = jax.random.normal(r_noise, shape, jnp.float32)
    return torch.from_numpy(np.array(noise)), torch.from_numpy(np.array(t))


class _JaxSteps(JaxCallback):
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


class _Steps(Callback):
    def __init__(self):
        self.steps = []

    def batch_end(self, state, logger):
        ts = state.train_state
        self.steps.append({
            "metrics": {k: float(v) for k, v in state.metrics.items()},
            "lr": state.lr,
            "params": {n: p.detach().clone() for n, p in ts.params.items()},
            "ema": {n: e.clone() for n, e in ts.ema_params.items()}})


def _eval_logger(base):
    class Evals(base):
        def __init__(self):
            self.evals = []

        def log_metrics(self, metrics, step=None):
            if any(k.startswith("metrics/") for k in metrics):
                self.evals.append((step, dict(metrics)))
    return Evals()


def _run(trainer, steps, evals, config):
    trainer.engine.callbacks.append(steps)
    trainer.logger.loggers.append(evals)
    try:
        if config.get("eval_first") and trainer.evaluators:
            trainer.eval()
        trainer.fit()
    finally:
        trainer.close()


@pytest.fixture(scope="module")
def runs(root):
    text = YAML.replace("{root}", str(root))
    with pytest.MonkeyPatch.context() as mp:
        # JAX gradients on the XLA paths (ROADMAP.md queue 3, fault 1), on
        # one device of the virtual CPU mesh
        mp.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "0")
        mp.setattr(jtrainer, "create_mesh", lambda **_: jmesh.create_mesh(
            fsdp=1, data=1, dcn=1, devices=jax.devices()[:1]))
        jcfg = jax_loads_config(text)
        jtr = jax_build_trainer(jcfg)
        jtr.model = dataclasses.replace(jtr.model, loss_bins=BINS)
        initial = unet_from_jax(jax.tree.map(np.array,
                                             jtr.train_state.params))
        jsteps, jevals = _JaxSteps(), _eval_logger(JaxLogger)
        _run(jtr, jsteps, jevals, jcfg)

    cfg = loads_config(text)
    tr = build_trainer(cfg)
    tr.model.loss_bins = BINS
    tr.model.unet.load_state_dict(initial)
    with torch.no_grad():   # the EMA starts from the loaded weights
        for name, p in tr.train_state.params.items():
            tr.train_state.ema_params[name].copy_(p)
    tr.noise_hook, tr.eval_noise_hook = _jax_train_draws, _jax_eval_draws
    steps, evals = _Steps(), _eval_logger(Logger)
    _run(tr, steps, evals, cfg)
    return jsteps.steps, steps.steps, jevals.evals, evals.evals, tr


def test_composes_the_ports_objects(runs):
    *_, tr = runs
    assert type(tr).__module__ == "diffusion_torch.train.trainer"
    assert tr.ema_algorithm is not None
    assert not tr.ema_algorithm.ema_weights_active          # swapped back
    assert [type(a).__module__ for a in tr.engine.algorithms] == [
        "diffusion_torch.algorithms.low_precision",
        "diffusion_torch.algorithms.ema"]
    assert type(tr.evaluators[0].dataloader).__module__ == \
        "diffusion_torch.data.dataloader"
    assert tr.eval_interval == 2 and tr.max_batches == 4
    assert tr.state.timestamp.batch == 4 and tr.train_state.step == 4


def test_steps_match_jax(runs):
    want, got, *_ = runs
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g["metrics"]) == sorted(w["metrics"]) == [
            "grad/global_norm", "loss/train/total"]
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-6)
        for k in ("loss/train/total", "grad/global_norm"):
            assert g["metrics"][k] == pytest.approx(w["metrics"][k],
                                                    rel=1e-5), (i, k)
        for key in ("params", "ema"):
            assert sorted(g[key]) == sorted(w[key])
            for name, wv in w[key].items():
                np.testing.assert_allclose(g[key][name].numpy(), wv.numpy(),
                                           atol=1e-6, rtol=1e-5,
                                           err_msg=f"step {i} {key} {name}")
    assert [s["lr"] for s in got] == pytest.approx([0, 1e-3, 1e-3, 5e-4])


def test_evals_match_jax(runs):
    _, _, want, got, _ = runs
    # eval_first (at batch 0) and after batch 2; none after the last batch
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 2]
    names = ["metrics/eval/MeanSquaredError",
             "metrics/eval/MeanSquaredError/bin-0-0.5",
             "metrics/eval/MeanSquaredError/bin-0.5-1"]
    for (_, g), (_, w) in zip(got, want):
        assert sorted(g) == sorted(w) == names
        for name in names:
            assert np.isfinite(g[name])
            assert g[name] == pytest.approx(w[name], rel=1e-5), name
    # the EMA was swapped in: the second eval scored other weights
    assert got[0][1][names[0]] != got[1][1][names[0]]


def test_cli_composes_and_runs(root, capsys):
    with pytest.raises(ValueError, match="--config-path"):
        trun.main([])
    metrics = root / "cli_metrics.jsonl"
    trun.main(["--config-path", str(root), "--config-name", "run",
               "trainer.max_duration=2ba", "trainer.eval_interval=1ba",
               "dataset.eval_batch_size=4",
               "+trainer.eval_subset_num_batches=1",
               "+logger.file._target_=diffusion_tpu.utils.logging.FileLogger",
               f"+logger.file.filename={metrics}"])
    records = [json.loads(line) for line in open(metrics)]
    evals = [r for r in records if "metrics/eval/MeanSquaredError" in r]
    # eval_first and after batch 1
    assert [r["step"] for r in evals] == [0, 1]
    assert all(np.isfinite(r["metrics/eval/MeanSquaredError"]) for r in evals)
    assert any("loss/train/total" in r for r in records)
    assert any("algorithms/LowPrecisionGroupNorm/precision"
               in r.get("hparams", {}) for r in records)


def test_one_process_and_a_dividing_batch(root, monkeypatch):
    """Counterpart of tests/test_composition.py::
    test_train_batch_size_must_divide_hosts; and a world size above 1
    raises, naming multi-device (ROADMAP.md queue 1 item 9)."""
    text = YAML.replace("{root}", str(root))
    with pytest.raises(ValueError, match="multiple of"):
        build_trainer(loads_config(text, ["batch_size=0"]))
    model = tmodels.stable_diffusion_tiny(device="cpu",
                                          precomputed_latents=True)
    monkeypatch.setattr(ttrainer, "rank_and_world", lambda: (0, 2))
    with pytest.raises(NotImplementedError, match="item 9"):
        ttrainer.Trainer(model=model, device="cpu",
                         fsdp_config={"sharding_strategy": "SHARD_GRAD_OP"})


def test_builders_take_the_yaml_keywords(monkeypatch):
    seen = {}
    monkeypatch.setattr(tmodels, "_build",
                        lambda *a, **k: seen.update(args=a, kwargs=k))
    tmodels.stable_diffusion_2(pretrained=False, precomputed_latents=True,
                               encode_latents_in_fp16=False, fsdp=True,
                               val_metrics=["MeanSquaredError"],
                               val_guidance_scales=[], loss_bins=[],
                               val_seed=5, device="cpu")
    assert seen["args"][4] is torch.float32
    kw = seen["kwargs"]
    assert kw["loss_bins"] == ((0, 1),) and kw["val_seed"] == 5
    assert kw["val_metric_names"] == ("MeanSquaredError",)
    assert kw["fsdp"] is True and kw["timestep_spacing"] is None
    tmodels.stable_diffusion_2(loss_bins=[[0, 0.5], [0.5, 1]], device="cpu")
    assert seen["args"][4] is torch.bfloat16
    assert seen["kwargs"]["loss_bins"] == ((0, 0.5), (0.5, 1))
    # the generation eval's keywords reach the model
    tmodels.stable_diffusion_2(device="cpu", val_guidance_scales=[7.5, 3],
                               inception_weights="i.npz",
                               clip_metric_weights="c.npz",
                               allow_random_tower_weights=True)
    kw = seen["kwargs"]
    assert kw["val_guidance_scales"] == [7.5, 3]
    assert (kw["inception_weights"], kw["clip_metric_weights"],
            kw["allow_random_tower_weights"]) == ("i.npz", "c.npz", True)
    monkeypatch.undo()
    # a generation eval keeps the towers on precomputed latents (the JAX
    # rule)
    model = tmodels.stable_diffusion_tiny(device="cpu",
                                          val_guidance_scales=[7.5],
                                          precomputed_latents=True)
    assert model.val_guidance_scales == (7.5,)
    assert model.vae is not None and model.text_encoder is not None
    # pretrained=True: the JAX builders' check that model_name is a local
    # directory, raising what they raise
    from diffusion_tpu.models import models as jmodels
    for builder, jax_builder in (
            (tmodels.stable_diffusion_2, jmodels.stable_diffusion_2),
            (tmodels.stable_diffusion_tiny, jmodels.stable_diffusion_tiny)):
        for name in (None, "/nonexistent/sd2"):
            with pytest.raises(FileNotFoundError) as want:
                jax_builder(pretrained=True, model_name=name)
            with pytest.raises(type(want.value), match="local checkpoint"):
                builder(device="cpu", pretrained=True, model_name=name)


@pytest.mark.parametrize("name", ["SD-2-base-512.yaml",
                                  "SD-2-base-512-tp.yaml"])
def test_yaml_trainer_sections_reach_the_trainer(name):
    """The `trainer:` sections of the 512px yamls, with their
    `load_weights_only: true` and empty `load_path:`, build a Trainer (tiny
    model, CPU): the keywords are taken, where the port's Trainer once
    raised TypeError on them. The tp yaml's mesh then stops at the
    multi-device item."""
    import os
    from diffusion_torch.config import load_config
    full = load_config(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "yamls", name))
    section = dict(full["trainer"], device="cpu")
    assert section["load_weights_only"] is True
    assert section["load_path"] is None
    config = {"seed": full["seed"], "trainer": section, "model": {
        "_target_": "diffusion_tpu.models.models.stable_diffusion_tiny",
        "precomputed_latents": True, "device": "cpu"}}
    if "mesh_config" in section:
        with pytest.raises(NotImplementedError, match="item 9"):
            build_trainer(config)
        return
    tr = build_trainer(config)
    assert tr.save_folder is None and tr.state.timestamp.batch == 0
    assert tr.save_interval == 10000 and tr.max_batches == 850000
    tr.close()


class _Record(Logger):
    def __init__(self):
        self.calls = []

    def log_metrics(self, metrics, step=None):
        self.calls.append((step, metrics))


class _State:
    """The slice of the trainer's State the monitors read."""

    def __init__(self, params, metrics, wct, batch, samples):
        self.timestamp = Timestamp()
        self.timestamp.batch, self.timestamp.sample = batch, samples
        self.batch_wct, self.total_wct, self.lr = wct, 10.0 * batch, 1e-4
        self.metrics, self.max_batches = metrics, 50
        self.max_duration = "50ba"
        self.train_state = type("TS", (), {"params": params})()
        self.model = type("M", (), {"device": torch.device("cpu")})()


@pytest.mark.parametrize("name,kwargs", [
    ("SpeedMonitor", {"window_size": 3}),
    ("SpeedMonitor", {"window_size": 3, "flops_per_batch": 2e12,
                      "peak_tflops_per_device": 989}),
    ("LRMonitor", {}), ("RuntimeEstimator", {}),
    ("OptimizerMonitor", {"interval": 2})])
def test_monitors_log_what_jax_logs(monkeypatch, name, kwargs):
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    logs = {}
    for side, mod, to in (("jax", jmonitors, jnp.asarray),
                          ("torch", tmonitors, torch.from_numpy)):
        cb = getattr(mod, name)(**kwargs)
        rec = _Record()
        p = {k: to(v) for k, v in params.items()}
        for b in range(1, 7):
            state = _State(p, {"grad/global_norm": to(np.array(b, np.float32))},
                           0.0 if b == 1 else 0.25 * b, b, 4 * b)
            if b == 1 and hasattr(cb, "fit_start"):
                cb.fit_start(state, rec)
            cb.batch_end(state, rec)
        logs[side] = rec.calls
    assert [s for s, _ in logs["torch"]] == [s for s, _ in logs["jax"]]
    assert logs["torch"], "nothing logged"
    for (_, g), (_, w) in zip(logs["torch"], logs["jax"]):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=1e-6), k


def test_mean_squared_error_matches_jax():
    rng = np.random.default_rng(1)
    got, want = MeanSquaredError(), JaxMSE()
    assert np.isnan(got.compute()) and np.isnan(want.compute())
    for _ in range(3):
        p, t = rng.standard_normal((2, 3, 4)), rng.standard_normal((2, 3, 4))
        mask = rng.random((2, 3, 4)) < 0.5
        for m in (got, want):
            m.update(p, t)
            m.update(p, t, mask)
            m.update_sums(2.5, 4)
    assert got.compute() == want.compute()
    got.reset()
    assert np.isnan(got.compute())
