"""The Pexels (JSON manifest) and mixed-source readers, and the three yamls
of the slice (SD-2-base-256-lora, -pexels and -mixdata), in the port
against the JAX package.

Readers: `build_pexels_dataloader` and `build_mix_dataloader` yield batches
bit-identical to JAX's over two shuffled epochs, with the synthesized
captions (a random prompt, up to 5 tags and "raw data"), the random choice
among a record's `local_paths` (some name a missing file), and the
multiplexer's per-source draw order, checked over 20,000 draws at the
mixdata yaml's weights (pexels 0.012 of 7.472: a short run may draw no
Pexels sample at all).

Yamls: each one loads the same on both sides with the same dotted
overrides, and a tiny run of each (tiny geometry, CPU, 2 batches of 4 in
microbatches of 2, an eval after batch 1) through JAX's `build_trainer` and
the port's `train(config)` gives the same losses, grad norms, eval metrics
(rel 1e-5) and final trainable parameters (atol 1e-6, rtol 1e-5). The port
starts from JAX's initial weights and gets JAX's draws through
`noise_hook` / `eval_noise_hook`, as tests/test_torch_composition_wds.py
does. Data are written under tmp_path from numpy seeds."""

import io
import json
import os
import random
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffusion_tpu.config import load_config as jax_load_config
from diffusion_tpu.data import datapipes as jpipes
from diffusion_tpu.data import mix as jmix
from diffusion_tpu.data import object_store as jstore
from diffusion_tpu.data import pexels as jpexels
from diffusion_tpu.parallel import mesh as jmesh
from diffusion_tpu.train import trainer as jtrainer
from diffusion_tpu.train.events import Callback as JaxCallback
from diffusion_tpu.train.train import build_trainer as jax_build_trainer
from diffusion_torch.config import load_config
from diffusion_torch.data import datapipes as tpipes
from diffusion_torch.data import mix as tmix
from diffusion_torch.data import object_store as tstore
from diffusion_torch.data import pexels as tpexels
from diffusion_torch.data.mds import MDSWriter
from diffusion_torch.models.port_jax import (clip_text_from_jax,
                                             unet_from_jax, vae_from_jax)
from diffusion_torch.train import train as ttrain
from diffusion_torch.train.events import Callback

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
N_PEXELS, N_WDS, N_COCO = 24, 16, 8
SIZES = ((48, 40), (40, 56), (64, 48), (36, 36))
MIX_WEIGHTS = {"pexels": 0.012, "laion": 5.3, "coyo": 2.1, "cc": 0.06}


def _jpeg(rng, w, h):
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(
        buf, format="JPEG")
    return buf.getvalue()


def _write_pexels(root, rng):
    """JPEGs of four sizes and a manifest of per-sample records; every 6th
    record also names a missing local file, so the random choice among
    `local_paths` sometimes drops the sample."""
    os.makedirs(root / "pexels")
    records = []
    for i in range(N_PEXELS):
        w, h = SIZES[i % 4]
        path = str(root / "pexels" / f"{i:04d}.jpg")
        with open(path, "wb") as f:
            f.write(_jpeg(rng, w, h))
        paths = [path] + ([str(root / "pexels" / f"gone-{i}.jpg")]
                          if i % 6 == 0 else [])
        records.append({"local_paths": paths,
                        "prompts": [f"pexels {i} first", f"pexels {i} other"],
                        "tags": [f"tag{i}-{j}" for j in range(i % 8)]})
    manifest = root / "pexels.json"
    with open(manifest, "w") as f:
        json.dump({"samples": records}, f)
    # the other manifest form: paths of per-sample JSON files
    paths = []
    for i, rec in enumerate(records[:6]):
        p = str(root / "pexels" / f"{i:04d}.json")
        with open(p, "w") as f:
            json.dump(rec, f)
        paths.append(p)
    with open(root / "pexels_paths.json", "w") as f:
        json.dump(paths + [str(root / "pexels" / "gone.json")], f)
    return str(manifest)


def _write_wds(root, name, rng):
    """One source's tar shards (JPEG, .txt caption) and manifest."""
    shards = []
    for k in range(2):
        path = str(root / f"{name}-{k}.tar")
        with tarfile.open(path, "w") as tf:
            for i in range(k * N_WDS // 2, (k + 1) * N_WDS // 2):
                w, h = SIZES[i % 4]
                for ext, data in (("jpg", _jpeg(rng, w, h)),
                                  ("txt", f"{name} sample {i}".encode())):
                    info = tarfile.TarInfo(f"{i:05d}.{ext}")
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
        shards.append(path)
    manifest = root / f"{name}.json"
    with open(manifest, "w") as f:
        json.dump({"shards": shards}, f)
    return str(manifest)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("pexels_mix")
    rng = np.random.default_rng(0)
    out = {"pexels": _write_pexels(root, rng)}
    for name in ("laion", "coyo", "cc"):
        out[name] = _write_wds(root, name, rng)
    with MDSWriter(str(root / "coco"), {"image": "bytes",
                                        "captions": "json"}) as w:
        for i in range(N_COCO):
            w.write({"image": _jpeg(rng, *SIZES[i % 4]),
                     "captions": [f"coco {i} caption {k}" for k in range(5)]})
    with MDSWriter(str(root / "raw"), {"image": "bytes",
                                       "caption": "str"}) as w:
        for i in range(16):
            w.write({"image": _jpeg(rng, *SIZES[i % 4]),
                     "caption": f"raw sample {i}"})
    out.update(coco=str(root / "coco"), raw=str(root / "raw"),
               root=root)
    return out


@pytest.fixture(autouse=True)
def _no_backoff(monkeypatch):
    """A missing file is retried with exponential backoff; skip the
    sleeps (both packages)."""
    monkeypatch.setattr(jstore.time, "sleep", lambda s: None)
    monkeypatch.setattr(tstore.time, "sleep", lambda s: None)


def _epochs(loader, n=2):
    return [[{k: (np.asarray(v) if not isinstance(v, list) else v)
              for k, v in b.items()} for b in loader] for _ in range(n)]


def _assert_same_epochs(got, want):
    assert len(got) == len(want)
    for ge, we in zip(got, want):
        assert len(ge) == len(we) > 0
        for gb, wb in zip(ge, we):
            assert sorted(gb) == sorted(wb)
            for k in wb:
                np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)


def test_pexels_batches_match_jax(data, monkeypatch):
    captions = {"jax": [], "port": []}
    for side, mod in (("jax", jpexels), ("port", tpexels)):
        real = mod.load_caption

        def record(rec, rng, max_tags=5, _real=real, _side=side):
            cap = _real(rec, rng, max_tags)
            captions[_side].append(cap)
            return cap
        monkeypatch.setattr(mod, "load_caption", record)
    kw = dict(meta_json=data["pexels"], batch_size=4, resize_size=32,
              caption_drop_prob=0.25, seed=3)
    want = _epochs(jpexels.build_pexels_dataloader(**kw))
    got = _epochs(tpexels.build_pexels_dataloader(**kw))
    _assert_same_epochs(got, want)
    assert captions["port"] == captions["jax"]
    assert all(c.endswith("raw data") for c in captions["port"])
    assert any(c.count(", ") == 6 for c in captions["port"])  # 5 tags
    # the missing paths dropped some samples, differently per epoch
    sizes = [sum(len(b["captions"]) for b in e) for e in got]
    assert all(s < N_PEXELS for s in sizes)
    assert got[0][0]["image"].shape == (4, 32, 32, 3)
    # the manifest of per-sample JSON paths (an unreadable one skipped)
    kw["meta_json"] = str(data["root"] / "pexels_paths.json")
    assert len(jpexels.build_pexels_dataloader(**kw).records) == \
        len(tpexels.build_pexels_dataloader(**kw).records) == 6


def _mix_conf(data):
    return {name: ({"_target_": "diffusion_tpu.data.pexels."
                                "build_pexels_dataloader",
                    "weight": w, "meta_json": data["pexels"]}
                   if name == "pexels" else
                   {"_target_": "diffusion_tpu.data.wds.build_wds_dataloader",
                    "weight": w, "meta_json": data[name]})
            for name, w in MIX_WEIGHTS.items()}


@pytest.mark.parametrize("num_workers", [0, 1])
def test_mix_batches_match_jax(data, num_workers):
    conf = _mix_conf(data)
    # equal weights here, so every source shows up in a short run; the wds
    # children decode inline or in a loader worker each
    for c in conf.values():
        c["weight"] = 1.0
        if "wds" in c["_target_"]:
            c["num_workers"] = num_workers
    kw = dict(batch_size=4, resize_size=32, caption_drop_prob=0.2, seed=5)
    random.seed(0)           # the wds transform's caption drop
    jloader = jmix.build_mix_dataloader(conf, **kw)
    want = _epochs(jloader)
    random.seed(0)
    tloader = tmix.build_mix_dataloader(conf, **kw)
    got = _epochs(tloader)
    _assert_same_epochs(got, want)
    assert type(tloader).__module__ == "diffusion_torch.data.mix"
    assert [type(p.pipe).__module__ for p in tloader.pipes_to_weights] == [
        "diffusion_torch.data.pexels"] + ["diffusion_torch.data.datapipes"] * 3
    assert list(tloader.pipes_to_weights.values()) == [0.25] * 4
    assert tloader.describe() == jloader.describe()
    assert tloader.state_dict() == jloader.state_dict() == {"epoch": 2}
    assert [getattr(p.pipe, "_pool", None) is not None
            for p in tloader.pipes_to_weights] == [False] + [
                bool(num_workers)] * 3
    tloader.close()
    assert not any(getattr(p.pipe, "_pool", None)
                   for p in tloader.pipes_to_weights)


class _Labeled:
    """An endless one-source batch pipe (batch size 1) for the
    multiplexer's draw order."""

    def __init__(self, name):
        self.name = name

    def __iter__(self):
        while True:
            yield {"source": np.asarray([self.name])}


def _labeled_source(name, batch_size=1, **_):
    assert batch_size == 1
    return _Labeled(name)


def test_mix_draw_order_matches_jax_at_the_yaml_weights():
    """20,000 draws at the mixdata yaml's weights through both
    `build_mix_dataloader`s (children named by `_target_`): the same
    sources in the same order, the weights normalized alike."""
    conf = {name: {"_target_": f"{__name__}._labeled_source", "weight": w,
                   "name": name} for name, w in MIX_WEIGHTS.items()}
    draws = {}
    for side, mod in (("jax", jmix), ("port", tmix)):
        loader = mod.build_mix_dataloader(conf, batch_size=1000, seed=42)
        it = iter(loader)
        draws[side] = np.concatenate([next(it)["source"]
                                      for _ in range(20)])
        weights = list(loader.pipes_to_weights.values())
        total = sum(MIX_WEIGHTS.values())
        assert weights == [w / total for w in MIX_WEIGHTS.values()]
    np.testing.assert_array_equal(draws["port"], draws["jax"])
    counts = {n: int((draws["port"] == n).sum()) for n in MIX_WEIGHTS}
    assert sum(counts.values()) == 20000
    for n, w in MIX_WEIGHTS.items():
        share = w / sum(MIX_WEIGHTS.values())
        # binomial: within 5 standard deviations of its expectation
        sd = (20000 * share * (1 - share)) ** 0.5
        assert abs(counts[n] - 20000 * share) < 5 * sd + 1, (n, counts)
    # the multiplexers alone, too
    for seed in (0, 7):
        pipes = {_Labeled(n): w for n, w in MIX_WEIGHTS.items()}
        a = [s["source"][0] for _, s in zip(range(3000),
             jpipes.sample_multiplexer(pipes, seed=seed))]
        b = [s["source"][0] for _, s in zip(range(3000),
             tpipes.sample_multiplexer(pipes, seed=seed))]
        assert a == b


# ---------------- the three yamls, composed and run tiny ----------------

def _overrides(name, data, metrics_file=None):
    common = [
        "batch_size=4", "model._target_="
        "diffusion_tpu.models.models.stable_diffusion_tiny",
        "+model.device=cpu", "+trainer.device=cpu",
        "trainer.max_duration=2ba", "trainer.eval_interval=1ba",
        "trainer.device_train_microbatch_size=2", "trainer.image_size=32",
        "dataset.eval_batch_size=4", "dataset.eval_dataset.batch_size=4",
        "+trainer.eval_subset_num_batches=1", "~logger",
        "dataset.train_dataset.resize_size=32",
        "dataset.eval_dataset.resize_size=32"]
    # the lora yaml's COCO reader names its workers; mixdata's does not
    coco = [f"dataset.eval_dataset.remote={data['coco']}",
            f"dataset.eval_dataset.local={data['coco']}",
            ("" if name == "lora" else "+")
            + "dataset.eval_dataset.num_workers=0"]
    if name == "lora":
        return common + coco + [
            "model.lora_rank=4", "model.lora_alpha=8.0",
            f"dataset.train_dataset.remote={data['raw']}",
            f"dataset.train_dataset.local={data['raw']}",
            "dataset.train_dataset.num_workers=0",
            "dataset.train_dataset.caption_drop_prob=0.0"]
    if name == "pexels":
        return common + [
            f"dataset.train_dataset.meta_json={data['pexels']}",
            f"dataset.eval_dataset.meta_json={data['pexels']}",
            "~algorithms"]
    return common + coco + [
        "dataset.train_dataset.caption_drop_prob=0.0",
        "~algorithms", "~callbacks.optimizer_monitor",
        *[f"dataset.train_dataset.datapipes.{src}.{key}={data[src]}"
          for src, key in (("pexels", "meta_json"), ("laion", "urls"),
                           ("coyo", "urls"), ("cc", "urls"))]]


YAMLS = {"lora": "SD-2-base-256-lora.yaml",
         "pexels": "SD-2-base-256-pexels.yaml",
         "mix": "SD-2-base-256-mixdata.yaml"}


@pytest.mark.parametrize("name", sorted(YAMLS))
def test_yaml_composes_the_same(name, data):
    path = os.path.join(ROOT, "yamls", YAMLS[name])
    overrides = _overrides(name, data)
    got = load_config(path, overrides)
    assert got == jax_load_config(path, overrides)
    unedited = load_config(path)
    assert unedited == jax_load_config(path)
    if name == "lora":
        assert unedited["model"]["lora_rank"] == 8
        assert unedited["model"]["train_lora_only"] is True


def _draws(rng, shape):
    """(noise, timesteps, eps) as JAX's raw-image forward draws them."""
    r_enc, r_t, r_noise = jax.random.split(rng, 3)
    lat = (shape[0], shape[1] // 8, shape[2] // 8, 4)
    eps = jax.random.normal(r_enc, lat, jnp.float32)
    t = jax.random.randint(r_t, (shape[0],), 0, 1000)
    noise = jax.random.normal(r_noise, lat, jnp.float32)
    return tuple(torch.from_numpy(np.array(a)) for a in (noise, t, eps))


def _train_draws(seed):
    def hook(step, micro, n_accum, mb):
        rng = jax.random.split(jax.random.fold_in(jax.random.key(seed),
                                                  step), n_accum)[micro]
        return _draws(rng, tuple(mb["image"].shape))
    return hook


def _eval_draws(index, batch):
    return _draws(jax.random.fold_in(jax.random.key(1138), index),
                  tuple(batch["image"].shape))


class _JaxSteps(JaxCallback):
    def __init__(self):
        self.steps = []

    def batch_end(self, state, logger):
        self.steps.append(
            ({k: float(np.asarray(v)) for k, v in state.metrics.items()},
             unet_from_jax(jax.tree.map(np.array,
                                        state.train_state.params))))


class _Steps(Callback):
    def __init__(self):
        self.steps = []

    def batch_end(self, state, logger):
        self.steps.append(
            ({k: float(v) for k, v in state.metrics.items()},
             {n: p.detach().clone()
              for n, p in state.train_state.params.items()}))


def _evals(trainer_cls_logger):
    class Evals(trainer_cls_logger):
        def __init__(self):
            self.evals = []

        def log_metrics(self, metrics, step=None):
            if any(k.startswith("metrics/") for k in metrics):
                self.evals.append((step, dict(metrics)))
    return Evals()


@pytest.fixture(scope="module", params=sorted(YAMLS))
def tiny_run(request, data):
    from diffusion_tpu.utils.logging import Logger as JaxLogger
    from diffusion_torch.utils.logging import Logger
    name = request.param
    path = os.path.join(ROOT, "yamls", YAMLS[name])
    overrides = _overrides(name, data)
    with pytest.MonkeyPatch.context() as mp:
        # JAX gradients on the XLA paths (ROADMAP.md queue 3, fault 1), on
        # one device; no backoff sleeps for the missing Pexels files
        mp.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "0")
        mp.setattr(jtrainer, "create_mesh", lambda **_: jmesh.create_mesh(
            fsdp=1, data=1, dcn=1, devices=jax.devices()[:1]))
        mp.setattr(jstore.time, "sleep", lambda s: None)
        random.seed(0)
        jtr = jax_build_trainer(jax_load_config(path, overrides))
        params = jax.tree.map(np.array, jtr.train_state.params)
        frozen = jax.tree.map(np.array, jtr.frozen)
        jsteps, jevals = _JaxSteps(), _evals(JaxLogger)
        jtr.engine.callbacks.append(jsteps)
        jtr.logger.loggers.append(jevals)
        try:
            jtr.fit()
        finally:
            jtr.close()

    steps, evals, built = _Steps(), _evals(Logger), []
    real = ttrain.build_trainer

    def build(config):
        tr = real(config)
        state = unet_from_jax(params)
        if "unet_base" in frozen:
            state.update(unet_from_jax(frozen["unet_base"]))
        tr.model.unet.load_state_dict(state)
        tr.model.vae.load_state_dict(vae_from_jax(frozen["vae"]))
        tr.model.text_encoder.load_state_dict(
            clip_text_from_jax(frozen["text_encoder"]))
        tr.noise_hook = _train_draws(config["seed"])
        tr.eval_noise_hook = _eval_draws
        tr.engine.callbacks.append(steps)
        tr.logger.loggers.append(evals)
        built.append(tr)
        return tr

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrain, "build_trainer", build)
        mp.setattr(tstore.time, "sleep", lambda s: None)
        random.seed(0)
        tr = ttrain.train(load_config(path, overrides))
    assert built == [tr]
    return name, jsteps.steps, jevals.evals, steps.steps, evals.evals, tr


def test_tiny_run_composes_the_port(tiny_run):
    name, *_, tr = tiny_run
    loader = tr.train_dataloader
    assert type(loader).__module__ == {
        "lora": "diffusion_torch.data.dataloader",
        "pexels": "diffusion_torch.data.pexels",
        "mix": "diffusion_torch.data.mix"}[name]
    assert tr.state.timestamp.batch == 2
    model = tr.model
    trainable = {n for n, p in model.unet.named_parameters()
                 if p.requires_grad}
    assert sorted(tr.train_state.params) == sorted(trainable)
    if name == "lora":
        assert model.train_lora_only and trainable and all(
            "_lora_" in n for n in trainable)
    else:
        assert len(trainable) == len(list(model.unet.parameters()))
    if name == "mix":
        assert list(loader.pipes_to_weights.values()) == [
            w / sum(MIX_WEIGHTS.values()) for w in MIX_WEIGHTS.values()]


def test_tiny_run_matches_jax(tiny_run):
    name, jsteps, jevals, steps, evals, _ = tiny_run
    assert len(steps) == len(jsteps) == 2
    for i, ((gm, gp), (wm, wp)) in enumerate(zip(steps, jsteps)):
        for k in ("loss/train/total", "grad/global_norm"):
            assert np.isfinite(gm[k])
            assert gm[k] == pytest.approx(wm[k], rel=1e-5), (name, i, k)
    _, gp = steps[-1]
    _, wp = jsteps[-1]
    assert sorted(gp) == sorted(wp)
    for pname, wv in wp.items():
        np.testing.assert_allclose(gp[pname].numpy(), wv.numpy(), atol=1e-6,
                                   rtol=1e-5, err_msg=pname)
    assert [s for s, _ in evals] == [s for s, _ in jevals] == [1]
    for (_, g), (_, w) in zip(evals, jevals):
        assert sorted(g) == sorted(w)
        for k in w:
            assert np.isfinite(g[k])
            assert g[k] == pytest.approx(w[k], rel=1e-5), (name, k)
