"""The offline generation eval: `GenerationMetricsHook` on the tiny model
over a small COCO MDS against the JAX package's hook (the same weights,
JAX's draws handed over, the same tower weights read from `.npz` files by
both packages' towers, small CLIP towers on both sides), and the port's
`fid_clip_evaluation` and `coco_eval` entry points end to end beside the
JAX scripts."""

import io
import json
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffusion_tpu.data import coco as jcoco
from diffusion_tpu.metrics import towers as jtowers
from diffusion_tpu.metrics.generation_metrics import \
    GenerationMetricsHook as JaxHook
from diffusion_tpu.models import clip as jclip
from diffusion_tpu.models.inception import InceptionV3 as JaxInception
from diffusion_tpu.models.models import stable_diffusion_tiny as jax_tiny
from diffusion_torch.data import coco as tcoco
from diffusion_torch.data.mds import MDSWriter
from diffusion_torch.inference.inference_model import StableDiffusionInference
from diffusion_torch.metrics import towers as ttowers
from diffusion_torch.metrics.generation_metrics import GenerationMetricsHook
from diffusion_torch.models import clip as tclip
from diffusion_torch.models.models import stable_diffusion_tiny

torch.set_num_threads(1)

SIZE, STEPS, BATCH, SAMPLES = 32, 2, 4, 8
SCALES = (1.0, 3.0)
NAMES = ("FrechetInceptionDistance", "InceptionScore", "CLIPScore")
TEXT = dict(vocab_size=49408, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=2,
            hidden_act="quick_gelu", projection_dim=24)
VISION = dict(image_size=224, patch_size=14, hidden_size=32,
              intermediate_size=64, num_hidden_layers=2,
              num_attention_heads=2, projection_dim=24)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / np.linalg.norm(want))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if hasattr(v, "items"):
            out.update(_flat(v, path))
        else:
            out[path] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The tower weights as `tools/port_weights.py` lays them out: a random
    InceptionV3 and a small random CLIP, each in an `.npz`."""
    root = tmp_path_factory.mktemp("towers")
    inception = JaxInception()
    inc = jax.jit(lambda k: inception.init(k, jnp.zeros((1, 75, 75, 3)),
                                           return_logits=True))(
        jax.random.key(1))
    clip = jclip.CLIPModel(jclip.CLIPTextConfig(**TEXT),
                           jclip.CLIPVisionConfig(**VISION))
    cp = clip.init(jax.random.key(2), jnp.zeros((1, 77), jnp.int32),
                   jnp.zeros((1, 224, 224, 3)))
    paths = {"inception": str(root / "inception.npz"),
             "clip": str(root / "clip.npz")}
    # BatchNorm off its fresh statistics, so the features and the logits
    # spread over the images (with mean 0 / var 1 they barely move)
    rng = np.random.default_rng(0)
    flat = _flat(jax.tree.map(np.asarray, inc))
    for path, v in flat.items():
        if path.endswith(("bn/scale", "bn/var")):
            flat[path] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif path.endswith(("bn/bias", "bn/mean")):
            flat[path] = rng.normal(0.0, 0.5, v.shape).astype(np.float32)
    np.savez(paths["inception"], **flat)
    np.savez(paths["clip"], **_flat(jax.tree.map(np.asarray, cp)))
    return paths


@pytest.fixture
def small_clip(monkeypatch, weights):
    """Both packages' towers read the `.npz` files named by the variables
    `yamls/eval.yaml` sets, into the small CLIP config."""
    monkeypatch.setenv("DIFFUSION_TPU_INCEPTION_WEIGHTS", weights["inception"])
    monkeypatch.setenv("DIFFUSION_TPU_CLIP_WEIGHTS", weights["clip"])
    monkeypatch.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "0")
    for mod, pkg in ((jtowers, jclip), (ttowers, tclip)):
        monkeypatch.setattr(mod, "VIT_L14_TEXT_CONFIG",
                            pkg.CLIPTextConfig(**TEXT))
        monkeypatch.setattr(mod, "VIT_L14_VISION_CONFIG",
                            pkg.CLIPVisionConfig(**VISION))


@pytest.fixture(scope="module")
def coco_mds(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("coco") / "mds")
    rng = np.random.default_rng(0)
    with MDSWriter(path, {"image": "bytes", "captions": "json"}) as w:
        for i in range(SAMPLES):
            buf = io.BytesIO()
            Image.fromarray(rng.integers(0, 255, (48, 40 + 8 * (i % 2), 3),
                                         np.uint8)).save(buf, format="JPEG")
            w.write({"image": buf.getvalue(),
                     "captions": [f"a synthetic photo number {i}"]})
    return path


def _record(hook):
    """Wrap every metric copy's tower function to record its outputs, in
    call order per scale."""
    seen = {g: {"features": [], "logits": [], "embeddings": []}
            for g in hook.metrics}
    for g, copies in hook.metrics.items():
        for name, attr, key in (
                ("FrechetInceptionDistance", "feature_fn", "features"),
                ("InceptionScore", "logits_fn", "logits"),
                ("CLIPScore", "embed_fn", "embeddings")):
            metric = copies[name]
            fn = getattr(metric, attr)

            def wrapped(*a, _fn=fn, _out=seen[g][key]):
                out = _fn(*a)
                _out.append(tuple(np.asarray(o) for o in out)
                            if isinstance(out, tuple) else np.asarray(out))
                return out
            setattr(metric, attr, wrapped)
    return seen


def test_hook_matches_jax(small_clip, coco_mds):
    """Per batch and scale, the port's tower outputs are JAX's: the
    features of the real images and of the generated ones, the logits and
    the CLIP embeddings within 1e-5 relative L2 (measured on the CPU:
    2e-7, 4e-7, 3e-7). The end-of-eval FID at 1e-4 relative (measured:
    1.1e-5): with 8 samples a side the 2048x2048 covariances have rank 7,
    and `eigh`'s square root of the product, with its eigenvalues clipped
    at 0, amplifies the features' 2e-7 about fifty-fold. CLIPScore at
    1e-5. The Inception Score is exp(0) = 1 on both sides: with 8 samples
    and 10 splits every split holds one sample."""
    jsd = jax_tiny()
    params, frozen = jsd.init_params(jax.random.key(0), image_size=SIZE)
    jhook = JaxHook(jsd, frozen, SCALES, NAMES, height=SIZE, width=SIZE,
                    num_inference_steps=STEPS)
    port = StableDiffusionInference(builder=stable_diffusion_tiny,
                                    device="cpu", default_size=SIZE,
                                    jax_params=(params, frozen)).model

    def latents_fn(index, shape):
        # the JAX hook draws normal(key(val_seed), shape) for every batch
        return torch.from_numpy(np.array(jax.random.normal(
            jax.random.key(port.val_seed), shape, jnp.float32)))

    thook = GenerationMetricsHook(port, SCALES, NAMES, height=SIZE,
                                  width=SIZE, num_inference_steps=STEPS,
                                  latents_fn=latents_fn)
    jseen, tseen = _record(jhook), _record(thook)
    kw = dict(remote=coco_mds, batch_size=BATCH, resize_size=SIZE,
              num_workers=1)
    evaluator = types.SimpleNamespace(label="coco-val")
    jstate = types.SimpleNamespace(
        train_state=types.SimpleNamespace(params=params))
    jbatches = list(jcoco.build_streaming_cocoval_dataloader(**kw))
    tbatches = list(tcoco.build_streaming_cocoval_dataloader(**kw))
    assert len(jbatches) == len(tbatches) == SAMPLES // BATCH
    for i, (jb, tb) in enumerate(zip(jbatches, tbatches)):
        jhook.eval_batch(None, evaluator, jstate, jb,
                         jax.random.fold_in(jax.random.key(1138), i))
        thook.eval_batch(None, evaluator, None,
                         {k: torch.from_numpy(v) for k, v in tb.items()}, i)
    for g in SCALES:
        j, t = jseen[g], tseen[g]
        # FID: per batch, the reals then the fakes
        assert len(t["features"]) == len(j["features"]) == 2 * len(jbatches)
        for k, (got, want) in enumerate(zip(t["features"], j["features"])):
            assert got.shape == want.shape == (BATCH, 2048)
            assert _rel(got, want) <= 1e-5, (g, k)
        for got, want in zip(t["logits"], j["logits"]):
            assert got.shape == (BATCH, 1008) and _rel(got, want) <= 1e-5
        for (gi, gt), (wi, wt) in zip(t["embeddings"], j["embeddings"]):
            assert _rel(gi, wi) <= 1e-5 and _rel(gt, wt) <= 1e-5
    got = thook.eval_end(None, evaluator, None)
    want = jhook.eval_end(None, evaluator, jstate)
    assert sorted(got) == sorted(want) and len(got) == 6
    for key, value in want.items():
        assert math.isfinite(got[key])
        bound = 1e-4 if "Frechet" in key else 1e-5
        assert got[key] == pytest.approx(value, rel=bound), key
    # eval_end resets every copy
    for copies in thook.metrics.values():
        assert copies["FrechetInceptionDistance"]._n == {True: 0.0,
                                                         False: 0.0}
        assert copies["CLIPScore"]._n == 0.0
        assert copies["InceptionScore"]._probs == []


def _keys(results):
    return sorted(k for k in results if "scale" in k)


def test_fid_clip_evaluation_end_to_end(small_clip, coco_mds, tmp_path):
    """The port's `fid_clip_evaluation.main` (tiny builder, --device cpu,
    32px, 2 steps, dpm++2m) gives the JAX script's metric keys, finite,
    writes them to --out, and logs the ten prompts' images."""
    from diffusion_torch.callbacks import log_diffusion_images
    from diffusion_torch.scripts import fid_clip_evaluation as tfid
    from scripts import fid_clip_evaluation as jfid

    logged = []
    real = log_diffusion_images.LogDiffusionImages.eval_batch_end

    def spy(self, state, logger):
        class Recorder:
            def log_images(self, img, name, step):
                logged.append((name, np.asarray(img).shape))
        real(self, state, Recorder())

    common = ["--remote", coco_mds, "--allow_random_towers", "--size",
              str(SIZE), "--batch_size", str(BATCH), "--num_inference_steps",
              str(STEPS), "--subset_num_batches", "2", "--guidance_scale",
              "3.0", "--scheduler", "dpm++2m"]
    log_diffusion_images.LogDiffusionImages.eval_batch_end = spy
    try:
        got = tfid.main(common + [
            "--builder", "diffusion_torch.models.models.stable_diffusion_tiny",
            "--device", "cpu", "--out", str(tmp_path / "port.jsonl")])
    finally:
        log_diffusion_images.LogDiffusionImages.eval_batch_end = real
    want = jfid.main(common + [
        "--builder", "diffusion_tpu.models.models.stable_diffusion_tiny",
        "--out", str(tmp_path / "jax.jsonl")])
    assert _keys(got) == _keys(want) == [
        "metrics/coco-val/CLIPScore-scale-3p0",
        "metrics/coco-val/FrechetInceptionDistance-scale-3p0"]
    assert all(math.isfinite(got[k]) for k in _keys(got))
    records = [json.loads(line) for line in open(tmp_path / "port.jsonl")]
    assert any("metrics/coco-val/FrechetInceptionDistance-scale-3p0" in r
               for r in records)
    assert [n for n, _ in logged] == tfid.PROMPTS
    assert {s for _, s in logged} == {(SIZE, SIZE, 3)}


def test_coco_eval_end_to_end(small_clip, coco_mds):
    """The port's `coco_eval.main` at two guidance scales: JAX's keys, one
    per (metric, scale), finite."""
    from diffusion_torch.scripts import coco_eval as tcoco_eval
    from scripts import coco_eval as jcoco_eval

    common = ["--remote", coco_mds, "--allow_random_towers", "--size",
              str(SIZE), "--batch_size", str(BATCH), "--guidance_scales",
              "1.0", "7.0", "--subset_num_batches", "1",
              "--num_inference_steps", str(STEPS)]
    got = tcoco_eval.main(common + [
        "--builder", "diffusion_torch.models.models.stable_diffusion_tiny",
        "--device", "cpu"])
    want = jcoco_eval.main(common + [
        "--builder", "diffusion_tpu.models.models.stable_diffusion_tiny"])
    assert _keys(got) == _keys(want) and len(_keys(got)) == 4
    assert all(math.isfinite(got[k]) for k in _keys(got))


def test_scripts_need_cuda_unless_asked(monkeypatch, coco_mds):
    from diffusion_torch.scripts import fid_clip_evaluation as tfid

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tfid.main(["--remote", coco_mds, "--allow_random_towers",
                   "--builder",
                   "diffusion_torch.models.models.stable_diffusion_tiny"])


@pytest.fixture
def tower_refs(monkeypatch):
    """Weak references to every metric tower `metrics/towers.py` builds,
    by kind, in build order."""
    import weakref

    refs = {"inception": [], "clip": []}
    real = ttowers._tower

    def spy(kind, path, device):
        tower = real(kind, path, device)
        refs[kind].append(weakref.ref(tower))
        return tower
    monkeypatch.setattr(ttowers, "_tower", spy)
    return refs


def _alive(refs):
    import gc
    gc.collect()
    return {k: sum(r() is not None for r in v) for k, v in refs.items()}


def test_eval_job_frees_its_towers(small_clip, coco_mds, tmp_path,
                                   tower_refs):
    """Port fault 13: once `fid_clip_evaluation.main` returns, no metric
    tower is referenced (they were cached for the process); the job loaded
    each tower once."""
    from diffusion_torch.scripts import fid_clip_evaluation as tfid

    got = tfid.main([
        "--remote", coco_mds, "--allow_random_towers", "--size", str(SIZE),
        "--batch_size", str(BATCH), "--num_inference_steps", str(STEPS),
        "--subset_num_batches", "1", "--guidance_scale", "3.0",
        "--builder", "diffusion_torch.models.models.stable_diffusion_tiny",
        "--device", "cpu", "--out", str(tmp_path / "port.jsonl")])
    assert math.isfinite(got["metrics/coco-val/CLIPScore-scale-3p0"])
    assert {k: len(v) for k, v in tower_refs.items()} == {"inception": 1,
                                                           "clip": 1}
    assert _alive(tower_refs) == {"inception": 0, "clip": 0}


def test_trainer_close_frees_the_hooks_towers(small_clip, coco_mds,
                                              tower_refs):
    """Port fault 13: a Trainer whose model scores FID, IS and CLIPScore
    loads one InceptionV3 (features and logits) and one CLIP for its hook;
    after `close()` neither is referenced, though the Trainer still is."""
    from diffusion_torch.train.trainer import Evaluator, Trainer

    model = stable_diffusion_tiny(
        device="cpu", val_metrics=list(NAMES), val_guidance_scales=[3.0],
        allow_random_tower_weights=True)
    loader = tcoco.build_streaming_cocoval_dataloader(
        remote=coco_mds, batch_size=BATCH, resize_size=SIZE, num_workers=0)
    trainer = Trainer(model=model, device="cpu", image_size=SIZE,
                      max_duration="1ba", eval_num_inference_steps=STEPS,
                      eval_dataloader=[Evaluator("coco-val", loader,
                                                 model.val_metric_names)])
    hook, = trainer.metric_hooks
    copies = hook.metrics[3.0]
    assert copies["FrechetInceptionDistance"].feature_fn.tower is \
        copies["InceptionScore"].logits_fn.tower
    del hook, copies
    assert _alive(tower_refs) == {"inception": 1, "clip": 1}
    trainer.close()
    assert trainer.metric_hooks == []
    assert {k: len(v) for k, v in tower_refs.items()} == {"inception": 1,
                                                           "clip": 1}
    assert _alive(tower_refs) == {"inception": 0, "clip": 0}
