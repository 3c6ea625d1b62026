"""The port's FID, Inception Score and CLIPScore: against the torchmetrics
goldens (`tests/goldens/metrics_golden.npz`, as `test_metric_goldens.py`
holds the JAX package), against the JAX package's metrics on the same
statistics, and the generation hook's refusal of random towers."""

import os

import numpy as np
import pytest

from diffusion_tpu.metrics.clip_score import CLIPScore as JaxCLIPScore
from diffusion_tpu.metrics.fid import FrechetInceptionDistance as JaxFID
from diffusion_tpu.metrics.inception_score import InceptionScore as JaxIS
from diffusion_torch.metrics.base import scale_suffix
from diffusion_torch.metrics.clip_score import CLIPScore
from diffusion_torch.metrics.fid import FrechetInceptionDistance
from diffusion_torch.metrics.generation_metrics import GenerationMetricsHook
from diffusion_torch.metrics.inception_score import InceptionScore
from diffusion_torch.models.models import stable_diffusion_tiny

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "metrics_golden.npz")


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.mark.parametrize("real_chunks,fake_chunks", [(3, 4), (1, 1)])
def test_fid_matches_torchmetrics_golden(golden, real_chunks, fake_chunks):
    fid = FrechetInceptionDistance(feature_dim=golden["fid_real"].shape[1])
    for chunk in np.array_split(golden["fid_real"], real_chunks):
        fid.update(features=chunk, real=True)
    for chunk in np.array_split(golden["fid_fake"], fake_chunks):
        fid.update(features=chunk, real=False)
    assert fid.compute() == pytest.approx(float(golden["fid_expected"]),
                                          rel=1e-6)


def test_inception_score_matches_torchmetrics_golden(golden):
    m = InceptionScore(splits=int(golden["is_splits"]))
    for chunk in np.array_split(golden["is_logits"], 5):
        m.update(logits=chunk)
    assert m.compute() == pytest.approx(float(golden["is_expected"]),
                                        rel=1e-6)


def test_clip_score_matches_torchmetrics_golden(golden):
    m = CLIPScore()
    m.update(embeddings=(golden["clip_img"], golden["clip_txt"]))
    assert m.compute() == pytest.approx(float(golden["clip_expected"]),
                                        rel=1e-6)


def test_clip_score_clamps_the_mean(golden):
    """torchmetrics clamps the mean at compute, not each sample."""
    m = CLIPScore()
    m.update(embeddings=(golden["clip_img_neg"], golden["clip_txt_neg"]))
    assert m._sum < 0.0
    assert m.compute() == pytest.approx(float(golden["clip_neg_expected"]),
                                        abs=1e-9)


@pytest.mark.parametrize("n,d", [(64, 16), (40, 2048)])
def test_same_statistics_same_results(n, d):
    """The port's metrics are copies of the JAX package's numpy code:
    the same updates give bit-equal results (n < d included: singular
    covariances)."""
    rng = np.random.default_rng(d)
    real = rng.normal(size=(n, d)).astype(np.float32)
    fake = (rng.normal(size=(n, d)) * 1.3 + 0.2).astype(np.float32)
    pairs = ((FrechetInceptionDistance(feature_dim=d),
              JaxFID(feature_dim=d)),)
    for port, jax_m in pairs:
        for m in (port, jax_m):
            for chunk in np.array_split(real, 3):
                m.update(features=chunk, real=True)
            m.update(features=fake, real=False)
        assert port.compute() == jax_m.compute()
    logits = rng.normal(size=(n, 1008)) * 3
    a, b = InceptionScore(splits=4), JaxIS(splits=4)
    for m in (a, b):
        m.update(logits=logits[: n // 2])
        m.update(logits=logits[n // 2:])
    assert a.compute() == b.compute()
    img, txt = rng.normal(size=(n, 768)), rng.normal(size=(n, 768))
    c, e = CLIPScore(), JaxCLIPScore()
    for m in (c, e):
        m.update(embeddings=(img, txt))
    assert c.compute() == e.compute()


def test_metric_names_and_empty_compute():
    assert scale_suffix("FrechetInceptionDistance", 3) == \
        "FrechetInceptionDistance-scale-3p0"
    fid = FrechetInceptionDistance(feature_dim=4)
    fid.update(features=np.ones((1, 4)), real=True)
    fid.update(features=np.ones((1, 4)), real=False)
    assert np.isnan(fid.compute())        # fewer than 2 samples a side
    assert np.isnan(InceptionScore().compute())
    assert np.isnan(CLIPScore().compute())


def test_hook_refuses_random_towers(monkeypatch):
    """A generation eval over random towers needs the opt-in: the model's
    `allow_random_tower_weights` (the scripts' --allow_random_towers) or
    DIFFUSION_TPU_ALLOW_RANDOM_TOWERS=1."""
    for var in ("DIFFUSION_TPU_INCEPTION_WEIGHTS",
                "DIFFUSION_TPU_CLIP_WEIGHTS",
                "DIFFUSION_TPU_ALLOW_RANDOM_TOWERS"):
        monkeypatch.delenv(var, raising=False)
    model = stable_diffusion_tiny(device="cpu")
    for names in (["FrechetInceptionDistance"], ["InceptionScore"],
                  ["CLIPScore"]):
        with pytest.raises(RuntimeError, match="No pretrained weights"):
            GenerationMetricsHook(model, [3.0], names)
    hook = GenerationMetricsHook(model, [1.0, 3.0],
                                 ["FrechetInceptionDistance",
                                  "InceptionScore"],
                                 allow_random_weights=True)
    assert sorted(hook.metrics) == [1.0, 3.0]
    assert sorted(hook.metrics[3.0]) == ["FrechetInceptionDistance",
                                         "InceptionScore"]
    # one InceptionV3 serves the features and the logits of every scale
    fid = hook.metrics[1.0]["FrechetInceptionDistance"].feature_fn
    assert fid is hook.metrics[3.0]["FrechetInceptionDistance"].feature_fn
    assert fid.tower is hook.metrics[3.0]["InceptionScore"].logits_fn.tower


def test_hook_drops_padded_rows():
    """Rows that `_valid` marks as padding (they trail the real ones) reach
    neither the generation nor the metrics; each scale generates once per
    batch, seeded with `val_seed`, with the hook's `latents_fn` draw."""
    import torch

    model = stable_diffusion_tiny(device="cpu")
    draws = []

    def latents_fn(index, shape):
        draws.append((index, shape))
        return torch.zeros(shape)

    hook = GenerationMetricsHook(model, [1.0, 2.0],
                                 ["FrechetInceptionDistance"], height=32,
                                 width=32, num_inference_steps=1,
                                 allow_random_weights=True,
                                 latents_fn=latents_fn)
    ids = torch.from_numpy(model.tokenizer(["a", "b", "c", "c"])["input_ids"])
    batch = {"image": torch.rand(4, 32, 32, 3), "captions": ids,
             "_valid": torch.tensor([1, 1, 1, 0])}
    hook.eval_batch(None, None, None, batch, 5)
    assert draws == [(5, (3, 4, 4, 4))] * 2
    for g in (1.0, 2.0):
        fid = hook.metrics[g]["FrechetInceptionDistance"]
        assert fid._n == {True: 3.0, False: 3.0}
