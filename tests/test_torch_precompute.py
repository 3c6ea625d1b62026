"""The port's latent precompute job (`diffusion_torch.scripts.
precompute_latents`) against the JAX package's (`scripts/
precompute_latents.py`), tiny geometry on the CPU.

- `encode_batch` against JAX's encode with the same weights (moved by
  `port_jax`) and the same posterior eps: (mean + std * eps) * latent
  scale, and the text tower's hidden states; relative L2 within 1e-5 in
  fp32, within one fp16 ulp elementwise after the cast (plus the fp32
  difference, 1e-5 of the largest magnitude, which near zero is more
  than the fp16 ulp there).
- Both jobs over one MDS whose images have short sides 200, 300 and 600, at
  sizes 256 and 512, JAX's `stable_diffusion_2` monkeypatched to the tiny
  builder in the test (and the port's, likewise): the same columns and
  encodings, sample order, image bytes, captions and empty-column pattern;
  `caption_latents` within one fp16 ulp, the port holding JAX's seed-0
  towers, which the JAX job always encodes with (it loads no weights). The
  port's latents are its `encode_batch` of the same crops with
  `posterior_eps` (JAX draws another eps: threefry is not torch's
  generator).
- Both packages' LAION readers read the port's shards into equal batches.
- The job refuses without weights, loads them from `--model-name`, splits
  two ranks as JAX's `partition` does, and releases its consumed input
  shards unless `--keep-inputs`.
"""

import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffusion_tpu.data import laion as jlaion
from diffusion_tpu.data.streaming import StreamingDataset as JaxDataset
from diffusion_tpu.models import models as jmodels
from diffusion_torch.data import laion as tlaion
from diffusion_torch.data.mds import MDSWriter
from diffusion_torch.data.streaming import StreamingDataset
from diffusion_torch.data.transforms import LargestCenterSquare, sd_normalize
from diffusion_torch.models import models as tmodels
from diffusion_torch.models.port_jax import clip_text_from_jax, vae_from_jax
from diffusion_torch.scripts import precompute_latents as tjob
from diffusion_torch.utils import safetensors

torch.set_num_threads(1)

SIDES = ((200, 264), (320, 300), (600, 640), (264, 200), (300, 420),
         (700, 600))
SIZES = (256, 512)
DIM = 32            # the tiny text tower's width


def _f16_ulp(x: np.ndarray) -> np.ndarray:
    x = np.abs(x.astype(np.float16))
    return np.spacing(x).astype(np.float32)


def _within_one_ulp(got: np.ndarray, want: np.ndarray) -> bool:
    """Elementwise within one fp16 ulp of the larger of the two, plus the
    fp32 values' own difference, 1e-5 of the largest magnitude (summation
    order): near zero that exceeds the fp16 ulp, which shrinks with the
    value."""
    g, w = got.astype(np.float32), want.astype(np.float32)
    noise = 1e-5 * float(np.abs(w).max())
    return bool(np.all(np.abs(g - w) <= np.maximum(_f16_ulp(g),
                                                     _f16_ulp(w)) + noise))


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def jax_towers():
    """JAX's tiny model and the seed-0 towers its job encodes with."""
    model = jmodels.stable_diffusion_tiny()
    _, frozen = model.init_params(jax.random.key(0), image_size=64)
    return model, jax.tree.map(np.asarray, frozen)


@pytest.fixture(scope="module")
def weights_dir(tmp_path_factory, jax_towers):
    """JAX's seed-0 tiny VAE and text tower as a diffusers directory."""
    _, frozen = jax_towers
    root = tmp_path_factory.mktemp("tiny_sd")
    for name, state, fname in (
            ("vae", vae_from_jax(frozen["vae"]),
             "diffusion_pytorch_model.safetensors"),
            ("text_encoder", clip_text_from_jax(frozen["text_encoder"]),
             "model.safetensors")):
        os.makedirs(root / name)
        safetensors.save_file({k: v.contiguous() for k, v in state.items()},
                              str(root / name / fname))
    return str(root)


def _write_source(path, sides, seed=0):
    rng = np.random.default_rng(seed)
    with MDSWriter(str(path), {"jpg": "bytes", "caption": "str"},
                   size_limit=1 << 17) as w:
        for i, (wd, ht) in enumerate(sides):
            base = rng.integers(0, 255, (ht // 8 + 1, wd // 8 + 1, 3),
                                np.uint8)
            img = Image.fromarray(base).resize((wd, ht), Image.BILINEAR)
            buf = io.BytesIO()
            img.save(buf, format="JPEG", quality=90)
            w.write({"jpg": buf.getvalue(), "caption": f"a photo {i} of a cat"})
    return str(path)


@pytest.fixture
def tiny_builders(monkeypatch):
    """Each job's `stable_diffusion_2` is its package's tiny builder."""
    monkeypatch.setattr(jmodels, "stable_diffusion_2",
                        jmodels.stable_diffusion_tiny)
    monkeypatch.setattr(tmodels, "stable_diffusion_2",
                        tmodels.stable_diffusion_tiny)
    monkeypatch.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "0")


def _run_jax_job(monkeypatch, argv):
    from scripts import precompute_latents as jjob
    monkeypatch.setattr(sys, "argv", ["precompute_latents.py", *argv])
    jjob.main()


def _read(out):
    with open(os.path.join(out, "index.json")) as f:
        shard = json.load(f)["shards"][0]
    ds = StreamingDataset(remote=out, shuffle=False)
    return (dict(zip(shard["column_names"], shard["column_encodings"])),
            [ds.get_sample(i) for i in range(len(ds))])


def _port_towers(weights_dir):
    model = tmodels.stable_diffusion_tiny(device="cpu",
                                          init_frozen_towers=True)
    assert tjob.load_towers(model, weights_dir)
    return model


def test_encode_batch_matches_jax(jax_towers, weights_dir):
    jmodel, frozen = jax_towers
    model = _port_towers(weights_dir)
    rng = np.random.default_rng(3)
    images = {s: rng.uniform(-1, 1, (2, s, s, 3)).astype(np.float32)
              for s in (64, 96)}
    eps = {s: rng.standard_normal((2, s // 8, s // 8, 4)).astype(np.float32)
           for s in images}
    ids = np.asarray(jmodel.tokenizer(["a red bus", "two cats"])["input_ids"])
    want = {}
    for s, x in images.items():
        post = jmodel.vae.apply(frozen["vae"], jnp.asarray(x),
                                method=jmodel.vae.encode)
        want[f"latents_{s}"] = np.asarray(
            (post.mean + post.std * eps[s]) * jmodel.latent_scale)
    want["caption_latents"] = np.asarray(jmodel.text_encoder.apply(
        frozen["text_encoder"], jnp.asarray(ids))[0])
    args = ({s: torch.from_numpy(x) for s, x in images.items()},
            torch.from_numpy(ids),
            {s: torch.from_numpy(e) for s, e in eps.items()})
    got32 = tjob.encode_batch(model, *args, dtype=torch.float32)
    got16 = tjob.encode_batch(model, *args)
    assert sorted(got32) == sorted(want) == [
        "caption_latents", "latents_64", "latents_96"]
    for k, w in want.items():
        assert got16[k].dtype == torch.float16
        assert got32[k].shape == w.shape, k
        # fp32 both ways: summation order through the encoder's convs
        assert _rel_l2(got32[k].numpy(), w) <= 1e-5, k
        assert _within_one_ulp(got16[k].numpy(), w.astype(np.float16)), k


@pytest.fixture(scope="module")
def jobs(tmp_path_factory, jax_towers, weights_dir):
    """Both jobs over one source at 256 and 512 (batch 4: a full batch and
    a short one)."""
    root = tmp_path_factory.mktemp("precompute")
    src = _write_source(root / "src", SIDES)
    common = ["--remote", src, "--sizes", *map(str, SIZES),
              "--batch-size", "4"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmodels, "stable_diffusion_2",
                   jmodels.stable_diffusion_tiny)
        mp.setattr(tmodels, "stable_diffusion_2",
                   tmodels.stable_diffusion_tiny)
        mp.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "0")
        _run_jax_job(mp, common + ["--local", str(root / "jcache"),
                                   "--out", str(root / "jout")])
        summary = tjob.main(common + [
            "--local", str(root / "tcache"), "--out", str(root / "tout"),
            "--model-name", weights_dir, "--device", "cpu"])
    return {"src": src, "jax": str(root / "jout" / "0"),
            "port": str(root / "tout" / "0"), "summary": summary}


def test_job_matches_jax_job(jobs, weights_dir):
    assert jobs["summary"]["towers"] == "loaded"
    assert jobs["summary"]["samples"] == len(SIDES)
    (jcols, jrows), (tcols, trows) = _read(jobs["jax"]), _read(jobs["port"])
    assert tcols == jcols == {"jpg": "bytes", "caption": "str",
                              "caption_latents": "bytes",
                              "latents_256": "bytes", "latents_512": "bytes"}
    assert len(trows) == len(jrows) == len(SIDES)
    src = StreamingDataset(remote=jobs["src"], shuffle=False)
    model = _port_towers(weights_dir)
    for i, (t, j) in enumerate(zip(trows, jrows)):
        raw = src.get_sample(i)
        assert t["jpg"] == j["jpg"] == raw["jpg"]
        assert t["caption"] == j["caption"] == raw["caption"]
        for s in SIZES:
            full = min(SIDES[i]) >= s
            assert (len(t[f"latents_{s}"]) > 0) == \
                (len(j[f"latents_{s}"]) > 0) == full, (i, s)
            if full:
                assert len(t[f"latents_{s}"]) == 2 * 4 * (s // 8) ** 2
        cap = (np.frombuffer(t["caption_latents"], np.float16),
               np.frombuffer(j["caption_latents"], np.float16))
        assert cap[0].shape == (77 * DIM,)
        assert _within_one_ulp(*cap), i
    # the port's latents are encode_batch of the same crops and eps
    for start in (0, 4):
        rows = range(start, min(start + 4, len(SIDES)))
        imgs = {}
        for s in SIZES:
            crops = []
            for i in rows:
                img = Image.open(io.BytesIO(trows[i]["jpg"])).convert("RGB")
                crops.append(sd_normalize(LargestCenterSquare(s)(img))
                             if min(img.size) >= s
                             else np.zeros((s, s, 3), np.float32))
            imgs[s] = torch.from_numpy(np.stack(crops))
        ids = torch.from_numpy(np.asarray(model.tokenizer(
            [trows[i]["caption"] for i in rows])["input_ids"]))
        want = tjob.encode_batch(model, imgs, ids, tjob.posterior_eps(
            0, start, len(rows), SIZES))
        for n, i in enumerate(rows):
            for s in SIZES:
                if trows[i][f"latents_{s}"]:
                    assert trows[i][f"latents_{s}"] == want[
                        f"latents_{s}"][n].permute(2, 0, 1).numpy().tobytes()
            assert trows[i]["caption_latents"] == \
                want["caption_latents"][n].numpy().tobytes()


@pytest.mark.parametrize("size", SIZES)
def test_both_readers_read_the_jobs_shards(jobs, size):
    """The LAION readers of both packages over the port's shards, one
    sample a batch (an empty column falls back to the image, on both
    sides): equal batches, and the latents are the bytes written."""
    kw = dict(remote=jobs["port"], batch_size=1, resize_size=size,
              precomputed_latents=True, caption_latent_dim=DIM,
              shuffle=False, num_workers=0, drop_last=False)
    got = list(tlaion.build_streaming_laion_dataloader(**kw))
    want = list(jlaion.build_streaming_laion_dataloader(**kw))
    _, rows = _read(jobs["port"])
    assert len(got) == len(want) == len(SIDES)
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w)
        for k in w:
            assert np.array_equal(np.asarray(g[k]), np.asarray(w[k])), (i, k)
        if min(SIDES[i]) >= size:
            assert sorted(g) == ["caption_latents", "image_latents"]
            s = size // 8
            stored = np.frombuffer(rows[i][f"latents_{size}"],
                                   np.float16).reshape(4, s, s)
            assert np.array_equal(np.asarray(g["image_latents"])[0],
                                  stored.transpose(1, 2, 0))
        else:
            assert "image" in g and "image_latents" not in g


def test_job_refuses_without_weights(tmp_path, tiny_builders):
    src = _write_source(tmp_path / "src", SIDES[:2])
    argv = ["--remote", src, "--out", str(tmp_path / "out"), "--sizes", "64",
            "--device", "cpu"]
    for extra in ([], ["--model-name", str(tmp_path)]):
        with pytest.raises(RuntimeError, match="--allow-random-towers"):
            tjob.main(argv + extra)
    summary = tjob.main(argv + ["--allow-random-towers"])
    assert summary["towers"] == "random" and summary["samples"] == 2


def test_job_loads_towers_from_model_name(tmp_path, tiny_builders,
                                          weights_dir, monkeypatch):
    """The towers the job encodes with hold the directory's weights, and
    its latents differ from the random towers'."""
    src = _write_source(tmp_path / "src", SIDES[:2])
    seen = []
    real = tjob.encode_batch

    def spy(model, *args, **kwargs):
        seen.append({k: v.clone() for k, v in model.vae.state_dict().items()})
        return real(model, *args, **kwargs)
    monkeypatch.setattr(tjob, "encode_batch", spy)
    argv = ["--remote", src, "--sizes", "64", "--device", "cpu"]
    tjob.main(argv + ["--out", str(tmp_path / "a"), "--model-name",
                      weights_dir])
    tjob.main(argv + ["--out", str(tmp_path / "b"), "--allow-random-towers"])
    stored = safetensors.load_dir(os.path.join(weights_dir, "vae"))
    assert sorted(seen[0]) == sorted(stored)
    assert all(torch.equal(seen[0][k], v) for k, v in stored.items())
    assert not all(torch.equal(seen[1][k], v) for k, v in stored.items())
    (_, a), (_, b) = _read(str(tmp_path / "a" / "0")), \
        _read(str(tmp_path / "b" / "0"))
    assert a[0]["latents_64"] != b[0]["latents_64"]


def test_job_splits_ranks_as_jax(tmp_path, tiny_builders, weights_dir,
                                 monkeypatch):
    """Two ranks (rank_and_world monkeypatched): out/0 and out/1 hold
    JAX's `partition(0, rank, 2)` of the source, each rank at a barrier
    after every batch."""
    src = _write_source(tmp_path / "src", SIDES[:5])
    barriers = []
    monkeypatch.setattr(tjob.dist, "barrier", lambda: barriers.append(1))
    for rank in (0, 1):
        monkeypatch.setattr(tjob, "rank_and_world", lambda r=rank: (r, 2))
        barriers.clear()
        summary = tjob.main(["--remote", src, "--out", str(tmp_path / "out"),
                             "--sizes", "64", "--batch-size", "2",
                             "--model-name", weights_dir, "--device", "cpu"])
        want = JaxDataset(remote=src, shuffle=False).partition(0, rank, 2)
        assert summary["samples"] == len(want) == 3
        assert len(barriers) == 2            # batches of 2 and 1
        _, rows = _read(str(tmp_path / "out" / str(rank)))
        assert [r["caption"] for r in rows] == [
            f"a photo {int(i)} of a cat" for i in want]


@pytest.mark.parametrize("keep", [False, True])
def test_job_releases_consumed_input_shards(tmp_path, tiny_builders,
                                            weights_dir, keep):
    src = _write_source(tmp_path / "src", SIDES[:4])
    with open(os.path.join(src, "index.json")) as f:
        shards = [s["raw_data"]["basename"] for s in json.load(f)["shards"]]
    assert len(shards) > 1
    cache = tmp_path / "cache"
    tjob.main(["--remote", src, "--local", str(cache), "--out",
               str(tmp_path / "out"), "--sizes", "64", "--batch-size", "2",
               "--model-name", weights_dir, "--device", "cpu"]
              + (["--keep-inputs"] if keep else []))
    cached = [s for s in shards if os.path.exists(cache / s)]
    assert cached == (shards if keep else [])
    assert all(os.path.exists(os.path.join(src, s)) for s in shards)
