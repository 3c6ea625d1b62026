"""The port's webdataset reader (`data/wds.py`, `datapipes.py`,
`filters.py`, copies of the JAX package's) against the JAX package's:
bit-identical batches over two shuffled epochs, with and without a filter
strategy, and the counterparts of tests/test_data.py's filter, tar,
shuffle and multiplexer tests."""

import io
import json
import os
import subprocess
import sys
import tarfile

import numpy as np
import pytest
from PIL import Image

from diffusion_tpu.data import datapipes as jpipes
from diffusion_tpu.data import filters as jfilters
from diffusion_tpu.data import wds as jwds
from diffusion_torch.data import datapipes as tpipes
from diffusion_torch.data import filters as tfilters
from diffusion_torch.data import wds as twds

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
STRATEGY = {"punsafe": {"max": 0.5, "default": True},
            "short_side": {"min": 40, "default": False}}


def _jpeg(rng, w, h):
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(
        buf, format="JPEG")
    return buf.getvalue()


def _make_tar(path, name, n, seed):
    """n samples of non-square JPEGs, .txt captions and .json metadata;
    every third flagged unsafe, every fifth with a short side under 40."""
    rng = np.random.default_rng(seed)
    shard = os.path.join(path, name)
    with tarfile.open(shard, "w") as tf:
        for i in range(n):
            w, h = (56, 36) if i % 5 == 4 else (48 + 8 * (i % 3), 64)
            meta = {"width": w, "height": h,
                    "punsafe": 0.9 if i % 3 == 0 else 0.1}
            for ext, data in (("jpg", _jpeg(rng, w, h)),
                              ("txt", f"sample {name}-{i}".encode()),
                              ("json", json.dumps(meta).encode())):
                info = tarfile.TarInfo(f"{name}-{i:04d}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    return shard


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("wds")
    paths = [_make_tar(str(root), f"{i}.tar", 7, i) for i in range(3)]
    manifest = os.path.join(str(root), "manifest.json")
    with open(manifest, "w") as f:
        json.dump({"shards": paths}, f)
    return {"paths": paths, "manifest": manifest, "root": str(root)}


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["captions", "image"]
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("strategy", [None, STRATEGY, "file"])
def test_batches_match_jax_over_two_epochs(shards, strategy, tmp_path):
    if strategy == "file":
        strategy = str(tmp_path / "strategy.json")
        with open(strategy, "w") as f:
            json.dump(STRATEGY, f)
    kw = dict(meta_json=shards["manifest"], batch_size=3, resize_size=32,
              shuffle_buffer=5, seed=9, filter_strategy=strategy)
    jdl, tdl = jwds.build_wds_dataloader(**kw), twds.build_wds_dataloader(**kw)
    assert type(tdl).__module__ == "diffusion_torch.data.datapipes"
    want = list(jdl) + list(jdl)
    got = list(tdl) + list(tdl)
    _assert_batches_equal(got, want)
    # a new shard order in the second epoch
    assert not all(np.array_equal(a["captions"], b["captions"])
                   for a, b in zip(got[:len(got) // 2], got[len(got) // 2:]))
    img = got[0]["image"]
    assert img.shape == (3, 32, 32, 3) and img.dtype == np.float32
    assert -1.0 <= img.min() and img.max() <= 1.0       # [-1, 1] by contract
    # 21 samples; the strategy keeps those neither unsafe nor short
    kept = 21 if strategy is None else sum(
        1 for _ in range(3) for i in range(7) if i % 3 and i % 5 != 4)
    assert len(got) == 2 * (kept // 3)
    assert tdl.state_dict() == jdl.state_dict() == {"epoch": 2}
    tdl.load_state_dict({"epoch": 0})
    _assert_batches_equal(list(tdl), want[:len(want) // 2])


def test_filter_fn_matches_jax():
    cases = [{"json": {"height": 512, "width": 300, "aesthetic": 6.0,
                       "punsafe": 0.1}},
             {"json": {"height": 100, "width": 300}},
             {"json": {}},
             {"json": {"height": 512, "width": 512, "AESTHETIC_SCORE": 2.0}},
             {"json": {"height": 512, "width": 512, "punsafe": 0.9}},
             {"json": json.dumps({"height": 900, "width": 100})},
             {"json": b"not json"}]
    strat = {"short_side": {"min": 256, "default": False},
             "aspect_ratio": {"max": 3.0}, "aesthetic": {"min": 5.0},
             "punsafe": {"max": 0.5, "default": True},
             "pwatermark": {"max": 0.5}}
    for s in (None, strat):
        got = [tfilters.filter_fn(c, s) for c in cases]
        assert got == [jfilters.filter_fn(c, s) for c in cases]
    assert [tfilters.filter_fn(c, strat) for c in cases] == [
        True, False, False, False, False, False, False]
    assert tfilters.load_filter_strategy(strat) == strat


def test_tar_samples_and_shard_listing_match_jax(shards):
    got = list(tpipes.tar_samples(shards["paths"]))
    want = list(jpipes.tar_samples(shards["paths"]))
    assert len(got) == len(want) == 21
    assert got == want
    assert set(got[0]) == {"jpg", "txt", "json", "__key__", "__url__"}
    assert tpipes.list_shards(shards["root"]) == jpipes.list_shards(
        shards["root"]) == sorted(shards["paths"])
    assert tpipes.list_shards([], manifest=shards["manifest"]) == \
        shards["paths"]


def test_shuffle_and_multiplexer_match_jax():
    for seed in (0, 1):
        got = list(tpipes.sample_shuffle(range(100), 10, seed))
        assert got == list(jpipes.sample_shuffle(range(100), 10, seed))
        assert sorted(got) == list(range(100)) and got != list(range(100))
    a, b = tuple(range(1000)), tuple(range(1000, 2000))
    got = list(tpipes.sample_multiplexer({a: 0.9, b: 0.1}, seed=0))
    assert got == list(jpipes.sample_multiplexer({a: 0.9, b: 0.1}, seed=0))
    assert len(got) == 2000
    assert tpipes.shard_shuffle(list("abcdef"), 3, 1) == \
        jpipes.shard_shuffle(list("abcdef"), 3, 1)


def test_iterating_imports_no_jax(shards):
    """Reading a shard runs no module of jax or the JAX package (the
    all-hosts agreement and the shard split are torch.distributed's)."""
    code = (
        "import sys\n"
        "from diffusion_torch.data.wds import build_wds_dataloader\n"
        f"dl = build_wds_dataloader(meta_json={shards['manifest']!r}, "
        "batch_size=4, resize_size=16)\n"
        "n = len(list(dl))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'diffusion_tpu')]\n"
        "assert not bad, bad\n"
        "print(n)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["5"]
