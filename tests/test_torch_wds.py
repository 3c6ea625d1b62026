"""The port's webdataset reader (`data/wds.py`, `datapipes.py`,
`filters.py`, copies of the JAX package's) against the JAX package's:
bit-identical batches over two shuffled epochs, with and without a filter
strategy and a corrupt JPEG, on the iterating thread and in 1 and 2 loader
workers; the workers' caption-drop draws, abandoned iterators, inline
fallback and exit; and the counterparts of tests/test_data.py's filter,
tar, shuffle and multiplexer tests."""

import io
import json
import os
import pickle
import random
import subprocess
import sys
import tarfile
import time
import threading
from concurrent.futures import Future

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


def _make_tar(path, name, n, seed, corrupt=()):
    """n samples of non-square JPEGs, .txt captions and .json metadata;
    every third flagged unsafe, every fifth with a short side under 40;
    the JPEGs of samples in `corrupt` cut off after their header."""
    rng = np.random.default_rng(seed)
    shard = os.path.join(path, name)
    with tarfile.open(shard, "w") as tf:
        for i in range(n):
            w, h = (56, 36) if i % 5 == 4 else (48 + 8 * (i % 3), 64)
            meta = {"width": w, "height": h,
                    "punsafe": 0.9 if i % 3 == 0 else 0.1}
            jpeg = _jpeg(rng, w, h)
            if i in corrupt:
                jpeg = jpeg[:2] + b"\x00" * 64
            for ext, data in (("jpg", jpeg),
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


def _counts():
    return tpipes.decoded_in_workers.value, tpipes.decoded_inline.value


@pytest.mark.parametrize("num_workers", [0, 1, 2])
@pytest.mark.parametrize("strategy", [None, STRATEGY, "file"])
def test_batches_match_jax_over_two_epochs(shards, strategy, num_workers,
                                           tmp_path):
    if strategy == "file":
        strategy = str(tmp_path / "strategy.json")
        with open(strategy, "w") as f:
            json.dump(STRATEGY, f)
    kw = dict(meta_json=shards["manifest"], batch_size=3, resize_size=32,
              shuffle_buffer=5, seed=9, filter_strategy=strategy,
              num_workers=num_workers)
    jdl, tdl = jwds.build_wds_dataloader(**kw), twds.build_wds_dataloader(**kw)
    assert type(tdl).__module__ == "diffusion_torch.data.datapipes"
    want = list(jdl) + list(jdl)
    before = _counts()
    got = list(tdl) + list(tdl)
    _assert_batches_equal(got, want)
    # every image decoded once an epoch: inline at 0 workers; with workers,
    # by them, and by the calling thread where it would wait
    workers, inline = [a - b for a, b in zip(_counts(), before)]
    assert workers + inline == 42 and (workers > 0) == (num_workers > 0)
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
    tdl.close()


@pytest.mark.parametrize("num_workers", [0, 1, 2])
def test_corrupt_jpeg_dropped_where_jax_drops_it(shards, num_workers,
                                                tmp_path):
    """A JPEG cut off after its header fails to decode; inline and in the
    workers the sample drops out before the shuffle, as in JAX's reader."""
    bad = _make_tar(str(tmp_path), "bad.tar", 7, 5, corrupt={2})
    kw = dict(urls=shards["paths"] + [bad], batch_size=4, resize_size=32,
              shuffle_buffer=5, seed=4, num_workers=num_workers)
    jdl, tdl = jwds.build_wds_dataloader(**kw), twds.build_wds_dataloader(**kw)
    want = list(jdl) + list(jdl)
    got = list(tdl) + list(tdl)
    tdl.close()
    _assert_batches_equal(got, want)
    assert len(got) == 2 * (27 // 4)      # 28 samples, one undecodable


@pytest.mark.parametrize("num_workers", [1, 2])
def test_caption_drop_draws_match_inline(shards, num_workers):
    """Caption dropout draws from the global `random` on the iterating
    thread, in sample order, whether or not workers decode."""
    kw = dict(meta_json=shards["manifest"], batch_size=3, resize_size=32,
              shuffle_buffer=5, seed=9, caption_drop_prob=0.2)
    runs = []
    for n in (0, num_workers):
        random.seed(0)
        dl = twds.build_wds_dataloader(num_workers=n, **kw)
        runs.append((list(dl) + list(dl), random.getstate()))
        dl.close()
    (want, state), (got, got_state) = runs
    _assert_batches_equal(got, want)
    assert got_state == state
    empty = twds.tiny_tokenizer()("")["input_ids"][0]
    dropped = sum((c == empty).all() for b in got for c in b["captions"])
    assert 0 < dropped < 14


def test_abandoned_iterator_then_next_epoch(shards):
    kw = dict(meta_json=shards["manifest"], batch_size=3, resize_size=32,
              shuffle_buffer=5, seed=9)
    epochs = {}
    for n in (0, 1):
        dl = twds.build_wds_dataloader(num_workers=n, prefetch_factor=4,
                                       **kw)
        it = iter(dl)
        first = next(it)
        del it                          # abandoned mid-epoch
        epochs[n] = [first] + list(dl)
        dl.close()
    _assert_batches_equal(epochs[1], epochs[0])
    whole = twds.build_wds_dataloader(num_workers=0, **kw)
    whole.load_state_dict({"epoch": 1})
    _assert_batches_equal(epochs[1][1:], list(whole))


class _Pool:
    """A pool whose workers never start a task: each future stays pending
    (cancellable) but the first `done` ones, given their results at once,
    and the first `running` after those, which a timer finishes."""

    def __init__(self, done=0, running=0):
        self.futures, self.done, self.running = [], done, running

    def submit(self, fn, data):
        f = Future()
        if len(self.futures) < self.done:
            f.set_result(data * 2)
        elif len(self.futures) < self.done + self.running:
            f.set_running_or_notify_cancel()
            threading.Timer(0.2, f.set_result, [data * 2]).start()
        self.futures.append(f)
        return f


def _images(n):
    return [{"image": bytes([i]), "i": i} for i in range(n)]


def test_closing_the_ordered_map_cancels_its_queue():
    """An abandoned iterator cancels what it still had queued."""
    pool = _Pool(done=1)
    gen = tpipes.ordered_map(iter(_images(12)), pool, None, window=8)
    assert next(gen)["image"] == b"\x00" * 2
    gen.close()
    assert len(pool.futures) == 8
    assert [f.cancelled() for f in pool.futures] == [False] + [True] * 7


def test_the_calling_thread_runs_what_no_worker_started():
    """Waiting for the oldest image, the calling thread runs the newest
    task no worker has started, then the next newest; the order holds."""
    ran = []

    def work(data):
        ran.append(data[0])
        return data * 3
    pool = _Pool(running=1)
    before = _counts()
    got = list(tpipes.ordered_map(iter(_images(8)), pool, work, window=8))
    assert [g["image"] for g in got] == [b"\x00" * 2] + [
        bytes([i]) * 3 for i in range(1, 8)]
    assert [g["i"] for g in got] == list(range(8))
    assert ran == list(range(7, 0, -1))
    assert [a - b for a, b in zip(_counts(), before)] == [1, 7]
    assert all(f.cancelled() for f in pool.futures[1:])


@pytest.mark.parametrize("size", [16, 24])
@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", "P"])
def test_centre_crop_matches_jax(mode, size):
    """The port crops with PIL's `crop`, JAX's package slices the array:
    the same pixels, in landscape, portrait and square images."""
    from diffusion_torch.data.transforms import CenterCropSDTransform
    from diffusion_tpu.data.transforms import CenterCropSDTransform as J
    rng = np.random.default_rng(size)
    for w, h in ((48, 64), (64, 48), (57, 33), (33, 57), (40, 40)):
        img = Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8))
        img = img.convert(mode)
        for centre in (True, False):
            port = CenterCropSDTransform(centre, size)
            want = J(centre, size)(img)
            crop = port.crop(img)
            assert crop.dtype == np.uint8 and crop.shape == (size, size, 3)
            got = port(img)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)


def test_unpicklable_transform_runs_inline(shards):
    from diffusion_torch.data.transforms import CenterCropSDTransform
    crop = CenterCropSDTransform(size=24)
    kw = dict(meta_json=shards["manifest"], batch_size=3, resize_size=24,
              shuffle_buffer=5, seed=2)
    want = list(twds.build_wds_dataloader(num_workers=0, transform=crop,
                                          **kw))
    # a picklable transform runs in the workers, whole
    dl = twds.build_wds_dataloader(num_workers=1, transform=crop, **kw)
    before = _counts()
    _assert_batches_equal(list(dl), want)
    workers, inline = [a - b for a, b in zip(_counts(), before)]
    assert workers > 0 and workers + inline == 21
    dl.close()
    with pytest.raises(Exception):
        pickle.dumps(lambda img: crop(img))
    dl = twds.build_wds_dataloader(num_workers=1,
                                   transform=lambda img: crop(img), **kw)
    before = _counts()
    _assert_batches_equal(list(dl), want)
    assert [a - b for a, b in zip(_counts(), before)] == [0, 21]
    assert dl._pool is None


def _alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def test_process_exits_with_its_workers(shards):
    """One batch taken, the rest of the epoch queued: the interpreter
    exits promptly and leaves no loader worker behind."""
    code = (
        "import multiprocessing\n"
        "from diffusion_torch.data.wds import build_wds_dataloader\n"
        f"dl = build_wds_dataloader(meta_json={shards['manifest']!r}, "
        "batch_size=2, resize_size=16, shuffle_buffer=2, num_workers=2, "
        "prefetch_factor=8)\n"
        "next(iter(dl))\n"
        "print(*[p.pid for p in multiprocessing.active_children()])\n")
    start = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=20)
    assert proc.returncode == 0, proc.stderr
    assert time.monotonic() - start < 20
    pids = [int(p) for p in proc.stdout.split()]
    assert len(pids) == 2
    deadline = time.monotonic() + 10
    while any(map(_alive, pids)) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not any(map(_alive, pids))


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
    all-hosts agreement and the shard split are torch.distributed's), and
    the loader workers import neither, nor torch."""
    code = (
        "import sys\n"
        "from diffusion_torch.data.wds import build_wds_dataloader\n"
        f"dl = build_wds_dataloader(meta_json={shards['manifest']!r}, "
        "batch_size=4, resize_size=16, num_workers=2)\n"
        "n = len(list(dl))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'diffusion_tpu')]\n"
        "assert not bad, bad\n"
        "worker = dl._pool.submit(eval, \"[m for m in __import__('sys')"
        ".modules if m.split('.')[0] in ('jax', 'diffusion_tpu', 'torch', "
        "'PIL')]\").result()\n"
        "assert worker and all(m.startswith('PIL') for m in worker), worker\n"
        "dl.close()\n"
        "print(n)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["5"]
