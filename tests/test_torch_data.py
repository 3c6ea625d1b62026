"""The port's data layer against the JAX package's, on the same shards and
seed: MDS shards written by either side read back the same on the other
(and the two writers write the same bytes), and the streaming readers
yield bit-identical batches for two shuffled epochs: raw samples through
the DataLoader, JPEG + caption batches, LAION precomputed latents (NHWC
fp16) and COCO images in [0, 1]. Also: the port builds and loads its own
`libdataio`, never the JAX package's."""

import hashlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from diffusion_tpu.data import coco as jcoco
from diffusion_tpu.data import dataloader as jdl
from diffusion_tpu.data import image_caption as jic
from diffusion_tpu.data import laion as jlaion
from diffusion_tpu.data import mds as jmds
from diffusion_tpu.data import streaming as jstreaming
from diffusion_torch.data import coco as tcoco
from diffusion_torch.data import dataloader as tdl
from diffusion_torch.data import image_caption as tic
from diffusion_torch.data import laion as tlaion
from diffusion_torch.data import mds as tmds
from diffusion_torch.data import native as tnative
from diffusion_torch.data import streaming as tstreaming

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
COLUMNS = {"jpg": "bytes", "caption": "str", "idx": "int", "meta": "json"}


def _jpeg(rng, w=40, h=30):
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
        buf, format="JPEG")
    return buf.getvalue()


def _samples(n=25, seed=0):
    rng = np.random.default_rng(seed)
    return [{"jpg": _jpeg(rng), "caption": f"caption {i}", "idx": i,
             "meta": {"i": i, "tags": ["a", str(i)]}} for i in range(n)]


def _write(mds, path, samples, columns=COLUMNS, size_limit=2000):
    with mds.MDSWriter(str(path), columns, size_limit=size_limit) as w:
        for s in samples:
            w.write(s)
    return str(path)


def _read_all(mds, path):
    index = mds.MDSIndex(path)
    out = []
    for info in index.shards:
        reader = mds.MDSShardReader.from_shard_info(path, info)
        out += [reader.get(i) for i in range(info["samples"])]
    return index, out


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
                np.testing.assert_array_equal(g[k], w[k])
            else:
                assert g[k] == w[k]


def _two_epochs(loader):
    return list(loader) + list(loader)


def test_mds_round_trip_both_directions(tmp_path):
    samples = _samples()
    jdir = _write(jmds, tmp_path / "jax", samples)
    tdir = _write(tmds, tmp_path / "port", samples)
    for writer_dir in (jdir, tdir):
        for mds in (jmds, tmds):
            index, got = _read_all(mds, writer_dir)
            assert index.num_samples == 25 and len(index.shards) > 1
            assert got == samples
    # the two writers write the same files
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    for name in os.listdir(jdir):
        with open(os.path.join(jdir, name), "rb") as a, \
                open(os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read(), name


def test_streaming_order_and_partition_match(tmp_path):
    path = _write(tmds, tmp_path / "mds", _samples())
    kw = dict(local=path, shuffle=True, shuffle_seed=5, num_canonical_nodes=4)
    jds, tds = jstreaming.StreamingDataset(**kw), tstreaming.StreamingDataset(**kw)
    for epoch in (0, 1):
        np.testing.assert_array_equal(tds.epoch_order(epoch),
                                      jds.epoch_order(epoch))
        for rank in range(3):
            np.testing.assert_array_equal(tds.partition(epoch, rank, 3),
                                          jds.partition(epoch, rank, 3))
    assert tds.get_sample(13) == jds.get_sample(13)


def test_dataloader_batches_match(tmp_path):
    """Counterpart of tests/test_data.py::test_dataloader_batches, both
    loaders over one dataset: two shuffled epochs, then resuming."""
    path = _write(tmds, tmp_path / "mds", _samples())

    def loader(side, **kw):
        class Identity(side[0].StreamingDataset):
            def process_sample(self, s):
                return {"idx": np.int64(s["idx"]),
                        "x": np.full(3, s["idx"], np.float32)}
        ds = Identity(local=path, shuffle=True, shuffle_seed=3)
        return side[1].DataLoader(ds, batch_size=4, drop_last=True,
                                  num_workers=2, **kw)

    jax_side, port_side = (jstreaming, jdl), (tstreaming, tdl)
    want = _two_epochs(loader(jax_side))
    got = _two_epochs(loader(port_side))
    assert len(got) == 12                              # 2 x (25 // 4)
    _assert_batches_equal(got, want)
    assert not np.array_equal(got[0]["idx"], got[6]["idx"])  # reshuffled
    resumed = loader(port_side)
    resumed.load_state_dict({"epoch": 1, "batch_in_epoch": 2})
    _assert_batches_equal(list(resumed), want[8:])
    assert resumed.state_dict() == {"epoch": 2, "batch_in_epoch": 0}
    assert len(resumed) == 6
    assert tdl.default_collate([{"s": "a"}, {"s": "b"}]) == \
        jdl.default_collate([{"s": "a"}, {"s": "b"}])


def test_image_caption_batches_match(tmp_path):
    path = _write(tmds, tmp_path / "mds", _samples(n=20, seed=1))
    kw = dict(remote=path, batch_size=4, resize_size=32, shuffle=True,
              num_workers=2, image_key="jpg", caption_drop_prob=0.0)
    want = _two_epochs(jic.build_streaming_image_caption_dataloader(**kw))
    got = _two_epochs(tic.build_streaming_image_caption_dataloader(**kw))
    _assert_batches_equal(got, want)
    assert got[0]["image"].shape == (4, 32, 32, 3)
    assert got[0]["captions"].shape == (4, 77)


def _laion_shards(path, n, seed, side=8, dim=32):
    """LAION columns with NCHW fp16 latents, drawn from a numpy seed."""
    rng = np.random.default_rng(seed)
    cols = {"jpg": "bytes", "caption": "str",
            f"latents_{side * 8}": "bytes", "caption_latents": "bytes"}
    lat = rng.standard_normal((n, 4, side, side)).astype(np.float16)
    cap = rng.standard_normal((n, 77, dim)).astype(np.float16)
    _write(tmds, path, [{"jpg": _jpeg(rng), "caption": f"c{i}",
                         f"latents_{side * 8}": lat[i].tobytes(),
                         "caption_latents": cap[i].tobytes()}
                        for i in range(n)], columns=cols, size_limit=1 << 14)
    return str(path), lat, cap


def test_laion_precomputed_latents_match(tmp_path):
    path, lat, cap = _laion_shards(tmp_path / "laion", 24, seed=2)
    kw = dict(remote=path, batch_size=4, resize_size=64,
              precomputed_latents=True, caption_latent_dim=32, shuffle=True,
              num_workers=2)
    want = _two_epochs(jlaion.build_streaming_laion_dataloader(**kw))
    got = _two_epochs(tlaion.build_streaming_laion_dataloader(**kw))
    _assert_batches_equal(got, want)
    assert len(got) == 12
    b = got[0]
    assert sorted(b) == ["caption_latents", "image_latents"]
    assert b["image_latents"].shape == (4, 8, 8, 4)    # NHWC delivery
    assert b["image_latents"].dtype == np.float16
    assert b["caption_latents"].shape == (4, 77, 32)
    # each row is one sample's latents, transposed from NCHW
    seen = {bytes(x.transpose(2, 0, 1).tobytes())
            for batch in got[:6] for x in batch["image_latents"]}
    assert seen == {bytes(x.tobytes()) for x in lat}


def test_laion_process_workers_match_threads(tmp_path):
    """The spawn process pool, which `worker_type="auto"` picks on a
    multi-core host without a JPEG-capable libdataio, yields what the
    thread pool yields."""
    path, _, _ = _laion_shards(tmp_path / "laion", 16, seed=4)
    kw = dict(remote=path, batch_size=4, resize_size=64,
              precomputed_latents=True, caption_latent_dim=32, shuffle=True,
              num_workers=2)
    want = list(tlaion.build_streaming_laion_dataloader(
        worker_type="thread", **kw))
    loader = tlaion.build_streaming_laion_dataloader(worker_type="process",
                                                     **kw)
    try:
        got = list(loader)
    finally:
        loader.close()
    _assert_batches_equal(got, want)


def test_coco_zero_one_range_matches(tmp_path):
    rng = np.random.default_rng(3)
    path = _write(tmds, tmp_path / "coco",
                  [{"image": _jpeg(rng, 64, 48),
                    "captions": [f"first {i}", f"second {i}"]}
                   for i in range(6)],
                  columns={"image": "bytes", "captions": "json"})
    kw = dict(remote=path, batch_size=3, resize_size=32, num_workers=1)
    want = list(jcoco.build_streaming_cocoval_dataloader(**kw))
    got = list(tcoco.build_streaming_cocoval_dataloader(**kw))
    _assert_batches_equal(got, want)
    img = got[0]["image"]
    assert img.shape == (3, 32, 32, 3)
    assert img.min() >= 0.0 and img.max() <= 1.0       # FID range, no +-1
    assert got[0]["captions"].shape == (3, 77)


def test_native_builds_the_ports_own_library(tmp_path):
    code = (
        "import json, sys\n"
        "from diffusion_torch.data import native\n"
        "info = native.build_info()\n"
        "maps = open('/proc/self/maps').read()\n"
        "print(json.dumps({'info': info, 'jpeg': "
        "native.jpeg_native_available(), 'tpu_maps': 'diffusion_tpu' in maps,"
        " 'tpu_modules': [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'diffusion_tpu')]}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.splitlines()[-1])
    assert not out["tpu_maps"] and out["tpu_modules"] == []
    if out["info"].startswith("pure Python"):
        pytest.skip(f"no native build here: {out['info']}")
    assert os.path.join("build", "diffusion_torch", "libdataio_") in out["info"]
    assert out["jpeg"] == out["info"].endswith("(with libjpeg)")
    # the library's sample table is the shard's offset table
    path = _write(tmds, tmp_path / "mds", _samples(n=5), size_limit=1 << 20)
    with open(os.path.join(path, "shard.00000.mds"), "rb") as f:
        buf = f.read()
    offsets = np.frombuffer(buf, np.uint32, 6, offset=4).astype(np.int64)
    np.testing.assert_array_equal(tnative.mds_sample_table(buf),
                                  np.stack([offsets[:-1], offsets[1:]], 1))


def test_decode_workers_import_no_torch():
    """A spawned decode worker imports the reader's module to unpickle its
    dataset; that import pulls in no torch (seconds a worker)."""
    code = ("import sys\n"
            "import diffusion_torch.data.laion, diffusion_torch.data.coco\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'diffusion_tpu')))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_native_falls_back_to_the_no_jpeg_build(tmp_path, monkeypatch):
    """A cached JPEG build that cannot load here (built where libjpeg is)
    yields to the build without it, as on a machine without libjpeg."""
    if tnative.build_info().startswith("pure Python"):
        pytest.skip("no g++ here")
    monkeypatch.setattr(tnative, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_info", "not loaded")
    with open(tnative._SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(tnative._BASE).encode()
                                ).hexdigest()[:16]
    (tmp_path / f"libdataio_{digest}_jpeg.so").write_bytes(b"not a library")
    assert tnative.native_available()
    assert tnative.build_info().endswith("_nojpeg.so (no libjpeg)")
    assert not tnative.jpeg_native_available()
    assert tnative.jpeg_decode_square(b"\xff\xd8", 8) is None
