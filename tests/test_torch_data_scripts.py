"""The port's data-preparation scripts against the JAX package's, on the
CPU: `diffusion_torch.scripts.convert_coco` over a COCO captions json and
its JPEGs, and `diffusion_torch.scripts.laion_cloudwriter` over
img2dataset parquet files with their `*_stats.json` sidecars, write shards
byte-identical to `scripts/convert_coco.py`'s and
`scripts/laion_cloudwriter.py`'s."""

import io
import json
import os
import shutil
import sys

import numpy as np
import pytest
from PIL import Image

from diffusion_torch.scripts import convert_coco as tcoco
from diffusion_torch.scripts import laion_cloudwriter as tcloud


def _jpeg(rng, w, h) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(
        buf, format="JPEG")
    return buf.getvalue()


def _tree(root):
    """Every file under `root` by relative path -> its bytes."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _run_jax(monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", [module.__file__, *argv])
    module.main()


@pytest.fixture
def coco(tmp_path):
    """A captions json over 12 images (one missing on disk, several
    captions for some) and their JPEGs."""
    rng = np.random.default_rng(0)
    images = tmp_path / "val2014"
    os.makedirs(images)
    anns = {"images": [], "annotations": []}
    for i in range(12):
        name = f"COCO_val2014_{i:012d}.jpg"
        anns["images"].append({"id": 100 + i, "file_name": name})
        for j in range(1 + i % 3):
            anns["annotations"].append({"image_id": 100 + i, "id": 10 * i + j,
                                        "caption": f"caption {j} of {i}"})
        if i != 5:
            with open(images / name, "wb") as f:
                f.write(_jpeg(rng, 40 + 4 * i, 32))
    with open(tmp_path / "captions_val2014.json", "w") as f:
        json.dump(anns, f)
    return str(tmp_path / "captions_val2014.json"), str(images)


@pytest.mark.parametrize("num", [8, 10_000])
def test_convert_coco_shards_match_jax(coco, tmp_path, monkeypatch, num):
    from scripts import convert_coco as jcoco
    annotations, images = coco
    argv = ["--annotations", annotations, "--image-dir", images,
            "--num-samples", str(num), "--seed", "42"]
    _run_jax(monkeypatch, jcoco, argv + ["--out", str(tmp_path / "jax")])
    written = tcoco.main(argv + ["--out", str(tmp_path / "port")])
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(got) == sorted(want) and "index.json" in got
    assert got == want
    index = json.loads(got["index.json"])
    assert written == sum(s["samples"] for s in index["shards"])
    if num > 12:            # every image but the missing one
        assert written == 11


def _write_parquets(root, rng):
    """Three img2dataset parquet shards (rows of several sizes, one row
    without an image, one undecodable), two marked complete by their
    stats sidecar."""
    pa = pytest.importorskip("pyarrow")
    pq = pytest.importorskip("pyarrow.parquet")
    sides = ((48, 40), (80, 64), (160, 130), (300, 260), (600, 520),
             (800, 790), (1100, 1030), (40, 1200))
    os.makedirs(root)
    for shard in range(3):
        rows = []
        for i, (w, h) in enumerate(sides):
            key = f"{shard:05d}{i:04d}"
            rows.append({
                "jpg": _jpeg(rng, w, h), "caption": f"a photo {key}",
                "url": f"http://example.invalid/{key}.jpg", "key": key,
                "original_width": w * 2, "original_height": h * 2,
                "status": "success", "error_message": None,
                "exif": "{}", "similarity": 0.31, "punsafe": 0.01 * i,
                "pwatermark": 0.2, "AESTHETIC_SCORE": 5.5, "hash": i})
        rows.append({**rows[0], "jpg": None, "key": "noimage"})
        rows.append({**rows[1], "jpg": b"not a jpeg", "key": "corrupt"})
        pq.write_table(pa.Table.from_pylist(rows),
                       os.path.join(root, f"{shard:05d}.parquet"))
        if shard < 2:
            with open(os.path.join(root, f"{shard:05d}_stats.json"), "w") as f:
                json.dump({"count": len(rows)}, f)


@pytest.mark.parametrize("remove", [False, True])
def test_cloudwriter_shards_match_jax(tmp_path, monkeypatch, remove):
    from scripts import laion_cloudwriter as jcloud
    rng = np.random.default_rng(1)
    _write_parquets(tmp_path / "download", rng)
    for side in ("jax", "port"):
        shutil.copytree(tmp_path / "download", tmp_path / f"dl_{side}")
    common = ["--one-shot", "--decode-workers", "3", "--flush-every", "1"] + (
        ["--remove-consumed"] if remove else [])
    _run_jax(monkeypatch, jcloud, common + [
        "--download-dir", str(tmp_path / "dl_jax"),
        "--out", str(tmp_path / "jax")])
    tcloud.main(common + ["--download-dir", str(tmp_path / "dl_port"),
                          "--out", str(tmp_path / "port")])
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(got) == sorted(want)
    assert got == want
    # the buckets the sides route to, one writer per bucket
    buckets = sorted({p.split(os.sep)[0] for p in got})
    assert buckets == sorted(f"bucket_{b}" for b in tcloud.BUCKETS)
    assert sum(p.endswith(".mds") for p in got) >= 6
    # the uncompleted shard stays; the completed ones go with
    # --remove-consumed, on both sides
    assert sorted(os.listdir(tmp_path / "dl_port")) == sorted(
        os.listdir(tmp_path / "dl_jax")) == (
            ["00002.parquet"] if remove else sorted(
                os.listdir(tmp_path / "download")))


def test_cloudwriter_buckets_match_jax():
    from scripts import laion_cloudwriter as jcloud
    assert tcloud.BUCKETS == jcloud.BUCKETS
    assert tcloud.COLUMNS == jcloud.COLUMNS
    for w, h in ((0, 10), (63, 400), (64, 64), (511, 900), (512, 512),
                 (2000, 1500), (None, 30)):
        assert tcloud.bucket_of(w, h) == jcloud.bucket_of(w, h)
