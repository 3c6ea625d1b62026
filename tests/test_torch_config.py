"""The port's config loader against the JAX package's: every yaml under
`yamls/` loads to the same dict on both sides (with and without dotted
overrides), both match PyYAML's `safe_load` where no interpolation applies,
and a `diffusion_tpu.` `_target_` instantiates the port's object."""

import glob
import os

import pytest
import yaml

from diffusion_tpu.config import loader as jloader
from diffusion_torch.algorithms.low_precision import LowPrecisionGroupNorm
from diffusion_torch.callbacks.monitors import LRMonitor, SpeedMonitor
from diffusion_torch.config import loader as tloader
from diffusion_torch.utils.logging import WandBLogger

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
YAMLS = sorted(glob.glob(os.path.join(ROOT, "yamls", "**", "*.yaml"),
                         recursive=True))
# what the port composes so far (ROADMAP.md queue 1 items 1-3, 6 and 11);
# the other targets' modules come with later items
PORTED = {"algorithms.ema", "algorithms.low_precision", "callbacks.monitors",
          "data.coco", "data.image_caption", "data.laion", "data.mix",
          "data.pexels", "data.wds", "models.models", "train.optim",
          "utils.logging"}


def _targets(node):
    if isinstance(node, dict):
        for k, v in node.items():
            if k == "_target_":
                yield v
            else:
                yield from _targets(v)
    elif isinstance(node, list):
        for v in node:
            yield from _targets(v)


def test_every_yaml_is_seen():
    assert len(YAMLS) == 13
    assert any(p.endswith(os.path.join("mosaic", "SD-2-base-256.yaml"))
               for p in YAMLS)


@pytest.mark.parametrize("path", YAMLS,
                         ids=[os.path.relpath(p, ROOT) for p in YAMLS])
def test_yaml_loads_the_same_on_both_sides(path):
    want = jloader.load_config(path)
    got = tloader.load_config(path)
    assert got == want
    # the file as PyYAML reads it, before interpolation
    with open(path) as f:
        raw = yaml.safe_load(f)
    if "parameters" in raw and "model" in raw["parameters"]:
        raw = raw["parameters"]
    assert sorted(got) == sorted(raw)
    # the targets resolve to the port's module of the same name
    for target in _targets(got):
        assert target.startswith("diffusion_tpu.")
        module = target[len("diffusion_tpu."):].rpartition(".")[0]
        if module in PORTED:
            obj = tloader._import_target(target)
            assert obj.__module__ == f"diffusion_torch.{module}"
        else:
            with pytest.raises(ImportError):
                tloader._import_target(target)


def test_overrides_and_interpolation_match():
    path = os.path.join(ROOT, "yamls", "SD-2-base-256.yaml")
    overrides = ["batch_size=32", "trainer.max_duration=6ba",
                 "+dataset.eval_dataset.precomputed_latents=true",
                 "~logger.wandb", "dataset.train_dataset.remote=/x",
                 "trainer.fsdp_config.sharding_strategy=NO_SHARD"]
    want = jloader.load_config(path, overrides)
    got = tloader.load_config(path, overrides)
    assert got == want
    assert got["dataset"]["train_batch_size"] == 32
    assert got["dataset"]["train_dataset"]["batch_size"] == 32
    assert tloader.select(got, "trainer.max_duration") == "6ba"
    assert got["logger"] == {}
    for bad in (["nope.key=1"], ["logger.wandb.x.y=1"]):
        with pytest.raises(KeyError):
            jloader.load_config(path, bad)
        with pytest.raises(KeyError):
            tloader.load_config(path, bad)
    text = "a: 1\nb: ${a}\nc: x${a}y\n"
    assert tloader.loads_config(text) == jloader.loads_config(text) == {
        "a": 1, "b": 1, "c": "x1y"}
    assert tloader.to_yaml(got) == jloader.to_yaml(want)


def test_jax_target_instantiates_the_port():
    assert isinstance(tloader.instantiate(
        {"_target_": "diffusion_tpu.callbacks.monitors.LRMonitor"}), LRMonitor)
    sm = tloader.instantiate({
        "_target_": "diffusion_tpu.callbacks.monitors.SpeedMonitor",
        "window_size": 3})
    assert isinstance(sm, SpeedMonitor) and sm.window.maxlen == 3
    lp = tloader.instantiate({
        "_target_": "diffusion_tpu.algorithms.low_precision."
                    "LowPrecisionGroupNorm", "attribute": "unet"})
    assert isinstance(lp, LowPrecisionGroupNorm)
    partial = tloader.instantiate({
        "_target_": "diffusion_tpu.utils.logging.WandBLogger",
        "_partial_": True})
    assert partial.func is WandBLogger
    # a target outside both packages resolves as written
    assert tloader._import_target("os.path.join") is os.path.join
