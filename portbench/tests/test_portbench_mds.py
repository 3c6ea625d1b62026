"""The composed recipe cell (`kinds/train_mds.py`) on the CPU at the port's
tiny geometry: the unedited yaml through the loader and `build_trainer`
over MDS shards written here, a whole run (correct, and not with a fault
planted underneath), the reference's own read of the shards, and the rows
it refuses to find."""

import copy
import time

import numpy as np
import pytest
import torch

from portbench import common
from portbench.kinds import train_mds as kind
from portbench.reference.mds import read_samples
from portbench.tests.tiny import TINY_UNET

CPU = torch.device("cpu")
SEED = 2 ** 34 + 3
# fp32 on both sides at the tiny widths (as test_portbench_reference.py)
LIMITS = {"loss": 1e-5, "first_grad": 1e-3, "change": 1e-2}
# what a CPU run of the tiny model needs beside the cell's overrides
TINY = ["model._target_=diffusion_tpu.models.models.stable_diffusion_tiny",
        "model.encode_latents_in_fp16=false", "+model.device=cpu",
        "+trainer.device=cpu", "+dataset.train_dataset.caption_latent_dim=32",
        "dataset.train_dataset.num_workers=2"]


@pytest.fixture
def files(tmp_path, monkeypatch):
    files = copy.deepcopy(common.cell_files(common.benchmark(),
                                            "sd2-256-train-mds"))
    files["config"]["unet"] = dict(TINY_UNET)
    files["traffic"].update(batch_size=4, microbatch=2, samples=24,
                            reference_rows=2)
    files["check"]["limits"] = dict(LIMITS)
    monkeypatch.setattr(kind, "_shard_dir",
                        lambda traffic, config: str(tmp_path / "mds"))
    cell = kind.overrides
    monkeypatch.setattr(kind, "overrides",
                        lambda traffic, config: cell(traffic, config) + TINY)
    return files


def test_the_reference_reads_what_the_writer_wrote(files):
    t, c = files["traffic"], files["config"]
    samples = read_samples(kind.write_shards(t, c))
    assert len(samples) == 24
    assert sorted(samples[0]) == ["caption", "caption_latents", "jpg",
                                  "latents_256"]
    rng = np.random.default_rng(t["data_seed"])
    first = rng.standard_normal((4, 32, 32)).astype(np.float16)
    assert samples[0]["latents_256"] == first.tobytes()
    assert samples[5]["caption"] == b"sample 5"
    # the composed config: the yaml's reader over these shards, its
    # workers and prefetch as the cell runs them (the tiny run's aside)
    composed = kind.compose(t, c)
    train = composed["dataset"]["train_dataset"]
    assert train["remote"] == kind._shard_dir(t, c)
    assert train["prefetch_factor"] == 2 and train["precomputed_latents"]
    assert "eval_dataset" not in composed["dataset"]
    assert "logger" not in composed


def _run(files, plant=None):
    return kind.run(files, SEED, 0.5, False, CPU, time.perf_counter(),
                    plant=plant)


def test_sound_run_is_correct(files):
    out = _run(files)
    assert all(c.ok for c in out["checks"]), out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


def _unchanged(model, trainer):
    trainer.train_state.optimizer.step = lambda *a, **k: None


def _half_batch(model, trainer):
    full = model.loss_fn

    def half(mb, gen=None, *draws, **kwargs):
        n = next(iter(mb.values())).shape[0] // 2
        return full({k: v[:n] for k, v in mb.items()}, gen,
                    *(d[:n] for d in draws), **kwargs)

    model.loss_fn = half


@pytest.mark.parametrize("plant", [_unchanged, _half_batch],
                         ids=["state unchanged", "half the batch"])
def test_a_planted_fault_is_not_correct(files, plant):
    out = _run(files, plant)
    assert not all(c.ok for c in out["checks"]), out["checks"]


def test_a_row_in_no_shard_is_refused(files):
    t, c = files["traffic"], files["config"]
    kind.write_shards(t, c)
    row = {"image_latents": np.zeros((1, 32, 32, 4), np.float16),
           "caption_latents": np.zeros((1, 77, 32), np.float16)}
    with pytest.raises(RuntimeError, match="no sample"):
        kind.reference_batches(t, c, [row])
