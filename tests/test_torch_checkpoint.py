"""The port's checkpoints and autoresume.

Resume parity: the 4-batch run of `tests/test_torch_trainer.py` (grad
accumulation 2x2, clipping, EMA, a non-finite batch at index 2 that both
sides skip) is stopped by a SIGTERM after batch 3, which saves `ba3` after
the skipped step (so the optimizer's count, 2, is not the step, 3), and a
fresh `Trainer(autoresume=True)` on freshly initialised weights finishes
it. Every step must equal the port's uninterrupted run bit for bit, and
match the uninterrupted JAX run at the tolerances of
`test_torch_trainer.py` (atol 1e-6, rtol 1e-5). The batches come through a
loader with `state_dict`, whose position the checkpoint carries.

Then the counterparts of the JAX package's checkpoint tests
(`tests/test_trainer.py`): the async marker, retention, the remote mirror
and a resume from the remote alone (object store on local paths), the
bucket `save_folder` split, an interrupted overwrite, and the EMA re-seed
under `load_weights_only`; and `save_overwrite=False`, a bf16 first moment
and an upload error."""

import json
import os
import signal

import jax
import numpy as np
import pytest
import torch

from diffusion_tpu.algorithms.ema import EMA as JaxEMA
from diffusion_tpu.models.models import stable_diffusion_tiny as jax_tiny
from diffusion_tpu.parallel.mesh import create_mesh
from diffusion_tpu.train import optim as joptim
from diffusion_tpu.train.trainer import Trainer as JaxTrainer
from diffusion_torch.algorithms.ema import EMA
from diffusion_torch.models.models import stable_diffusion_tiny
from diffusion_torch.models.port_jax import unet_from_jax
from diffusion_torch.train import checkpoint as ckpt
from diffusion_torch.train import optim as toptim
from diffusion_torch.train.events import Callback
from diffusion_torch.train.state import TrainState
from diffusion_torch.train.trainer import Trainer
from diffusion_torch.utils import safetensors
from tests.test_torch_trainer import (CLIP, LR, NAN_BATCH, SEED, _batches,
                                      _jax_draws, _JaxRecorder, _Recorder,
                                      _schedule)

torch.set_num_threads(1)


class _Loader:
    """A list of batches behind the DataLoader's position contract."""

    def __init__(self, batches):
        self.batches, self.pos = batches, 0

    def __iter__(self):
        while self.pos < len(self.batches):
            self.pos += 1
            yield self.batches[self.pos - 1]
        self.pos = 0

    def state_dict(self):
        return {"pos": self.pos}

    def load_state_dict(self, d):
        self.pos = int(d["pos"])


class _Preempt(Callback):
    """Sends this process a SIGTERM at the end of batch `at`."""

    def __init__(self, at):
        self.at = at

    def batch_end(self, state, logger):
        if state.timestamp.batch == self.at:
            os.kill(os.getpid(), signal.SIGTERM)


def _trainer(model, callbacks, **kw):
    return Trainer(model=model, train_dataloader=_Loader(_batches()),
                   optimizers=toptim.adamw(lr=LR, weight_decay=0.01),
                   schedulers=_schedule(toptim),
                   algorithms=[EMA(smoothing=0.9, ema_start="0ba")],
                   callbacks=callbacks, max_duration="4ba",
                   device_train_microbatch_size=2, seed=SEED,
                   grad_clip_norm=CLIP, skip_nonfinite_updates=True,
                   device="cpu", noise_hook=_jax_draws, **kw)


def _model(initial=None):
    model = stable_diffusion_tiny(device="cpu", precomputed_latents=True)
    if initial is not None:
        model.unet.load_state_dict(initial)
    return model


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        # JAX gradients on the XLA paths (ROADMAP.md queue 3, fault 1)
        mp.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "0")
        jrec = _JaxRecorder()
        jtr = JaxTrainer(
            model=jax_tiny(precomputed_latents=True),
            train_dataloader=_batches(),
            optimizers=joptim.adamw(lr=LR, weight_decay=0.01),
            schedulers=_schedule(joptim),
            algorithms=[JaxEMA(smoothing=0.9, ema_start="0ba")],
            callbacks=[jrec], max_duration="4ba",
            device_train_microbatch_size=2, seed=SEED, image_size=64,
            grad_clip_norm=CLIP, skip_nonfinite_updates=True,
            mesh=create_mesh(fsdp=1, data=1, dcn=1,
                             devices=jax.devices()[:1]))
        initial = unet_from_jax(jax.tree.map(np.array,
                                             jtr.train_state.params))
        jtr.fit()

    whole = _Recorder()
    _trainer(_model(initial), [whole]).fit()

    folder = str(tmp_path_factory.mktemp("ckpt"))
    first = _Recorder()
    tr1 = _trainer(_model(initial), [first, _Preempt(at=3)],
                   save_folder=folder, save_interval="3ba",
                   save_num_checkpoints_to_keep=1)
    tr1.fit()
    out = {"jax": jrec.steps, "whole": whole.steps, "folder": folder,
           "stopped": (tr1.state.timestamp.batch, tr1.train_state.step,
                       tr1.train_state.optimizer.count),
           "saved": sorted(os.listdir(folder))}
    with open(os.path.join(folder, "ba3", "meta.json")) as f:
        out["meta"] = json.load(f)
    with open(os.path.join(folder, "ba3", "state", "train_state.json")) as f:
        out["train_state_json"] = json.load(f)

    # fresh weights (seed 0, not JAX's init): the restore must replace them
    second = _Recorder()
    tr2 = _trainer(_model(), [second], save_folder=folder,
                   save_interval="3ba", save_num_checkpoints_to_keep=1,
                   autoresume=True)
    ts = tr2.train_state
    out["restored"] = (tr2.state.timestamp.batch, ts.step,
                       ts.optimizer.count, tr2.train_dataloader.pos,
                       tr2._last_saved_batch,
                       tr2.ema_algorithm.ema_weights_active)
    out["same_params"] = (
        all(a is b for a, b in zip(ts.optimizer.params, ts.params.values()))
        and all(p is q for p, q in zip(ts.params.values(),
                                       tr2.model.unet.parameters())))
    out["restored_params"] = {n: p.detach().clone()
                              for n, p in ts.params.items()}
    out["restored_ema"] = {n: e.clone() for n, e in ts.ema_params.items()}
    tr2.fit()
    tr2.close()
    out["split"] = first.steps + second.steps
    out["after"] = sorted(os.listdir(folder))
    return out


def _equal_steps(got, want):
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g["metrics"]) == sorted(w["metrics"])
        np.testing.assert_array_equal(
            [g["metrics"][k] for k in sorted(w["metrics"])],
            [w["metrics"][k] for k in sorted(w["metrics"])],
            err_msg=f"step {i}")
        assert g["lr"] == w["lr"], i
        for key in ("params", "ema"):
            for name, wv in w[key].items():
                assert torch.equal(g[key][name], wv), (i, key, name)


def test_sigterm_saves_the_batch_and_stops(runs):
    """The SIGTERM after batch 3 ends fit() there with ba3 complete; the
    update count is 2 (batch 2 was skipped), the step 3."""
    assert runs["stopped"] == (3, 3, 2)
    assert runs["saved"] == ["ba3"]
    assert runs["train_state_json"] == {"step": 3, "count": 2}
    meta = runs["meta"]
    assert meta["timestamp"]["batch"] == 3 and meta["dataloader"] == {
        "pos": 3}
    assert meta["algorithms"]["EMA"] == {"ema_weights_active": True,
                                         "ema_started": True}


def test_autoresume_restores_the_live_state(runs):
    """Batch, step, count and loader position come back; the EMA weights
    are swapped out again; the optimizer and the UNet hold the same
    Parameter objects; the restored weights are batch 3's."""
    assert runs["restored"] == (3, 3, 2, 3, 3, False)
    assert runs["same_params"]
    third = runs["whole"][2]
    for name, p in runs["restored_params"].items():
        assert torch.equal(p, third["params"][name]), name
        assert torch.equal(runs["restored_ema"][name], third["ema"][name])


def test_resumed_run_equals_the_uninterrupted_one_bit_for_bit(runs):
    _equal_steps(runs["split"], runs["whole"])


def test_resumed_run_matches_jax_each_step(runs):
    """At test_torch_trainer.py's tolerances: metrics rel 1e-5, params
    and EMA atol 1e-6 + rtol 1e-5."""
    for i, (g, w) in enumerate(zip(runs["split"], runs["jax"])):
        assert g["metrics"]["trainer/nonfinite_skipped"] == \
            w["metrics"]["trainer/nonfinite_skipped"] == float(i == NAN_BATCH)
        if i != NAN_BATCH:
            for k in ("loss/train/total", "grad/global_norm"):
                assert g["metrics"][k] == pytest.approx(w["metrics"][k],
                                                        rel=1e-5), (i, k)
        for key in ("params", "ema"):
            for name, wv in w[key].items():
                np.testing.assert_allclose(g[key][name].numpy(), wv.numpy(),
                                           atol=1e-6, rtol=1e-5,
                                           err_msg=f"step {i} {key} {name}")


def test_final_save_prunes_the_older_checkpoint(runs):
    """keep=1: ba4 (the final save) is marked at fit's end, then ba3 goes."""
    assert runs["after"] == ["ba4"]
    assert os.path.exists(os.path.join(runs["folder"], "ba4", "meta.json"))


# ------------------------------------------- the checkpoint module itself


def _state(n=8, mu_dtype=None, ema=False, seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"w": torch.nn.Parameter(torch.randn(n, generator=g)),
              "b": torch.nn.Parameter(torch.randn(2, 3, generator=g))}
    opt = toptim.AdamW(params.values(), mu_dtype=mu_dtype)
    for p in params.values():
        p.grad = torch.randn(p.shape, generator=g)
    opt.step()
    return TrainState(step=5, params=params, optimizer=opt,
                      ema_params=({k: v.detach() * 2 for k, v in
                                   params.items()} if ema else None))


def _fresh_like(ts):
    fresh = _state(ts.params["w"].numel(), mu_dtype=(
        "bfloat16" if ts.optimizer.mu[0].dtype == torch.bfloat16 else None),
        ema=ts.ema_params is not None, seed=99)
    fresh.step = 0
    fresh.optimizer.count = 0
    return fresh


def _assert_restored(got, want):
    assert got.step == want.step
    assert got.optimizer.count == want.optimizer.count
    for a, b in zip(got.params.values(), want.params.values()):
        assert torch.equal(a, b)
    for key in ("mu", "nu"):
        for a, b in zip(getattr(got.optimizer, key),
                        getattr(want.optimizer, key)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    if want.ema_params is not None:
        for k in want.ema_params:
            assert torch.equal(got.ema_params[k], want.ema_params[k])


def test_async_checkpoint_marker_semantics(tmp_path):
    """wait=False returns before the marker exists; only finalize writes
    it, and every discovery and load path finalizes first. The host copy
    is taken before the call returns: a change to the live tensors after
    it does not reach the checkpoint."""
    ts = _state(ema=True)
    folder = str(tmp_path)
    saved_w = ts.params["w"].detach().clone()
    p1 = ckpt.save_checkpoint(folder, 1, ts, {"n": 1}, wait=False)
    with torch.no_grad():
        ts.params["w"].add_(1.0)             # the next step, in place
    assert not os.path.exists(os.path.join(p1, "meta.json"))
    assert ckpt.latest_checkpoint_path(folder) == p1   # finalizes
    assert os.path.exists(os.path.join(p1, "meta.json"))
    fresh = _fresh_like(ts)
    _, meta = ckpt.load_checkpoint(p1, fresh)
    assert meta == {"n": 1}
    assert torch.equal(fresh.params["w"], saved_w)

    p2 = ckpt.save_checkpoint(folder, 2, ts, {"n": 2}, wait=False)
    fresh = _fresh_like(ts)
    _, meta = ckpt.load_checkpoint(p2, fresh)          # finalizes too
    assert meta == {"n": 2}
    _assert_restored(fresh, ts)
    stats = ckpt.last_save_stats()
    assert stats["bytes"] == 4 * (8 + 6) * 4 and stats["write_s"] >= 0


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
def test_round_trip_keeps_moment_dtypes(tmp_path, mu_dtype):
    """mu comes back in its own dtype (bf16 bits through an int16 view)."""
    ts = _state(mu_dtype=mu_dtype, ema=True)
    path = ckpt.save_checkpoint(str(tmp_path), 3, ts)
    got = safetensors.load_file(os.path.join(path, "state",
                                             "optimizer.safetensors"))
    assert got["mu.w"].dtype == (torch.bfloat16 if mu_dtype
                                 else torch.float32)
    fresh = _fresh_like(ts)
    ckpt.load_checkpoint(path, fresh)
    _assert_restored(fresh, ts)


def test_prune_checkpoints_retention(tmp_path):
    """The oldest complete directories go down to the budget; the
    in-flight save counts as the newest without a wait; unmarked
    (crashed) directories are never touched; with keep=1 the newest
    complete one stays until the pending save is marked."""
    ts = _state()
    folder = str(tmp_path)
    for ba in (1, 2, 3):
        ckpt.save_checkpoint(folder, ba, ts, {"n": ba})
    os.makedirs(os.path.join(folder, "ba99", "state"))  # crashed write
    ckpt.prune_checkpoints(folder, keep=2)
    assert sorted(d for d in os.listdir(folder) if d.startswith("ba")) == [
        "ba2", "ba3", "ba99"]

    ckpt.save_checkpoint(folder, 4, ts, {"n": 4}, wait=False)
    ckpt.prune_checkpoints(folder, keep=2)
    ckpt.finalize_pending()
    assert ckpt.latest_checkpoint_path(folder).endswith("ba4")
    assert not os.path.exists(os.path.join(folder, "ba2"))
    assert os.path.exists(os.path.join(folder, "ba3", "meta.json"))

    ckpt.prune_checkpoints(folder, keep=-1)           # keep all
    assert os.path.exists(os.path.join(folder, "ba3"))

    ckpt.save_checkpoint(folder, 5, ts, {"n": 5}, wait=False)
    ckpt.prune_checkpoints(folder, keep=1)
    assert os.path.exists(os.path.join(folder, "ba4", "meta.json"))
    ckpt.finalize_pending()
    ckpt.prune_checkpoints(folder, keep=1)            # now ba4 ages out
    assert not os.path.exists(os.path.join(folder, "ba4"))
    assert os.path.exists(os.path.join(folder, "ba5", "meta.json"))


def test_interrupted_overwrite_is_not_resumed(tmp_path, monkeypatch):
    """The marker goes before the old state: a crash in between leaves a
    directory that discovery skips and a load refuses."""
    import shutil
    ts = _state()
    folder = str(tmp_path / "ckpts")
    path = ckpt.save_checkpoint(folder, 5, ts)
    assert ckpt.latest_checkpoint_path(folder) == path
    real_rmtree = shutil.rmtree

    def exploding_rmtree(p, *a, **k):
        real_rmtree(p, *a, **k)
        raise RuntimeError("simulated crash after state cleanup")

    monkeypatch.setattr(ckpt.shutil, "rmtree", exploding_rmtree)
    with pytest.raises(RuntimeError, match="simulated crash"):
        ckpt.save_checkpoint(folder, 5, ts)
    assert ckpt.latest_checkpoint_path(folder) is None
    with pytest.raises(FileNotFoundError, match="incomplete"):
        ckpt.load_checkpoint(path, _fresh_like(ts))


def test_save_overwrite_false_raises(tmp_path):
    ts = _state()
    ckpt.save_checkpoint(str(tmp_path), 2, ts)
    with pytest.raises(FileExistsError, match="save_overwrite=False"):
        ckpt.save_checkpoint(str(tmp_path), 2, ts, overwrite=False)


def test_remote_mirror_and_resume_from_it(tmp_path):
    """save_remote mirrors a finalized checkpoint, marker last; a fresh
    host with an empty folder pulls it; a current one pulls nothing."""
    local, remote = str(tmp_path / "local"), str(tmp_path / "bucket" / "r")
    ts = _state(ema=True)
    ckpt.save_checkpoint(local, 3, ts, {"n": 3}, wait=False, remote=remote)
    ckpt.finalize_pending()
    ckpt.drain_remote_uploads()
    assert os.path.exists(os.path.join(remote, "ba3", "meta.json"))
    fresh_host = str(tmp_path / "fresh_host")
    got = ckpt.sync_from_remote(fresh_host, remote)
    assert got == os.path.join(fresh_host, "ba3")
    assert ckpt.latest_checkpoint_path(fresh_host) == got
    fresh = _fresh_like(ts)
    _, meta = ckpt.load_checkpoint(got, fresh)
    assert meta == {"n": 3}
    _assert_restored(fresh, ts)
    assert ckpt.sync_from_remote(fresh_host, remote) is None


def test_upload_error_surfaces_at_the_drain(tmp_path, monkeypatch):
    ts = _state()

    def fail(self, src, uri):
        raise OSError("bucket unreachable")

    monkeypatch.setattr(ckpt.ObjectStore, "upload", fail)
    ckpt.save_checkpoint(str(tmp_path / "l"), 1, ts, remote=str(
        tmp_path / "r"))
    with pytest.raises(OSError, match="bucket unreachable"):
        ckpt.drain_remote_uploads()


def _tiny_trainer(folder, batches=2, **kw):
    model = stable_diffusion_tiny(device="cpu", precomputed_latents=True)
    return Trainer(model=model, train_dataloader=_Loader(_batches()[:2]),
                   optimizers=toptim.adamw(lr=LR), max_duration=f"{batches}ba",
                   device="cpu", save_folder=folder, **kw)


def test_bucket_save_folder_stages_locally(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)
    tr = Trainer(model=stable_diffusion_tiny(device="cpu",
                                             precomputed_latents=True),
                 device="cpu", save_folder="s3://bucket/run/ckpts",
                 run_name="bucket-split-test")
    assert tr.save_remote == "s3://bucket/run/ckpts"
    assert tr.save_folder.startswith(str(tmp_path))
    assert "bucket-split-test" in tr.save_folder


def test_trainer_resumes_from_the_remote_alone(tmp_path):
    """Train with save_remote, lose the local folder, autoresume on a new
    host: the trainer pulls the remote checkpoint."""
    remote = str(tmp_path / "bucket")
    tr = _tiny_trainer(str(tmp_path / "host_a"), save_remote=remote,
                       save_interval="2ba", autoresume=True)
    tr.fit()
    assert os.path.exists(os.path.join(remote, "ba2", "meta.json"))
    tr2 = _tiny_trainer(str(tmp_path / "host_b"), save_remote=remote,
                        save_interval="2ba", autoresume=True)
    assert tr2.state.timestamp.batch == 2 and tr2.train_state.step == 2
    for a, b in zip(tr2.train_state.params.values(),
                    tr.train_state.params.values()):
        assert torch.equal(a, b)
    tr2.fit()                          # restored at max_duration: no step,
    assert tr2._last_saved_batch == 2  # and no second save of ba2


def test_load_weights_only_reseeds_the_ema(tmp_path):
    """Parameters come over, time does not, and the EMA starts from the
    loaded weights (the checkpoint's EMA-active params)."""
    folder = str(tmp_path)
    tr = _tiny_trainer(folder, algorithms=[EMA(smoothing=0.5)],
                       save_interval="2ba")
    tr.fit()
    tr2 = Trainer(model=stable_diffusion_tiny(device="cpu",
                                              precomputed_latents=True),
                  optimizers=toptim.adamw(lr=LR), device="cpu",
                  algorithms=[EMA(smoothing=0.5)],
                  load_path=os.path.join(folder, "ba2"),
                  load_weights_only=True)
    assert tr2.state.timestamp.batch == 0 and tr2.train_state.step == 0
    for name, p in tr2.train_state.params.items():
        assert torch.equal(p, tr.train_state.ema_params[name])
        assert torch.equal(tr2.train_state.ema_params[name], p)
