"""The port's Trainer on a process mesh of gloo ranks on the CPU against the
one-rank port run on the same global batches, and against the JAX Trainer
on the same (data 2, sp 2) and (data 2, tp 2) meshes of virtual devices
(tiny model, 16x16 latents, AdamW, EMA 0.9, 2 steps of 8 examples).

Two spawns: 2 ranks for (fsdp 2); 4 ranks for (data 2, sp 2), (fsdp 2,
sp 2), (fsdp 2, tp 2), (sp 2, tp 2) and (data 2, tp 2) (each also
evaluates two batches of 4 across its ranks, against the one-rank eval),
a (data 2, sp 2) run with JAX's draws that also saves, a (data 2, tp 2)
run with the draws of JAX's tp run, a restore of a one-rank checkpoint on
the mesh, an (fsdp 2, data 2) run that rank 0 alone flags for
preemption, and `yamls/SD-2-base-1024-sp.yaml` and
`yamls/SD-2-base-512-tp.yaml` composed with dotted overrides (tiny model,
(data 2, sp 2) and (data 2, tp 2), one step each) through
`diffusion_torch.run.main`. The sp runs split the UNet's rows over 2
ranks at both levels and run the level-0 self-attention (256 tokens) as a
ring (`sequence_parallel_min_seq` 256), the level-1 one (64) by gathering
K/V. The tp runs split the 2-head and 4-head attention layers and the
GEGLUs over 2 ranks (Megatron), and their tp groups hold the whole
(unsliced) parameters, moments and EMA bit-equal; (fsdp 2, tp 2) saves a
checkpoint that one rank resumes.

Tolerances: losses and gradient norms rel 1e-5; each step's gradients
within 1e-5 (1e-3 rel against JAX, the train-step test's bound); the
parameters and the EMA within the AdamW bound that the step's gradients'
differences imply (`test_torch_ranks.adam_bound`, derived in
test_torch_lora.py's `test_adapter_steps_match_jax`): Adam's update turns
roundoff in gradients near eps into a sizeable part of lr, so a fixed
tolerance on the parameters would hold the optimizer's sensitivity, not
the mesh, to account. Checkpoints move between the mesh and one rank bit
for bit."""

import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import test_torch_ranks as torch_ranks
from diffusion_tpu.algorithms.ema import EMA as JaxEMA
from diffusion_tpu.models.models import stable_diffusion_tiny as jax_tiny
from diffusion_tpu.parallel.mesh import create_mesh as jax_create_mesh
from diffusion_tpu.train import optim as joptim
from diffusion_tpu.train.events import Callback as JaxCallback
from diffusion_tpu.train.trainer import Trainer as JaxTrainer
from diffusion_torch.data.mds import MDSWriter
from diffusion_torch.models.port_jax import unet_from_jax
from diffusion_torch.parallel.mesh import mesh_sizes

torch.set_num_threads(1)

SEED = 7
SP = {"sequence_parallel_min_seq": 256}


def _eval_batches():
    rng = np.random.default_rng(1)
    return [{"image_latents": torch.from_numpy(rng.standard_normal(
                (4, 16, 16, 4)).astype(np.float32)),
             "caption_latents": torch.from_numpy(rng.standard_normal(
                 (4, 8, 32)).astype(np.float32))} for _ in range(2)]


EVAL = {"eval_dataloader": _eval_batches()}


def _batches():
    rng = np.random.default_rng(0)
    return [{"image_latents": torch.from_numpy(rng.standard_normal(
                (8, 16, 16, 4)).astype(np.float32)),
             "caption_latents": torch.from_numpy(rng.standard_normal(
                 (8, 8, 32)).astype(np.float32))} for _ in range(2)]


class _JaxRecorder(JaxCallback):
    def __init__(self):
        self.steps, self.trees = [], []

    def batch_end(self, state, logger):
        self.steps.append({k: float(np.asarray(v))
                           for k, v in state.metrics.items()})
        self.trees.append((jax.tree.map(np.array, state.train_state.params),
                           jax.tree.map(np.array,
                                        state.train_state.ema_params)))


def _jax_run(batches, mesh, micro, n_accum, m):
    """The JAX Trainer on `mesh` ((data 2, sp 2) or (data 2, tp 2)) of 4
    virtual devices, `micro` examples a device, so `n_accum` microbatches
    of `m`; its draws and each step's gradient at its own parameters."""
    jrec = _JaxRecorder()
    model = jax_tiny(precomputed_latents=True)
    jtr = JaxTrainer(
        model=model, train_dataloader=[{k: v.numpy() for k, v in b.items()}
                                       for b in batches],
        optimizers=joptim.adamw(lr=torch_ranks.LR, weight_decay=0.01),
        algorithms=[JaxEMA(smoothing=0.9, ema_start="0ba")],
        callbacks=[jrec], max_duration="2ba",
        device_train_microbatch_size=micro,
        seed=SEED, image_size=128, sequence_parallel_min_seq=256,
        mesh=jax_create_mesh(fsdp=1, devices=jax.devices()[:4], **mesh))
    initial = jax.tree.map(np.array, jtr.train_state.params)
    jtr.fit()
    grad_fn = jax.jit(jax.grad(model.loss_fn))
    draws, grads = [], []
    for step, (params, batch) in enumerate(
            zip([initial] + [t[0] for t in jrec.trees[:-1]], batches)):
        rngs = jax.random.split(jax.random.fold_in(jax.random.key(SEED),
                                                   step), n_accum)
        step_draws, total = [], None
        for i in range(n_accum):
            _, r_t, r_noise = jax.random.split(rngs[i], 3)
            step_draws.append((
                np.array(jax.random.normal(r_noise, (m, 16, 16, 4),
                                           jnp.float32)),
                np.array(jax.random.randint(r_t, (m,), 0, 1000))))
            mb = {k: jnp.asarray(v[i * m:(i + 1) * m].numpy())
                  for k, v in batch.items()}
            g = grad_fn(params, {}, mb, rngs[i])
            total = g if total is None else jax.tree.map(jnp.add, total, g)
        draws.append(step_draws)
        grads.append(unet_from_jax(jax.tree.map(
            lambda x: np.array(x / n_accum), total)))
    return {"initial": unet_from_jax(initial), "draws": draws,
            "grads": grads, "metrics": jrec.steps,
            "params": unet_from_jax(jrec.trees[-1][0]),
            "ema": unet_from_jax(jrec.trees[-1][1])}


def _image_data(root):
    rng = np.random.default_rng(3)
    with MDSWriter(str(root / "train"), {"image": "bytes",
                                         "caption": "str"}) as w:
        for i in range(16):
            buf = io.BytesIO()
            Image.fromarray(rng.integers(0, 255, (64, 64, 3), np.uint8)).save(
                buf, format="JPEG")
            w.write({"image": buf.getvalue(), "caption": f"a photo {i}"})
    with MDSWriter(str(root / "coco"), {"image": "bytes",
                                        "captions": "json"}) as w:
        for i in range(4):
            buf = io.BytesIO()
            Image.fromarray(rng.integers(0, 255, (64, 64, 3), np.uint8)).save(
                buf, format="JPEG")
            w.write({"image": buf.getvalue(), "captions": [f"c {i}"]})


def _latent_data(root):
    """LAION-style precomputed latents at 64px (8x8) with 77x32 caption
    latents, for the 512-tp yaml's reader."""
    rng = np.random.default_rng(4)
    with MDSWriter(str(root / "latents"), {
            "caption": "str", "caption_latents": "bytes",
            "latents_64": "bytes"}) as w:
        for i in range(8):
            w.write({"caption": f"c{i}",
                     "caption_latents": rng.standard_normal(
                         (77, 32)).astype(np.float16).tobytes(),
                     "latents_64": rng.standard_normal((4, 8, 8)).astype(
                         np.float16).tobytes()})


def _tp_yaml_overrides(root):
    """`yamls/SD-2-base-512-tp.yaml`, unedited, cut to the tiny model on a
    (data 2, tp 2) gloo mesh (fsdp inferred 1): batch 4 in microbatches of
    1 a rank, one batch over 64px latents, no eval; remat on, so the
    rematerialized blocks run their tp ops again in the backward."""
    return [
        "model._target_=diffusion_tpu.models.models.stable_diffusion_tiny",
        "+model.device=cpu", "+trainer.device=cpu", "~logger",
        "+model.remat=true",
        "batch_size=4", "trainer.device_train_microbatch_size=1",
        "trainer.max_duration=1ba", "trainer.mesh_config.data=2",
        f"dataset.train_dataset.remote={root}/latents",
        f"dataset.train_dataset.local={root}/latents",
        "dataset.train_dataset.resize_size=64",
        "+dataset.train_dataset.caption_latent_dim=32",
        "dataset.train_dataset.num_workers=0",
        "dataset.train_dataset.persistent_workers=false",
        "~dataset.eval_dataset"]


def _yaml_overrides(root):
    """`yamls/SD-2-base-1024-sp.yaml`, unedited, cut to the tiny model on a
    (data 2, sp 2) gloo mesh: batch 4 in microbatches of 1 a rank, one
    batch, 64px images."""
    return [
        "model._target_=diffusion_tpu.models.models.stable_diffusion_tiny",
        "+model.device=cpu", "+trainer.device=cpu", "~logger",
        "batch_size=4", "trainer.device_train_microbatch_size=1",
        "trainer.max_duration=1ba", "trainer.mesh_config.data=2",
        "trainer.mesh_config.sp=2", "trainer.sequence_parallel_min_seq=64",
        f"dataset.train_dataset.remote={root}/train",
        "dataset.train_dataset.resize_size=64",
        "dataset.train_dataset.num_workers=0",
        "dataset.train_dataset.persistent_workers=false",
        f"dataset.eval_dataset.remote={root}/coco",
        "dataset.eval_dataset.resize_size=64",
        "dataset.eval_dataset.num_workers=0",
        "dataset.eval_dataset.persistent_workers=false"]


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        # JAX gradients on the XLA paths (ROADMAP.md queue 3, fault 1)
        mp.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "0")
        # (data 2, sp 2): ceil(8 / (1 x 4 devices)) microbatches of 4;
        # (data 2, tp 2) at 2 a device: tp ranks hold whole rows, so
        # ceil(8 / (2 x 2)) microbatches of 4
        jax_run = _jax_run(_batches(), {"data": 2, "sp": 2}, 1, 2, 4)
        jax_tp = _jax_run(_batches(), {"data": 2, "tp": 2}, 2, 2, 4)
    initial, batches = jax_run["initial"], _batches()
    tmp = tmp_path_factory.mktemp("mesh")
    ref = {}
    for n_dev in (2, 4):   # the mesh's microbatches: 1 example a rank
        kw = {"save_folder": str(tmp / "one")} if n_dev == 4 else {}
        tr, rec = torch_ranks.make_trainer(batches, initial, n_dev,
                                           max_duration="2ba", **kw, **EVAL)
        tr.fit()
        ref[n_dev] = {"state": torch_ranks.full_state(tr),
                      "metrics": rec.steps, "grads": rec.grads,
                      "nu": rec.nu, "eval": tr.eval()}
        tr.close()
    two = torch_ranks.spawn(
        torch_ranks.mesh_case, 2, tmp / "two",
        [("fsdp2", {"fsdp": 2}, batches, 4, initial, 1, None, EVAL, None)],
        timeout=240)[0]
    _image_data(tmp)
    runs = [("dp_sp", {"fsdp": 1, "data": 2, "sp": 2}, batches, 2, initial,
             1, None, dict(SP, **EVAL), None),
            ("fsdp_sp", {"fsdp": 2, "data": 1, "sp": 2}, batches, 2,
             initial, 1, None, dict(SP, **EVAL), None),
            ("dp_sp_jax", {"fsdp": 1, "data": 2, "sp": 2}, batches, 2,
             initial, 1, jax_run["draws"],
             dict(SP, save_folder=str(tmp / "mesh_ckpt")), None),
            ("load_one", {"fsdp": 2, "data": 1, "sp": 2}, batches, 2,
             initial, 1, None, SP, str(tmp / "one" / "ba2")),
            ("preempt", {"fsdp": 2, "data": 2}, batches * 2, 2, initial, 1,
             None, {"save_folder": str(tmp / "preempt"), "preempt_at": 1,
                    "preempt_sync_interval": 1}, None),
            # tp: 2 examples a rank, so 2 microbatches of 4 (the one-rank
            # run of 4 a microbatch)
            ("fsdp_tp", {"fsdp": 2, "data": 1, "tp": 2}, batches, 2,
             initial, 2, None, dict(EVAL, save_folder=str(tmp / "tp_ckpt")),
             None),
            ("sp_tp", {"fsdp": 1, "data": 1, "sp": 2, "tp": 2}, batches, 2,
             initial, 2, None, dict(SP, **EVAL), None),
            ("dp_tp", {"fsdp": 1, "data": 2, "tp": 2}, batches, 2, initial,
             2, None, EVAL, None),
            ("dp_tp_jax", {"fsdp": 1, "data": 2, "tp": 2}, batches, 2,
             jax_tp["initial"], 2, jax_tp["draws"], {}, None)]
    _latent_data(tmp)
    yamls = [("yaml", "SD-2-base-1024-sp.yaml", _yaml_overrides(tmp)),
             ("tp_yaml", "SD-2-base-512-tp.yaml", _tp_yaml_overrides(tmp))]
    four = torch_ranks.spawn(torch_ranks.mesh_case, 4, tmp / "four", runs,
                             yamls, timeout=300)[0]
    return {"ref": ref, "jax": jax_run, "jax_tp": jax_tp, **two, **four,
            "tmp": tmp, "initial": initial}


def _check_state(got, want, got_grads, want_grads, nus, grad_rtol=1e-5,
                 slack=0.0):
    """Each step's gradients, then the parameters and the EMA within the
    AdamW bound those gradients' differences imply."""
    for g, w in zip(got_grads, want_grads):
        scale = max(float(v.abs().max()) for v in w.values())
        for name, wv in w.items():
            np.testing.assert_allclose(g[name].numpy(), np.asarray(wv),
                                       atol=1e-5 * scale, rtol=grad_rtol,
                                       err_msg=name)
    bound = torch_ranks.adam_bound(
        got_grads, [{k: torch.as_tensor(v) for k, v in w.items()}
                    for w in want_grads], nus, slack=slack)[-1]
    for key in ("params", "ema"):
        for name, wv in want[key].items():
            wv = torch.as_tensor(wv)
            ulp = torch.from_numpy(4 * np.spacing(np.abs(wv.numpy())))
            excess = ((got[key][name] - wv).abs().double() - bound[name]
                      - ulp.double())
            assert float(excess.max()) <= 0, (key, name,
                                              float(excess.max()))


@pytest.mark.parametrize("name,n_dev", [("fsdp2", 2), ("dp_sp", 4),
                                        ("fsdp_sp", 4), ("fsdp_tp", 4),
                                        ("sp_tp", 4), ("dp_tp", 4)])
def test_mesh_steps_match_one_rank(mesh_runs, name, n_dev):
    got, ref = mesh_runs[name], mesh_runs["ref"][n_dev]
    assert len(got["metrics"]) == len(ref["metrics"]) == 2
    for g, w in zip(got["metrics"], ref["metrics"]):
        for k in ("loss/train/total", "grad/global_norm"):
            assert g[k] == pytest.approx(w[k], rel=1e-5), k
    _check_state(got["state"], ref["state"], got["grads"], ref["grads"],
                 got["nu"])
    assert got["state"]["step"] == 2 and got["state"]["count"] == 2
    # a tp group's whole parameters, moments and EMA stay bit-equal
    assert got["tp_replicas_differ"] == ([] if "tp" in name else None)
    # the eval over the ranks (each its block of the eval batches; an sp
    # rank its rows of them) against the one-rank eval of the whole
    # batches, with the EMA swapped in on both sides
    assert sorted(got["eval"]) == sorted(ref["eval"]) == [
        "metrics/eval/MeanSquaredError",
        "metrics/eval/MeanSquaredError/bin-0-1"]
    for k, v in ref["eval"].items():
        assert got["eval"][k] == pytest.approx(v, rel=1e-5), k


def test_dp_sp_mesh_matches_jax_trainer(mesh_runs):
    """The (data 2, sp 2) mesh with JAX's draws against the JAX Trainer on
    (data 2, sp 2) virtual devices: the ring, the halo convolutions and
    the merged GroupNorm against XLA's partitioning of the same step."""
    got, want = mesh_runs["dp_sp_jax"], mesh_runs["jax"]
    for g, w in zip(got["metrics"], want["metrics"]):
        for k in ("loss/train/total", "grad/global_norm"):
            assert g[k] == pytest.approx(w[k], rel=1e-5), k
    # JAX's gradients here are recomputed on one device at its step's
    # parameters; its mesh step summed them in another order: 16 roundings
    # (2^-20) of each tensor's largest gradient on top
    _check_state(got["state"], want, got["grads"], want["grads"], got["nu"],
                 grad_rtol=1e-3, slack=2.0 ** -20)


def test_dp_tp_mesh_matches_jax_trainer(mesh_runs):
    """The (data 2, tp 2) mesh with JAX's draws against the JAX Trainer on
    (data 2, tp 2) virtual devices: the Megatron slices, tp_copy and
    tp_reduce against XLA's partitioning of JAX's parameter specs and its
    head-sharded attention (`_tp_dispatch`), JAX's bound as the sp
    mesh's."""
    got, want = mesh_runs["dp_tp_jax"], mesh_runs["jax_tp"]
    for g, w in zip(got["metrics"], want["metrics"]):
        for k in ("loss/train/total", "grad/global_norm"):
            assert g[k] == pytest.approx(w[k], rel=1e-5), k
    _check_state(got["state"], want, got["grads"], want["grads"], got["nu"],
                 grad_rtol=1e-3, slack=2.0 ** -20)
    assert got["state"]["step"] == 2 and got["state"]["count"] == 2
    assert got["tp_replicas_differ"] == []


def _same(a, b):
    for key in ("params", "ema"):
        assert sorted(a[key]) == sorted(b[key])
        for name in a[key]:
            assert torch.equal(a[key][name], b[key][name]), (key, name)
    for key in ("mu", "nu"):
        for x, y in zip(a[key], b[key]):
            assert torch.equal(x, y), key
    assert (a["count"], a["step"]) == (b["count"], b["step"])


def test_mesh_checkpoint_resumes_on_one_rank(mesh_runs):
    """The mesh's save (rank 0 writes the gathered state) restores into a
    one-rank Trainer bit for bit."""
    tr, _ = torch_ranks.make_trainer(
        _batches(), mesh_runs["initial"], 4, max_duration="3ba",
        save_folder=str(mesh_runs["tmp"] / "mesh_ckpt"), autoresume=True)
    try:
        _same(torch_ranks.full_state(tr), mesh_runs["dp_sp_jax"]["state"])
    finally:
        tr.close()


def test_tp_checkpoint_resumes_on_one_rank(mesh_runs):
    """The (fsdp 2, tp 2) run's save (the FSDP shards and the tp slices
    gathered, the GEGLU's value and gate rows back in place) restores into
    a one-rank Trainer bit for bit."""
    tr, _ = torch_ranks.make_trainer(
        _batches(), mesh_runs["initial"], 4, max_duration="3ba",
        save_folder=str(mesh_runs["tmp"] / "tp_ckpt"), autoresume=True)
    try:
        _same(torch_ranks.full_state(tr), mesh_runs["fsdp_tp"]["state"])
    finally:
        tr.close()


def test_one_rank_checkpoint_resumes_on_the_mesh(mesh_runs):
    """A one-rank checkpoint restored on an (fsdp 2, sp 2) mesh: each rank
    keeps its shards, which gather to the saved state bit for bit."""
    _same(mesh_runs["load_one"]["state"], mesh_runs["ref"][4]["state"])


def test_sigterm_on_one_rank_stops_every_rank_at_one_batch(mesh_runs):
    """Rank 0 alone flags a preemption after batch 1 (of 4): the ranks agree
    by an all-reduce of the flag (every batch here) and all stop there,
    where rank 0 writes the checkpoint of batch 1."""
    out = mesh_runs["preempt"]
    assert out["batch"] == 1 and out["state"]["step"] == 1
    saved = sorted(os.listdir(mesh_runs["tmp"] / "preempt"))
    assert saved == ["ba1"]


def test_1024_sp_yaml_trains_on_a_gloo_mesh(mesh_runs):
    out = mesh_runs["yaml"]
    assert out["batch"] == 1 and out["shards"] and out["remat"]
    # (dcn, fsdp, data, sp, tp): fsdp inferred from 4 ranks
    assert out["mesh"] == [1, 1, 2, 2, 1]
    assert np.isfinite(out["metrics"]["loss/train/total"])
    # the level-0 self-attention (8x8 latents, 64 tokens) ran as a ring of
    # 2 shards of 32 tokens, once a microbatch, remat keeping it
    assert out["ring_calls"] and all(s[1] == 32 for s in out["ring_calls"])


def test_512_tp_yaml_trains_on_a_gloo_mesh(mesh_runs):
    """`yamls/SD-2-base-512-tp.yaml` through `diffusion_torch.run.main` on
    (data 2, tp 2), remat on: the yaml's tp 2; each rank holds its tp
    slices of the 2-head and 4-head stages' attention and of the GEGLUs."""
    out = mesh_runs["tp_yaml"]
    assert out["batch"] == 1 and out["shards"] and out["remat"]
    assert out["mesh"] == [1, 1, 2, 1, 2]
    assert out["tp_replicas_differ"] == []
    assert np.isfinite(out["metrics"]["loss/train/total"])
    # 4 Transformer2Ds (down, mid, 2 up): 8 attention layers, 4 GEGLUs
    assert out["tp_layers"] == {"Attention": 8, "FeedForwardGEGLU": 4}
    # attention ran head-sharded: 1 of level 0's 2 heads, 2 of the mid
    # block's 4 a rank
    assert out["attn_heads"] == {1, 2}


@pytest.mark.parametrize("config", [
    {}, {"fsdp": 2, "data": -1}, {"fsdp": -1, "data": 2, "sp": 2},
    {"dcn": 2, "fsdp": 2, "data": 1, "sp": -1}, {"fsdp": 8},
    {"fsdp": -1, "data": -1}, {"fsdp": 3, "data": -1},
    {"fsdp": -1, "tp": 2}, {"data": 2, "tp": 4},
    {"sp": 2, "tp": 2, "data": 2}, {"fsdp": -1, "tp": 3}])
def test_mesh_sizes_match_jax(config):
    """Inference of the -1 axis and the errors, against JAX's create_mesh
    on the 8 virtual devices."""
    try:
        want = dict(jax_create_mesh(**config).shape)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(" ")[0]):
            mesh_sizes(8, **config)
        return
    assert mesh_sizes(8, **config) == want

