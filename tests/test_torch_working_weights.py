"""The training step's bf16 working copies (`diffusion_torch/ops/
working_copy.py`) on the CPU, where `copy_` and `add_` stand in for the
kernels: a tiny UNet and a tiny MMDiT computing in bf16, one `Trainer`
step at 1, 2 and 4 microbatches, with and without the EMA, against the
same step with the per-call cast (the scope swapped for a null context):
the loss, every `.grad` before the update and the updated weights bit for
bit. Also the eval forward after a step, the parameters that keep the
per-call cast (frozen, hooked, a sharded gloo step) and the counters that
show it, and the state_dict and checkpoint, which never see the copies.

    python -m pytest tests/test_torch_working_weights.py -q -p no:randomly
"""

import contextlib
import os

import numpy as np
import pytest
import torch

from diffusion_torch.algorithms.ema import EMA
from diffusion_torch.models.models import (stable_diffusion_3,
                                           stable_diffusion_tiny)
from diffusion_torch.models.stable_diffusion_3 import POOLED
from diffusion_torch.ops import working_copy as wc
from diffusion_torch.train.events import Callback
from diffusion_torch.train.optim import adamw
from diffusion_torch.train.trainer import Trainer
from diffusion_torch.utils.safetensors import load_file

torch.set_num_threads(1)

# 2 blocks of width 64 in 1 head of 64; 8x8 latents in 2x2 patches and 6
# text tokens
_MMDIT = {"sample_size": 8, "patch_size": 2, "in_channels": 4,
          "out_channels": 4, "num_layers": 2, "attention_head_dim": 64,
          "num_attention_heads": 1, "joint_attention_dim": 16,
          "caption_projection_dim": 64, "pooled_projection_dim": 12,
          "pos_embed_max_size": 8}
_BATCH = 4


def _model(net, **kw):
    if net == "unet":
        model = stable_diffusion_tiny(device="cpu", precomputed_latents=True,
                                      **kw)
        model.unet.dtype = torch.bfloat16
        return model
    return stable_diffusion_3(_MMDIT, device="cpu")


def _batch(net, seed=0):
    rng = np.random.default_rng(seed)
    if net == "unet":
        shapes = {"image_latents": (_BATCH, 8, 8, 4),
                  "caption_latents": (_BATCH, 8, 32)}
    else:
        shapes = {"image_latents": (_BATCH, 8, 8, 4),
                  "caption_latents": (_BATCH, 6, 16), POOLED: (_BATCH, 12)}
    return {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for k, s in shapes.items()}


def _draws(net, n_micro, seed=1):
    rng = np.random.default_rng(seed)
    m = _BATCH // n_micro
    t = (lambda: torch.from_numpy(rng.integers(0, 1000, m))) if net == \
        "unet" else (lambda: torch.from_numpy(
            rng.uniform(0.05, 0.95, m).astype(np.float32)))
    return [(torch.from_numpy(rng.standard_normal((m, 8, 8, 4)).astype(
        np.float32)), t()) for _ in range(n_micro)]


def _trainer(net, n_micro, working, ema=False, model=None, **kw):
    model = model or _model(net)
    draws = _draws(net, n_micro)
    trainer = Trainer(model=model, train_dataloader=[_batch(net)],
                      optimizers=adamw(lr=1e-3, weight_decay=0.01),
                      algorithms=[EMA(half_life=None, smoothing=0.9)]
                      if ema else [],
                      max_duration="1ba", device="cpu",
                      device_train_microbatch_size=_BATCH // n_micro,
                      noise_hook=lambda step, i, n, mb: draws[i], **kw)
    if not working:
        trainer._working_scope = contextlib.nullcontext
    return trainer


def _step(trainer):
    """Fit one step: (loss, the gradients the update took, the updated
    parameters and EMA, the counters' growth)."""
    opt = trainer.train_state.optimizer
    taken = []
    real = opt.step

    def step(**kw):
        taken.extend(g.clone() for g in kw["grads"])
        return real(**kw)

    opt.step = step
    losses = []

    class Loss(Callback):
        def batch_end(self, state, logger):
            losses.append(state.metrics["loss/train/total"])

    trainer.engine.callbacks.append(Loss())
    before = (wc.accumulations.value, wc.fallbacks.value)
    trainer.fit()
    ts = trainer.train_state
    ema = list((ts.ema_params or {}).values())
    return (losses[0], taken,
            [p.detach().clone() for p in ts.params.values()] + ema,
            (wc.accumulations.value - before[0],
             wc.fallbacks.value - before[1]))


def _equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _casts(model):
    """Trained weights and biases of the layers that take `operands`."""
    return sum(p.requires_grad for m in model.unet.modules()
               if getattr(m, "casts_weights", False)
               for p in (m.weight, m.bias) if p is not None)


@pytest.mark.parametrize("ema", [False, True], ids=["no_ema", "ema"])
@pytest.mark.parametrize("n_micro", [1, 2, 4])
@pytest.mark.parametrize("net", ["unet", "mmdit"])
def test_step_equals_the_per_call_cast(net, n_micro, ema):
    cast = _trainer(net, n_micro, working=False, ema=ema)
    state = {k: v.clone() for k, v in cast.model.unet.state_dict().items()}
    n = _casts(cast.model)
    loss_c, grads_c, after_c, counts_c = _step(cast)
    working = _trainer(net, n_micro, working=True, ema=ema)
    working.model.unet.load_state_dict(state)
    loss_w, grads_w, after_w, counts_w = _step(working)
    assert torch.equal(loss_w, loss_c)
    assert _equal(grads_w, grads_c)
    assert _equal(after_w, after_c)
    # every trained weight's gradient took the op's pass, once a microbatch
    assert counts_w == (n * n_micro, 0)
    assert counts_c == (0, n * n_micro)


@pytest.mark.parametrize("net", ["unet", "mmdit"])
def test_eval_forward_after_a_step_is_the_per_call_cast(net):
    trainer = _trainer(net, 2, working=True)
    _step(trainer)
    assert wc._active is None               # the scope ended with the step
    unet = trainer.model.unet
    unet.eval()
    batch = _batch(net, seed=2)
    x = batch["image_latents"].permute(0, 3, 1, 2)
    t = torch.tensor([10, 500, 900, 999])
    args = (x, t, batch["caption_latents"]) + (
        (batch[POOLED],) if net == "mmdit" else ())
    before = (wc.accumulations.value, wc.fallbacks.value)
    with torch.no_grad():
        per_call = unet(*args)
        with wc.working_copies(unet):
            from_copies = unet(*args)
    assert torch.equal(per_call, from_copies)
    # no grad, no accumulation either way
    assert (wc.accumulations.value, wc.fallbacks.value) == before


def _hooked(model):
    """A hook on the first attention's query weight (bias-free)."""
    layer = next(m for n, m in model.unet.named_modules()
                 if n.endswith("attn1.to_q"))
    seen = []
    layer.weight.register_hook(lambda g: seen.append(1) or g)
    return seen


@pytest.mark.parametrize("case", ["frozen", "hooked"])
def test_frozen_and_hooked_parameters_keep_the_per_call_cast(case):
    kw = dict(lora_rank=2, train_lora_only=True) if case == "frozen" else {}
    models = [_model("unet", **kw) for _ in range(2)]
    models[1].unet.load_state_dict(models[0].unet.state_dict())
    seen = [_hooked(m) for m in models] if case == "hooked" else None
    runs = [_step(_trainer("unet", 2, working=w, model=m))
            for w, m in zip((False, True), models)]
    assert runs[1][0] == runs[0][0]
    assert _equal(runs[1][1], runs[0][1]) and _equal(runs[1][2], runs[0][2])
    n = _casts(models[0])
    if case == "frozen":
        # the adapters alone are trained and copied; the frozen base
        # reaches no gradient either way
        assert 0 < n < _casts(_model("unet"))
        assert runs[1][3] == (2 * n, 0)
    else:
        # the hooked weight (no bias) through the cast, twice
        assert seen[0] == seen[1] == [1, 1]
        assert runs[1][3] == (2 * (n - 1), 2)


def test_only_trained_layers_get_copies():
    model = _model("unet", lora_rank=2, train_lora_only=True)
    with wc.working_copies(model.unet):
        covered = dict(wc._active)
    assert wc._active is None
    trained = [m.weight for m in model.unet.modules()
               if getattr(m, "casts_weights", False) and m.weight.requires_grad]
    assert set(covered) == set(trained) and len(covered) == len(trained)
    for w, (wcopy, bcopy) in covered.items():
        assert bcopy is None                # the adapters have no bias
        assert wcopy.dtype == torch.bfloat16 and torch.equal(
            wcopy, w.detach().to(torch.bfloat16))
    # an fp32 module computes without any cast: nothing to copy
    fp32 = stable_diffusion_tiny(device="cpu", precomputed_latents=True)
    with wc.working_copies(fp32.unet):
        assert wc._active == {}


@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
def test_convolution_copies_beside_either_layout(layout):
    """A 3x3 convolution's copy lies in channels_last order; beside
    activations that are not channels_last the layer hands the convolution
    a contiguous weight, as the per-call cast does: output (values and
    layout) and gradients equal the per-call cast's bit for bit."""
    from diffusion_torch.models.layers import Conv2d
    torch.manual_seed(3)
    net = torch.nn.Sequential(Conv2d(8, 16, 3, padding=1))
    net.dtype = torch.bfloat16
    x = torch.randn(2, 8, 6, 6).to(torch.bfloat16)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    g = torch.randn(2, 16, 6, 6).to(torch.bfloat16)
    outs = []
    for working in (False, True):
        for p in net.parameters():
            p.grad = None
        scope = wc.working_copies(net) if working else contextlib.nullcontext()
        with scope:
            if working:
                assert not wc._active[net[0].weight][0].is_contiguous()
            y = net(x)
            y.backward(g)
        outs.append((y, y.stride(), net[0].weight.grad, net[0].bias.grad))
    (y0, s0, gw0, gb0), (y1, s1, gw1, gb1) = outs
    assert s0 == s1 and torch.equal(y0, y1)
    assert torch.equal(gw0, gw1) and torch.equal(gb0, gb1)


def _sharded_rank(rank, world, tmp):
    from diffusion_torch.parallel.mesh import create_mesh
    model = _model("unet")
    torch.manual_seed(0)
    with torch.no_grad():
        for p in model.unet.parameters():    # the same weights on each rank
            p.copy_(torch.randn_like(p) * 0.02)
    n = _casts(model)
    batch = {k: v[rank * 2:(rank + 1) * 2] for k, v in _batch("unet").items()}
    draws = _draws("unet", 1)
    trainer = Trainer(model=model, train_dataloader=[batch],
                      optimizers=adamw(lr=1e-3), max_duration="1ba",
                      device="cpu", device_train_microbatch_size=2,
                      mesh=create_mesh(fsdp=world),
                      noise_hook=lambda step, i, k, mb: draws[i])
    before = (wc.accumulations.value, wc.fallbacks.value)
    trainer.fit()
    return {"n": n, "counts": (wc.accumulations.value - before[0],
                       wc.fallbacks.value - before[1]),
            "sharded": trainer._sharded}


def test_a_sharded_step_keeps_the_per_call_cast(tmp_path):
    from test_torch_ranks import spawn
    for out in spawn(_sharded_rank, 2, tmp_path):
        assert out["sharded"]
        # one microbatch: each trained weight's gradient through the cast
        assert out["counts"] == (0, out["n"])


def test_copies_stay_out_of_state_dict_and_checkpoints(tmp_path):
    saved = {}
    for working in (False, True):
        folder = str(tmp_path / str(working))
        trainer = _trainer("unet", 2, working, ema=True, save_folder=folder,
                           save_interval="1ba", async_checkpoint=False)
        keys = list(trainer.model.unet.state_dict())
        counts = _step(trainer)[3]
        assert (counts[0] > 0) == working
        assert list(trainer.model.unet.state_dict()) == keys
        state = os.path.join(folder, "ba1", "state")
        saved[working] = {f: {k: (v.dtype, tuple(v.shape)) for k, v in
                              load_file(os.path.join(state, f)).items()}
                          for f in sorted(os.listdir(state))
                          if f.endswith(".safetensors")}
        trainer.close()
    assert saved[True] == saved[False] and saved[True]
    assert not any(dtype == torch.bfloat16 for tensors in saved[True].values()
                   for dtype, _ in tensors.values())


def test_step_records_count_the_accumulations():
    """Each step's record holds how far the counters grew in it, which
    `portbench/metrics/layers.working_copy_share.py` reads: every trained
    weight's gradient through the op's pass, so 100%."""
    import types

    from diffusion_torch.utils import profiler
    from portbench import common
    model = _model("unet")
    n = _casts(model)
    draws = _draws("unet", 2)
    trainer = Trainer(model=model, train_dataloader=[_batch("unet")] * 3,
                      max_duration="3ba", device="cpu",
                      device_train_microbatch_size=_BATCH // 2,
                      noise_hook=lambda step, i, k, mb: draws[i])
    profiler.recorder.clear()
    trainer.fit()
    records = profiler.recorder.steps(0, 3)
    assert [r.launches(wc.accumulations) for r in records] == [2 * n] * 3
    assert [r.launches(wc.fallbacks) for r in records] == [0] * 3
    run = types.SimpleNamespace(traffic={"checked_steps": 0},
                                window={"steps": 3})
    assert common._reader("layers.working_copy_share")(run) == 100.0
