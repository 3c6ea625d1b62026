"""The optimizer's update with the EMA folded in (`AdamW.step(ema=,
smoothing=)`, `ops/adamw.py`) on the CPU: the plain path equals a step
then `apply_ema` bit for bit; the Trainer hands the EMA to the step only
on an update that runs; the kernel's launch plan covers every element of
every tensor once. The kernel itself runs on the card
(`tests/test_torch_kernels_gpu.py`, marked `gpu`)."""

import numpy as np
import pytest
import torch

from diffusion_torch.algorithms.ema import EMA, apply_ema
from diffusion_torch.ops import adamw as ops_adamw
from diffusion_torch.train import optim
from diffusion_torch.train.trainer import Trainer

torch.set_num_threads(1)

_SHAPES = [(3, 5), (7,), (2, 3, 4), (1,)]


def _tensors(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                             * scale) for s in _SHAPES]


@pytest.mark.parametrize("smoothing", [0.0, 0.9999, 1.0])
@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
def test_step_with_ema_equals_step_then_apply_ema(mu_dtype, smoothing):
    """Three clipped and unclipped updates: `step(ema=, smoothing=)`
    against `step()` then `apply_ema`, parameters, moments and EMA equal
    bit for bit."""
    sides = []
    for fused in (True, False):
        params = _tensors(0)
        ema = _tensors(1)
        opt = optim.AdamW(params, lr=0.1, mu_dtype=mu_dtype,
                          grad_clip_norm=1.0)
        for k, scale in enumerate((3.0, 0.01, 1.0)):
            grads = _tensors(2 + k, scale)
            if fused:
                opt.step(grads=grads, ema=ema, smoothing=smoothing)
            else:
                opt.step(grads=grads)
                apply_ema(dict(enumerate(ema)), dict(enumerate(params)),
                          smoothing)
        sides.append((params, opt.mu, opt.nu, ema))
    for got, want in zip(*sides):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_step_leaves_the_gradients():
    params, grads = _tensors(0), _tensors(1, 5.0)
    before = [g.clone() for g in grads]
    optim.AdamW(params, grad_clip_norm=1.0).step(grads=grads)
    assert all(torch.equal(g, b) for g, b in zip(grads, before))


class _Stub(torch.nn.Module):
    """A model of a few hundred values: a linear `unet`, whose loss is its
    output's mean square (NaN where the batch holds one)."""

    device = torch.device("cpu")

    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.unet = torch.nn.Linear(16, 16)

    def loss_fn(self, batch, gen, **kwargs):
        return self.unet(batch["x"]).square().mean()


def test_trainer_skips_the_step_and_the_ema_on_a_nonfinite_step(monkeypatch):
    """Three batches, the second NaN: its step is not taken, so the weights
    and the EMA stay as they were; the others hand the EMA to the step."""
    calls = []
    step = optim.AdamW.step

    def spy(self, *args, **kwargs):
        calls.append((kwargs.get("ema") is not None, kwargs.get("smoothing")))
        return step(self, *args, **kwargs)

    monkeypatch.setattr(optim.AdamW, "step", spy)
    rng = np.random.default_rng(0)
    batches = [{"x": rng.standard_normal((4, 16)).astype(np.float32)}
               for _ in range(3)]
    batches[1]["x"][0, 0] = np.nan
    snaps = []

    class Snap(EMA):
        def apply(self, event, state, logger):
            super().apply(event, state, logger)
            ts = state.train_state
            if event.name == "BATCH_END":
                snaps.append(([p.detach().clone() for p in ts.params.values()],
                              [e.clone() for e in ts.ema_params.values()]))

    tr = Trainer(model=_Stub(), train_dataloader=batches, max_duration="3ba",
                 algorithms=[Snap(smoothing=0.5, ema_start="0ba")],
                 skip_nonfinite_updates=True, device="cpu")
    tr.fit()
    assert calls == [(True, 0.5), (True, 0.5)]
    (p0, e0), (p1, e1), (p2, e2) = snaps
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert all(torch.equal(a, b) for a, b in zip(e0, e1))
    assert not any(torch.equal(a, b) for a, b in zip(p1, p2))
    assert not any(torch.equal(a, b) for a, b in zip(e1, e2))
    assert tr.train_state.optimizer.count == 2


@pytest.mark.parametrize("numels", [
    (1,),
    (0, 5, 0),
    (ops_adamw.CHUNK - 1, ops_adamw.CHUNK, ops_adamw.CHUNK + 1, 3),
    (7 * ops_adamw.CHUNK + 13,) * 3,
    tuple(range(1, 1100)),                 # three launches of 367
    (5,) * ops_adamw.MAX_TENSORS + (9,),   # two launches of 257 and 256
])
def test_plan_covers_every_element_once(numels):
    launches = ops_adamw.plan(numels)
    assert launches[0].start == 0 and launches[-1].stop == len(numels)
    for a, b in zip(launches, launches[1:]):
        assert a.stop == b.start
    for ln in launches:
        assert 0 < ln.stop - ln.start <= ops_adamw.MAX_TENSORS
        assert ln.first_chunk[0] == 0 and ln.first_chunk.dtype == np.int32
        for t, n in enumerate(numels[ln.start:ln.stop]):
            assert ln.numels[t] == n
            # chunk k of tensor t takes [k CHUNK, min((k + 1) CHUNK, n))
            ks = range(ln.first_chunk[t + 1] - ln.first_chunk[t])
            covered = np.zeros(n, dtype=np.int64)
            for k in ks:
                covered[k * ops_adamw.CHUNK:(k + 1) * ops_adamw.CHUNK] += 1
                assert k * ops_adamw.CHUNK < n
            assert (covered == 1).all()


def test_kernel_wrapper_refuses_cpu_tensors():
    params = _tensors(0)
    with pytest.raises(ValueError, match="CUDA"):
        ops_adamw.adamw_cuda(params, _tensors(1), _tensors(2), _tensors(3),
                             lr=0.1, b1=0.9, b2=0.999, eps=1e-8,
                             weight_decay=0.01, bc1=0.1, bc2=0.001)
