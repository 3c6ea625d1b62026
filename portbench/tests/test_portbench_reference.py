"""The reference against the port's plain CPU route at the tiny widths,
and the whole run of a training cell on the CPU: sound, with each fault a
training cell can have planted underneath, and with the control."""

import time

import pytest
import torch

from portbench.control import control_checks
from portbench.kinds import train
from portbench.reference.train import alphas_cumprod, step_loss
from portbench.reference.unet import UNet2DCondition, unet_spec
from portbench.tests.tiny import tiny_files
from portbench.weights import derive_seed, draw_like

CPU = torch.device("cpu")
SEED = 2 ** 33 + 99
# fp32 on both sides at the tiny widths; the change's gap is the rounding
# of 1e-8-sized updates on fp32 parameters (a few ulps)
LIMITS = {"loss": 1e-5, "first_grad": 1e-3, "change": 1e-2}


def _same_weights():
    files = tiny_files()
    model = train.program_model(files["config"], CPU)
    with torch.device("meta"):
        ref = UNet2DCondition(unet_spec(files["config"]["unet"]))
    ref.to_empty(device=CPU)
    _, views = draw_like(ref, derive_seed(SEED, "unet"), CPU)
    model.unet.load_state_dict(views)
    ref.load_state_dict(views)
    return files, model, ref


def test_reference_is_the_ports_plain_route():
    files, model, ref = _same_weights()
    feed = train.Feed(SEED, files["traffic"], files["config"], CPU)
    batch = feed.batch(0)
    noise, t = train.draws(SEED, 0, 0, batch["image_latents"], 1000)
    got = model.loss_fn(batch, None, noise, t)
    got.backward()
    abar = torch.as_tensor(alphas_cumprod(files["config"]["scheduler"]),
                           dtype=torch.float32)
    want = step_loss(ref, batch["image_latents"], batch["caption_latents"],
                     noise, t, abar)
    want.backward()
    assert got.item() == pytest.approx(want.item(), rel=1e-5)
    grads = dict(ref.named_parameters())
    for n, p in model.unet.named_parameters():
        g, w = p.grad, grads[n].grad
        assert (g - w).norm() <= 1e-4 * w.norm(), n


def _run(plant=None):
    files = tiny_files(limits=LIMITS)
    return train.run(files, SEED, 0.3, False, CPU, time.perf_counter(),
                     plant=plant)


def test_sound_run_is_correct():
    out = _run()
    assert all(c.ok for c in out["checks"]), out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["end_to_end"]["train_samples_per_s"] > 0


def _unchanged(model, trainer):
    trainer.train_state.optimizer.step = lambda *a, **k: None


def _half_batch(model, trainer):
    full = model.loss_fn

    def half(mb, gen=None, *draws, **kwargs):
        n = next(iter(mb.values())).shape[0] // 2
        return full({k: v[:n] for k, v in mb.items()}, gen,
                     *(d[:n] for d in draws), **kwargs)

    model.loss_fn = half


def _altered_output(model, trainer):
    forward = model.unet.forward

    def shifted(*args, **kwargs):
        return forward(*args, **kwargs) * 1.01

    model.unet.forward = shifted


@pytest.mark.parametrize("plant", [_unchanged, _half_batch, _altered_output],
                         ids=["state unchanged", "half the batch",
                              "output altered"])
def test_a_planted_fault_is_not_correct(plant):
    out = _run(plant)
    assert not all(c.ok for c in out["checks"]), out["checks"]


def test_the_fp8_control_fails():
    checks = control_checks(tiny_files(limits=LIMITS), SEED, CPU)
    assert not all(c.ok for c in checks), checks
