"""The FLUX training cell (`kinds/train_flux.py`) on the CPU at a tiny size:
its reference against the program's plain route, a whole run (correct,
and not with a fault planted underneath or with the fp8 control), the
dynamic shift of its draws, and the cell's four new readers on synthetic
runs."""

import copy
import math
import time

import pytest
import torch

from portbench import common
from portbench.kinds import train_flux as kind
from portbench.reference import mmdit as ref_mmdit
from portbench.trace import Trace

CPU = torch.device("cpu")
SEED = 2 ** 33 + 11
CELL = "flux-dev-1024-train"
# fp32 on both sides at the tiny widths (as test_portbench_mmdit.py)
LIMITS = {"loss": 1e-5, "first_grad": 1e-3, "change": 1e-2}
TINY = {"_class_name": "FluxTransformer2DModel", "patch_size": 1,
        "in_channels": 16, "num_layers": 1, "num_single_layers": 2,
        "attention_head_dim": 16, "num_attention_heads": 2,
        "joint_attention_dim": 24, "pooled_projection_dim": 20,
        "guidance_embeds": True, "axes_dims_rope": [4, 6, 6]}


def tiny_files(limits=LIMITS):
    files = copy.deepcopy(common.cell_files(common.benchmark(), CELL))
    files["config"]["transformer"] = dict(TINY)
    files["config"]["model_kwargs"]["encode_latents_in_fp16"] = False
    files["traffic"].update(batch_size=4, microbatch=2, latent_side=8,
                            caption_tokens=7, reference_rows=1,
                            reference_attn_rows=16)
    files["check"]["limits"] = dict(limits)
    return files


def test_the_shift_is_the_published_line():
    sched = common.cell_files(common.benchmark(), CELL)["config"]["scheduler"]
    assert kind.shift(sched, 128) == pytest.approx(math.exp(1.15))
    assert kind.shift(sched, 32) == pytest.approx(math.exp(0.5))
    from diffusion_torch.schedulers import flow_match
    assert kind.shift(sched, 128) == flow_match.dynamic_shift(4096)


def test_reference_is_the_programs_plain_route():
    files = tiny_files()
    model = kind.program_model(files["config"], CPU)
    flat, views = kind._weights(SEED, files["config"], CPU)
    model.unet.load_state_dict(views)
    reference = kind._reference_model(files["config"], 16, True)
    reference.to_empty(device=CPU)
    reference.load_state_dict(model.unet.state_dict())
    batch = kind.Feed(SEED, files["traffic"], files["config"],
                      CPU).batch(0)
    assert batch["image_latents"].shape == (4, 8, 8, 4)
    noise, t = kind.draws(SEED, 0, 0, batch["image_latents"],
                          files["config"]["train"],
                          files["config"]["scheduler"])
    assert bool(((t > 0) & (t < 1)).all())
    got = model.loss_fn(batch, None, noise, t)
    got.backward()
    want = ref_mmdit.flow_loss(reference, batch, noise, t)
    want.backward()
    assert got.item() == pytest.approx(want.item(), rel=1e-5)
    grads = dict(reference.named_parameters())
    for n, p in model.unet.named_parameters():
        g, w = p.grad, grads[n].grad
        assert (g - w).norm() <= 1e-4 * w.norm() + 1e-12, n


def _run(plant=None):
    return kind.run(tiny_files(), SEED, 0.3, False, CPU, time.perf_counter(),
                    plant=plant)


def test_sound_run_is_correct():
    out = _run()
    assert all(c.ok for c in out["checks"]), out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    calls = out["run"].window["attention_calls"]
    # on the CPU every call takes plain math
    assert calls["flash_calls"] == 0 and calls["plain_calls"] > 0


def _half_batch(model, trainer):
    full = model.loss_fn

    def half(mb, gen=None, *draws, **kwargs):
        n = next(iter(mb.values())).shape[0] // 2
        return full({k: v[:n] for k, v in mb.items()}, gen,
                    *(d[:n] for d in draws), **kwargs)

    model.loss_fn = half


def _unchanged(model, trainer):
    trainer.train_state.optimizer.step = lambda *a, **k: None


@pytest.mark.parametrize("plant", [_unchanged, _half_batch],
                         ids=["state unchanged", "half the batch"])
def test_a_planted_fault_is_not_correct(plant):
    out = _run(plant)
    assert not all(c.ok for c in out["checks"]), out["checks"]


def test_the_fp8_control_fails():
    checks = kind.control_numbers(tiny_files(), SEED, CPU, "fp8")
    assert not all(c.ok for c in checks), checks


def _synthetic(window, trace=None):
    files = common.cell_files(common.benchmark(), CELL)
    return common.Run(cell=files["cell"], config=files["config"],
                      traffic=files["traffic"], window=window, trace=trace)


def test_mfu_counts_the_reference_flops():
    """About 47 TFLOP a sample, as the layer list gives it: 12 blocks of
    1.04 TFLOP of products and 0.26 of joint attention forward, three
    times that trained."""
    from portbench.flops_flux import flux_train_flops
    files = common.cell_files(common.benchmark(), CELL)
    per = flux_train_flops(files["config"]["transformer"], 1, 128, 512)
    assert 46e12 < per < 48e12
    got = common._reader("mfu.train_flux")(_synthetic(
        {"seconds": 10.0, "samples": 100}))
    assert got == pytest.approx(100.0 * per * 10 / 989e12)


def _trace(n, seconds=1.0):
    names = ("flash_fwd_kernel<128, false>", "flash_bwd_dq_kernel<128, "
             "false>", "flash_bwd_dkv_kernel<128, false>",
             "flash_fwd_kernel<64, false>")
    ops = [(0.0, seconds / (3 * n), k) for k in names for _ in range(n)]
    return Trace(window_s=2.0, busy_s=1.0, ops=ops, gaps=[])


@pytest.mark.parametrize("which,share,backward", [
    ("fwd", 1.0, False), ("dq", 0.75, True), ("dkv", 1.0, True)])
def test_flash_rooflines_read_only_whole_counts(which, share, backward):
    from portbench.flops import flash_bound_s
    from portbench.flops_flux import joint_calls
    files = common.cell_files(common.benchmark(), CELL)
    t = files["traffic"]
    calls = joint_calls(files["config"]["transformer"], t["microbatch"],
                        128, 512)
    assert calls[0][1:5] == (24, 4608, 4608, 128) and len(calls) == 12
    passes = 3 * t["batch_size"] // t["microbatch"]
    n = passes * 12                   # traced microbatches x blocks
    launches = {"fwd": n, "dq": n, "dkv": n}
    window = {"traced_steps": 3, "d128_launches": launches}
    read = common._reader(f"flash_roofline.train_flux_{which}")
    bound = passes * sum(share * flash_bound_s(c, backward) for c in calls)
    # the d = 64 instance's time is not the d = 128 one's
    assert read(_synthetic(window, _trace(n))) == pytest.approx(
        100 * bound / (1.0 / 3))
    # a launch missing from the trace, a counter that disagrees, or a
    # program without the counters: no reading
    assert read(_synthetic(window, _trace(n - 1))) is None
    assert read(_synthetic(dict(window, d128_launches=dict(
        launches, **{which: n - 1})), _trace(n))) is None
    assert read(_synthetic({"traced_steps": 3}, _trace(n))) is None
    assert read(_synthetic(window, None)) is None
