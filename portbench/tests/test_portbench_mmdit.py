"""The MMDiT training cell (`kinds/train_mmdit.py`) on the CPU at a tiny
size: its reference against the program's plain route, a whole run
(correct, and not with a fault planted underneath or with the fp8
control), and the cell's three new readers on synthetic runs."""

import copy
import time

import pytest
import torch

from portbench import common
from portbench.kinds import train_mmdit as kind
from portbench.reference import mmdit as ref
from portbench.trace import Trace

CPU = torch.device("cpu")
SEED = 2 ** 33 + 7
# fp32 on both sides at the tiny widths (as test_portbench_reference.py)
LIMITS = {"loss": 1e-5, "first_grad": 1e-3, "change": 1e-2}
TINY = {"sample_size": 16, "patch_size": 2, "in_channels": 16,
        "out_channels": 16, "num_layers": 2, "attention_head_dim": 64,
        "num_attention_heads": 2, "joint_attention_dim": 48,
        "caption_projection_dim": 128, "pooled_projection_dim": 40,
        "pos_embed_max_size": 24}


def tiny_files(limits=LIMITS):
    files = copy.deepcopy(common.cell_files(common.benchmark(),
                                            "sd3-1024-train"))
    files["config"]["transformer"] = dict(TINY)
    files["config"]["model_kwargs"]["encode_latents_in_fp16"] = False
    files["traffic"].update(batch_size=4, microbatch=2, latent_side=16,
                            caption_tokens=20, reference_rows=1,
                            reference_attn_rows=32)
    files["check"]["limits"] = dict(limits)
    return files


def test_reference_is_the_programs_plain_route():
    files = tiny_files()
    model = kind.program_model(files["config"], CPU)
    flat, views = kind._weights(SEED, files["config"], CPU)
    model.unet.load_state_dict(views, strict=False)
    reference = kind._reference_model(files["config"], CPU, 32, True)
    reference.to_empty(device=CPU)
    reference.load_state_dict(model.unet.state_dict())
    batch = kind.Feed(SEED, files["traffic"], files["config"], CPU).batch(0)
    noise, t = kind.draws(SEED, 0, 0, batch["image_latents"],
                          files["config"]["train"],
                          files["config"]["scheduler"])
    assert bool(((t > 0) & (t < 1)).all())
    got = model.loss_fn(batch, None, noise, t)
    got.backward()
    want = ref.flow_loss(reference, batch, noise, t)
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
    files = common.cell_files(common.benchmark(), "sd3-1024-train")
    return common.Run(cell=files["cell"], config=files["config"],
                      traffic=files["traffic"], window=window, trace=trace)


@pytest.mark.parametrize("calls,want", [
    ({"flash_calls": 48, "plain_calls": 0}, 100.0),
    ({"flash_calls": 36, "plain_calls": 12}, 75.0),
    ({"flash_calls": 0, "plain_calls": 0}, None),
    (None, None),                     # a program without the counters
])
def test_flash_call_share(calls, want):
    window = {} if calls is None else {"attention_calls": calls}
    assert common._reader("attention.flash_call_share")(
        _synthetic(window)) == want


def test_mfu_counts_the_reference_flops():
    """About 25 TFLOP a sample, as the layer list gives it: linears 5.77
    and joint attention 2.66 TFLOP forward, three times that trained."""
    from portbench.flops_mmdit import mmdit_train_flops
    files = common.cell_files(common.benchmark(), "sd3-1024-train")
    per = mmdit_train_flops(files["config"]["transformer"], 1, 128, 154)
    assert 24e12 < per < 26.5e12
    got = common._reader("mfu.train_mmdit")(_synthetic(
        {"seconds": 10.0, "samples": 100}))
    assert got == pytest.approx(100.0 * per * 10 / 989e12)


def _trace(n, seconds=1.0):
    ops = [(0.0, seconds / (3 * n), k) for k in (
        "flash_fwd_kernel", "flash_bwd_dq_kernel<true>",
        "flash_bwd_dkv_kernel<true>") for _ in range(n)]
    return Trace(window_s=2.0, busy_s=1.0, ops=ops, gaps=[])


def test_flash_roofline_reads_only_whole_counts():
    from portbench.flops import flash_bound_s
    from portbench.flops_mmdit import joint_calls
    files = common.cell_files(common.benchmark(), "sd3-1024-train")
    t = files["traffic"]
    calls = joint_calls(files["config"]["transformer"], t["microbatch"],
                        128, 154)
    assert calls[0][1:5] == (24, 4250, 4250, 64) and len(calls) == 24
    passes = 3 * t["batch_size"] // t["microbatch"]
    n = passes * 24                   # traced microbatches x blocks
    tails = {"tail_fwd": n, "tail_dq": n, "tail_dkv": n}
    window = {"traced_steps": 3, "tail_launches": tails}
    read = common._reader("flash_roofline.train_mmdit")
    bound = passes * sum(flash_bound_s(c, False) + flash_bound_s(c, True)
                         for c in calls)
    assert read(_synthetic(window, _trace(n))) == pytest.approx(100 * bound)
    # a launch missing from the trace, a launch that masked no tail, or a
    # program without tail counters: no reading
    assert read(_synthetic(window, _trace(n - 1))) is None
    assert read(_synthetic(dict(window, tail_launches=dict(
        tails, tail_dq=n - 1)), _trace(n))) is None
    assert read(_synthetic({"traced_steps": 3}, _trace(n))) is None
    assert read(_synthetic(window, None)) is None


def test_fp8_control_recomputes_blocks_on_another_thread():
    """On the card the autograd engine runs the backward, and so the
    checkpointed blocks' recompute, on a thread of its own, which does not
    hold the fp8 control's torch-function mode: the reference enters the
    forward's modes again there, so the recompute matches the forward."""
    import threading
    from portbench.reference.lowp import Fp8Products
    torch.manual_seed(0)
    model = ref.MMDiT(ref.mmdit_spec(TINY), 32, checkpoint_blocks=True)
    batch = {"image_latents": torch.randn(2, 16, 16, 16),
             "caption_latents": torch.randn(2, 20, 48),
             "pooled_caption_latents": torch.randn(2, 40)}
    with Fp8Products():
        loss = ref.flow_loss(model, batch, torch.randn(2, 16, 16, 16),
                             torch.rand(2))
    errors = []

    def backward():
        try:
            loss.backward()
        except RuntimeError as e:      # CheckpointError is one
            errors.append(e)
    thread = threading.Thread(target=backward)
    thread.start()
    thread.join(timeout=120)
    assert not thread.is_alive() and not errors, errors
    assert model.proj_out.weight.grad is not None
