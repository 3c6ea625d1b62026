"""The yardstick's counts: the reference's FLOPs against a count made by
hand from each layer's shapes, the full-width count against the port's
plain route, and the kernels' least times."""

import pytest
import torch
import torch.nn as nn

from portbench import flops
from portbench.reference.unet import Attention, UNet2DCondition, unet_spec
from portbench.tests.tiny import TINY_UNET


def _by_hand(unet: dict, batch: int, side: int, tokens: int) -> int:
    """Forward 2 M K N per product; the backward the same again for the
    weight's gradient, and again for the input's where the input needs one
    (not the latents, the timestep sinusoid or the caption context)."""
    spec = unet_spec(unet)
    with torch.device("meta"):
        model = UNet2DCondition(spec)
    total, hooks = [0], []

    def linear(m, inp, out):
        n = 2 * inp[0].numel() // inp[0].shape[-1] * m.in_features \
            * m.out_features
        total[0] += n * (3 if inp[0].requires_grad else 2)

    def conv(m, inp, out):
        b, co, h, w = out.shape
        n = 2 * b * co * h * w * m.in_channels * m.kernel_size[0] ** 2
        total[0] += n * (3 if inp[0].requires_grad else 2)

    def attn(m, args, kwargs, out):
        ctx = kwargs.get("context")
        x = args[0]
        skv = x.shape[1] if ctx is None else ctx.shape[1]
        total[0] += 3 * 2 * 2 * x.shape[0] * m.heads * x.shape[1] * skv \
            * m.dim_head

    for m in model.modules():
        if isinstance(m, nn.Linear):
            hooks.append(m.register_forward_hook(linear))
        elif isinstance(m, nn.Conv2d):
            hooks.append(m.register_forward_hook(conv))
        elif isinstance(m, Attention):
            hooks.append(m.register_forward_hook(attn, with_kwargs=True))
    x = torch.zeros(batch, spec["in_channels"], side, side, device="meta")
    t = torch.zeros(batch, dtype=torch.long, device="meta")
    c = torch.zeros(batch, tokens, spec["cross_attention_dim"],
                    device="meta")
    model(x, t, c)
    return total[0]


@pytest.mark.parametrize("batch,side", [(2, 8), (3, 16)])
def test_tiny_count_is_the_count_by_hand(batch, side):
    assert flops.train_flops(TINY_UNET, batch, side, 7) == _by_hand(
        TINY_UNET, batch, side, 7)


def test_full_width_count_matches_the_ports_plain_route():
    """The 256px recipe batch of 32 (two microbatches of 16): the port's
    plain route counted dot 3.609022e12 + conv 5.019953e12 a microbatch."""
    from portbench import common
    full = common.cell_files(common.benchmark(), "sd2-256-train")["config"]
    total = 2 * flops.train_flops(full["unet"], 16, 32, 77)
    assert abs(total - 2 * (3.609022e12 + 5.019953e12)) < 2 * 2e6
    assert total == _by_hand(full["unet"], 32, 32, 77)


def test_flash_calls_at_512px():
    from portbench import common
    full = common.cell_files(common.benchmark(), "sd2-512-train")["config"]
    calls = flops.flash_calls(full["unet"], 8, 64, 77)
    assert sorted({c[:5] for c in calls}) == [(8, 5, 4096, 4096, 64),
                                              (8, 10, 1024, 1024, 64)]
    assert len(calls) == 10
    norms, _ = flops.unet_calls(full["unet"], 8, 64, 77)
    assert len(norms) == 61


def test_bounds_by_hand():
    call = (8, 5, 4096, 4096, 64, True)
    unit = 2.0 * 8 * 5 * 4096 * 4096 * 64
    assert flops.flash_bound_s(call, False) == 2 * unit / 989e12
    assert flops.flash_bound_s(call, True) == 4 * unit / 989e12
    x = 16 * 320 * 32 * 32 * 2
    assert flops.group_norm_bound_s((16, 320, 32, 32), False) == \
        (2 * x + 320 * 8) / 3.35e12
    assert flops.group_norm_bound_s((16, 320, 32, 32), True) == \
        (3 * x + 2 * 320 * 8) / 3.35e12
