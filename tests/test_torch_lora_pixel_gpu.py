"""LoRA and the pixel UNet on the card, through the port's kernels. Marked
`gpu`; each test skips, with its reason, where no CUDA device is present.
On an H100:

    python -m pytest tests/test_torch_lora_pixel_gpu.py -q -m gpu -p no:randomly

This file imports no JAX module."""

import numpy as np
import pytest
import torch

from diffusion_torch.models import layers
from diffusion_torch.models.layers import init_like_flax_
from diffusion_torch.models.lora import freeze_base, lora_parameters
from diffusion_torch.models.unet import PIXEL_UNET, UNet2DCondition, UNetConfig
from diffusion_torch.ops import attention
from diffusion_torch.ops import flash_attention as fa
from diffusion_torch.ops import groupnorm as gn

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built for sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(a, device, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(device=device, dtype=dtype)


def test_lora_backward_through_kernels_matches_plain(cuda, monkeypatch):
    """The adapters' gradient of a bf16 adapter UNet with head dim 64 at
    32x32 (S = 1024 self-attention: the flash kernels; every GroupNorm:
    the GroupNorm kernels) against the same UNet on the card with the plain
    GroupNorm and plain attention. Both bf16, so they differ by rounding
    and summation order: relative L2 of the whole adapter gradient within
    2e-2, the loss within 1e-2."""
    cfg = UNetConfig(block_out_channels=(128, 256), layers_per_block=1,
                     block_has_attention=(True, False),
                     attention_head_dim=(2, 4), cross_attention_dim=64,
                     lora_rank=4, lora_alpha=8.0)
    with torch.device(cuda):
        unet = UNet2DCondition(cfg, dtype=torch.bfloat16)
    init_like_flax_(unet, torch.Generator(device=cuda).manual_seed(0))
    gen = torch.Generator(device=cuda).manual_seed(1)
    with torch.no_grad():
        for n, p in lora_parameters(unet).items():
            if n.endswith("_lora_b.weight"):
                p.normal_(0.0, 0.02, generator=gen)
    freeze_base(unet)
    rng = np.random.default_rng(2)
    x = _t(rng.standard_normal((2, 4, 32, 32)), cuda).contiguous(
        memory_format=torch.channels_last)
    t = torch.tensor([10, 700], device=cuda)
    ctx = _t(rng.standard_normal((2, 77, 64)), cuda)
    target = _t(rng.standard_normal((2, 4, 32, 32)), cuda)

    def grads():
        for p in unet.parameters():
            p.grad = None
        loss = torch.square(unet(x, t, ctx) - target).mean()
        loss.backward()
        torch.cuda.synchronize()
        return float(loss.detach()), torch.cat([p.grad.flatten() for p in
                                       lora_parameters(unet).values()])

    counters = (fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv,
                gn.launches, gn.launches_bwd)
    before = [c.value for c in counters]
    loss, g = grads()
    assert all(c.value > b for c, b in zip(counters, before))
    assert all(p.grad is None for n, p in unet.named_parameters()
               if "_lora_" not in n)
    monkeypatch.setattr(layers, "group_norm", gn.group_norm_reference)
    monkeypatch.setattr(attention, "flash_eligible", lambda *a, **k: False)
    before = [c.value for c in counters]
    plain_loss, plain_g = grads()
    assert [c.value for c in counters] == before
    assert loss == pytest.approx(plain_loss, rel=1e-2)
    err = float((g - plain_g).norm() / plain_g.norm())
    assert torch.isfinite(g).all() and err < 2e-2, err


def test_pixel_unet_64px_runs_flash_at_4096(cuda, monkeypatch):
    """The full-width pixel UNet (SD2's widths, 3 channels, cross-attention
    768) at 64x64 pixels in bf16: its top stage's self-attention runs the
    flash kernel at S = 4096 (the 512px serving shape), its second stage's
    at 1024."""
    shapes = []
    real = attention.flash_attention

    def spy(q, k, v):
        shapes.append(tuple(q.shape))
        return real(q, k, v)

    monkeypatch.setattr(attention, "flash_attention", spy)
    with torch.device(cuda):
        unet = UNet2DCondition(PIXEL_UNET, dtype=torch.bfloat16).eval()
    init_like_flax_(unet, torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(3)
    x = _t(rng.standard_normal((2, 3, 64, 64)), cuda)
    ctx = _t(rng.standard_normal((2, 77, 768)), cuda)
    before = fa.launches.value
    with torch.inference_mode():
        out = unet(x, torch.tensor([3, 900], device=cuda), ctx)
    torch.cuda.synchronize()
    assert out.shape == (2, 3, 64, 64) and torch.isfinite(out).all()
    assert fa.launches.value - before == len(shapes) == 10
    assert sorted({s[1] for s in shapes}) == [1024, 4096]
    assert (2, 4096, 5, 64) in shapes
