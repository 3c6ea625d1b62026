"""The flash dispatch rule (`flash_eligible`) case by case: on a CUDA
device, bf16 q/k/v with head dim 64 at a shape the JAX rule sends to its
kernel take the flash kernel; fp32, fp16, head dim 128, short or ragged
lengths, a mask, or a tensor off the card take plain math. The JAX kernel
runs in any dtype; the CUDA kernels take bf16 with head dim 64 only, and
plain math computes the same function (ROADMAP.md queue 3, fault 7)."""

import pytest
import torch

from diffusion_torch.models.unet import SD2_BASE_UNET
from diffusion_torch.ops import attention as tattn
from diffusion_torch.ops import flash_attention as tfa

BF16, F32, F16 = torch.bfloat16, torch.float32, torch.float16

_CASES = [
    # (device, dtype, q shape, k shape, masked) -> flash?
    ("cuda", BF16, (2, 4096, 5, 64), (2, 4096, 5, 64), False, True),
    ("cuda", BF16, (16, 1024, 5, 64), (16, 1024, 5, 64), False, True),
    ("cuda", BF16, (2, 1024, 10, 64), (2, 1024, 10, 64), False, True),
    ("cuda", BF16, (1, 1024, 2, 64), (1, 256, 2, 64), False, True),
    ("cuda", F32, (2, 4096, 5, 64), (2, 4096, 5, 64), False, False),
    ("cuda", F32, (16, 1024, 5, 64), (16, 1024, 5, 64), False, False),
    ("cuda", F16, (2, 4096, 5, 64), (2, 4096, 5, 64), False, False),
    ("cuda", BF16, (2, 1024, 5, 128), (2, 1024, 5, 128), False, False),
    ("cuda", F32, (2, 1024, 5, 128), (2, 1024, 5, 128), False, False),
    ("cuda", BF16, (2, 1024, 5, 40), (2, 1024, 5, 40), False, False),
    ("cuda", BF16, (2, 256, 20, 64), (2, 256, 20, 64), False, False),
    ("cuda", BF16, (2, 4096, 5, 64), (2, 77, 5, 64), False, False),
    ("cuda", BF16, (1, 1000, 2, 64), (1, 1000, 2, 64), False, False),
    ("cuda", BF16, (1, 1152, 2, 64), (1, 1000, 2, 64), False, False),
    ("cuda", BF16, (1, 1024, 2, 64), (1, 128, 2, 64), False, False),
    ("cuda", BF16, (2, 4096, 5, 64), (2, 4096, 5, 64), True, False),
    ("cpu", BF16, (2, 4096, 5, 64), (2, 4096, 5, 64), False, False),
    ("meta", BF16, (2, 4096, 5, 64), (2, 4096, 5, 64), False, False),
]


@pytest.mark.parametrize("device,dtype,q_shape,k_shape,masked,want", _CASES)
def test_flash_eligibility(device, dtype, q_shape, k_shape, masked, want):
    assert tattn.flash_eligible(device, dtype, q_shape, k_shape,
                                masked) is want


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    """multi_head_attention reads the rule from the tensors themselves: a
    CPU bf16 call at a kernel shape takes plain math."""
    def refuse(*a, **k):
        raise AssertionError("flash_attention called")
    monkeypatch.setattr(tattn, "flash_attention", refuse)
    q = torch.randn(1, 1024, 1, 64).to(BF16)
    out = tattn.multi_head_attention(q, q, q)
    assert out.dtype == BF16 and out.shape == q.shape


def test_fp32_sd2_unet_attention_shapes_take_plain_math():
    """An fp32 SD2-width UNet (`encode_latents_in_fp16: false`): none of
    its attention calls at 256px or 512px would go to the kernel on CUDA,
    while the bf16 UNet's S >= 1024 self-attention does."""
    cfg = SD2_BASE_UNET
    calls = []
    for size in (256, 512):
        for i, (width, h) in enumerate(zip(cfg.block_out_channels,
                                           cfg.attention_head_dim)):
            s, d = (size // 8 >> i) ** 2, width // h
            calls += [((2, s, h, d), (2, s, h, d)),
                      ((2, s, h, d), (2, 77, h, d))]
    assert not any(tattn.flash_eligible("cuda", F32, q, k, False)
                   for q, k in calls)
    assert any(tattn.flash_eligible("cuda", BF16, q, k, False)
               for q, k in calls)
    # the kernel itself refuses what the rule keeps from it
    with pytest.raises(ValueError):
        tfa.flash_attention_cuda(*(torch.empty(1, 1024, 1, 64, device="meta")
                                   for _ in range(3)))
