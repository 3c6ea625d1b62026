"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. Marked `gpu`; each test skips, with its reason, where no CUDA
device is present. On an H100:

    python -m pytest tests/test_torch_kernels_gpu.py -q -m gpu -p no:randomly

This file imports no JAX module of its own, so it also runs where only the
port's dependencies are installed.
"""

import numpy as np
import pytest
import torch

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


def _randn(shape, seed, dtype, device, shift=0.0):
    x = np.random.default_rng(seed).standard_normal(shape) + shift
    return torch.from_numpy(x.astype(np.float32)).to(device=device, dtype=dtype)


# bf16: kernel and plain version round the same fp32 value once, but sum in
# another order, so one bf16 ulp of |y| <= ~5 (2**-5) separates them at most.
# fp32: summation order only.
_GN_TOL = {torch.bfloat16: dict(atol=3.2e-2, rtol=8e-3),
           torch.float32: dict(atol=2e-5, rtol=2e-5)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,groups,act", [
    ((2, 4096, 320), 32, "silu"),
    ((2, 1024, 640), 32, None),
    ((3, 777, 96), 32, "silu"),      # ragged last chunk, C/G = 3
    ((2, 50, 36), 4, None),          # C % 8 != 0: scalar apply path
    ((4, 64, 2560), 32, "silu"),
])
def test_group_norm_kernel_matches_plain(cuda, dtype, shape, groups, act):
    x = _randn(shape, 0, dtype, cuda, shift=3.0)
    c = shape[-1]
    scale = _randn((c,), 1, torch.float32, cuda)
    bias = _randn((c,), 2, torch.float32, cuda)
    before = gn.launches.value
    y, mean, rstd = gn.group_norm_cuda(x, scale, bias, groups, 1e-5, act)
    torch.cuda.synchronize()
    assert gn.launches.value == before + 1
    want = gn.group_norm_reference(x, scale, bias, groups, 1e-5, act)
    torch.testing.assert_close(y.float(), want.float(), **_GN_TOL[dtype])
    want_mean, want_rstd = gn.group_norm_stats_reference(x, groups, 1e-5)
    torch.testing.assert_close(mean, want_mean, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, want_rstd, atol=1e-5, rtol=1e-4)


def test_group_norm_kernel_raises_on_what_it_does_not_take(cuda):
    scale = torch.ones(36, device=cuda)
    bias = torch.zeros(36, device=cuda)
    x = torch.zeros((2, 8, 36), device=cuda)
    with pytest.raises(ValueError, match="groups"):
        gn.group_norm(x, scale, bias, 8)            # 36 % 8 != 0
    with pytest.raises(ValueError, match="contiguous"):
        gn.group_norm(x.transpose(1, 2).contiguous().transpose(1, 2),
                      scale, bias, 4)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        gn.group_norm(x.half(), scale, bias, 4)


# bf16 out: the kernel casts p to bf16 relative to the running max, the plain
# version relative to the final logsumexp, so the products round differently
# (~2**-8 relative); the output itself is one bf16 rounding. lse is fp32.
_FA_OUT_TOL = dict(atol=1e-2, rtol=2e-2)
_FA_LSE_TOL = dict(atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("b,sq,skv,h", [
    (2, 1024, 1024, 10),
    (1, 4096, 4096, 5),
    (1, 128, 320, 3),                 # cross lengths, several KV tiles
])
def test_flash_kernel_matches_plain(cuda, b, sq, skv, h):
    q = _randn((b, sq, h, 64), 0, torch.bfloat16, cuda)
    k = _randn((b, skv, h, 64), 1, torch.bfloat16, cuda)
    v = _randn((b, skv, h, 64), 2, torch.bfloat16, cuda)
    before = fa.launches.value
    out, lse = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.launches.value == before + 1
    want_out, want_lse = fa.flash_attention_reference(q, k, v)
    torch.testing.assert_close(out.float(), want_out.float(), **_FA_OUT_TOL)
    torch.testing.assert_close(lse, want_lse, **_FA_LSE_TOL)


def test_flash_kernel_reads_strided_views(cuda):
    """q/k/v sliced out of one fused projection: no copy, same answer."""
    qkv = _randn((2, 256, 4, 192), 3, torch.bfloat16, cuda)
    q, k, v = qkv[..., :64], qkv[..., 64:128], qkv[..., 128:]
    out, lse = fa.flash_attention(q, k, v)
    want_out, want_lse = fa.flash_attention_reference(
        q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(out.float(), want_out.float(), **_FA_OUT_TOL)
    torch.testing.assert_close(lse, want_lse, **_FA_LSE_TOL)


def test_flash_kernel_raises_on_what_it_does_not_take(cuda):
    q = torch.zeros((1, 128, 2, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16"):
        fa.flash_attention(q.float(), q.float(), q.float())
    with pytest.raises(ValueError, match="multiples of 64"):
        fa.flash_attention(q[:, :100], q[:, :100], q[:, :100])
    small = torch.zeros((1, 128, 2, 32), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="B, S, H, 64"):
        fa.flash_attention(small, small, small)
