"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. Marked `gpu`; each test skips, with its reason, where no CUDA
device is present. On an H100:

    python -m pytest tests/test_torch_kernels_gpu.py -q -m gpu -p no:randomly

This file imports no JAX module of its own, so it also runs where only the
port's dependencies are installed.
"""

import os
import sys

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
    # a backward through a plain kernel first: the autograd engine's device
    # thread then holds the CUDA context before a test's backward reaches
    # cuBLAS, which warns (an error here) on a thread without one
    x = torch.ones(1, device="cuda", requires_grad=True)
    (x * 2).sum().backward()
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
    ((4, 4096, 960), 32, "silu"),    # 512px CFG batch 4, the largest slice
    ((1, 65536, 256), 32, "silu"),   # VAE decoder: two launches
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
# Beside that: at most two bf16 ulps of the largest |out| anywhere, and a
# relative L2 error of 2**-7. P rounded to bf16 on both sides gives ~3e-3;
# P rounded any coarser fails (fp8 e4m3, 2**-4 a term: ~2.4e-2), which
# test_flash_out_bound_rejects_p_below_bf16 shows.
_FA_OUT_REL_MAX, _FA_OUT_REL_L2 = 2 ** -6, 2 ** -7


def _flash_out_errors(out, want):
    """(max-abs error / max |want|, relative L2 error)."""
    diff = out.float() - want.float()
    return ((diff.abs().max() / want.float().abs().max()).item(),
            (diff.norm() / want.float().norm()).item())


def _assert_flash_out_close(out, want):
    torch.testing.assert_close(out.float(), want.float(), **_FA_OUT_TOL)
    rel_max, rel_l2 = _flash_out_errors(out, want)
    assert rel_max <= _FA_OUT_REL_MAX and rel_l2 <= _FA_OUT_REL_L2, (
        rel_max, rel_l2)


def _online_attention(q, k, v, p_dtype, tile=128):
    """The forward kernel's math in plain PyTorch: an online softmax over
    `tile`-key tiles, P rounded to `p_dtype` against the running max, fp32
    accumulation, the output rounded to q's dtype."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * 64 ** -0.5
    m = torch.full(s.shape[:-1], -float("inf"), device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((*s.shape[:-1], 64), device=q.device)
    for t in range(0, s.shape[-1], tile):
        m_new = torch.maximum(m, s[..., t:t + tile].amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s[..., t:t + tile] - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(p_dtype).float(), v[:, t:t + tile].float())
        m = m_new
    return (acc / l[..., None]).transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("b,sq,skv,h", [
    (2, 1024, 1024, 10),              # 512px serving, second stage
    (1, 4096, 4096, 5),
    (4, 4096, 4096, 5),               # 512px serving, first stage, CFG batch 4
    (1, 128, 320, 3),                 # cross lengths, a ragged last KV tile
    (1, 192, 320, 3),                 # neither length a multiple of 128
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
    _assert_flash_out_close(out, want_out)
    torch.testing.assert_close(lse, want_lse, **_FA_LSE_TOL)
    again = fa.flash_attention_cuda(q, k, v)          # no atomics
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


@pytest.mark.parametrize("p_dtype", [torch.float8_e4m3fn, torch.float8_e5m2])
def test_flash_out_bound_rejects_p_below_bf16(cuda, p_dtype):
    """The forward's bound tells P in bf16 from P rounded any coarser: the
    kernel's math in plain PyTorch passes it with P in bf16 and fails it
    with P in fp8 (a fault planted here, not in the kernel)."""
    q, k, v = (_randn((2, 1024, 10, 64), i, torch.bfloat16, cuda)
               for i in range(3))
    want_out, _ = fa.flash_attention_reference(q, k, v)
    good = _flash_out_errors(_online_attention(q, k, v, torch.bfloat16),
                             want_out)
    bad = _flash_out_errors(_online_attention(q, k, v, p_dtype), want_out)
    print(f"P in bf16: {good}; P in {p_dtype}: {bad} (max-abs / max |out| "
          f"bound {_FA_OUT_REL_MAX}, relative L2 bound {_FA_OUT_REL_L2})")
    assert good[0] <= _FA_OUT_REL_MAX and good[1] <= _FA_OUT_REL_L2, good
    assert bad[1] > _FA_OUT_REL_L2, bad


def test_flash_kernel_reads_strided_views(cuda):
    """q/k/v sliced out of one fused projection: no copy, same answer."""
    qkv = _randn((2, 256, 4, 192), 3, torch.bfloat16, cuda)
    q, k, v = qkv[..., :64], qkv[..., 64:128], qkv[..., 128:]
    out, lse = fa.flash_attention(q, k, v)
    want_out, want_lse = fa.flash_attention_reference(
        q.contiguous(), k.contiguous(), v.contiguous())
    _assert_flash_out_close(out, want_out)
    torch.testing.assert_close(lse, want_lse, **_FA_LSE_TOL)


def test_flash_kernel_raises_on_what_it_does_not_take(cuda):
    q = torch.zeros((1, 128, 2, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16"):
        fa.flash_attention(q.float(), q.float(), q.float())
    with pytest.raises(ValueError, match="sequences"):
        fa.flash_attention(q[:, :0], q[:, :0], q[:, :0])
    small = torch.zeros((1, 128, 2, 32), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="B, S, H, 64"):
        fa.flash_attention(small, small, small)


# GroupNorm backward. dx: both sides compute in fp32 from the same inputs and
# round once to x's dtype; sums run in another order, so at most one bf16 ulp
# (2**-7 relative) of the largest |dx| separates them. dscale/dbias are fp32
# sums over B*L rows in another order.
def _gn_bwd_case(shape, groups, act, dtype, device):
    x = _randn(shape, 0, dtype, device, shift=3.0)
    g = _randn(shape, 3, dtype, device)
    c = shape[-1]
    scale = _randn((c,), 1, torch.float32, device)
    bias = _randn((c,), 2, torch.float32, device)
    _, mean, rstd = gn.group_norm_cuda(x, scale, bias, groups, 1e-5, act)
    return x, g, scale, bias, mean, rstd


def _assert_close_rel(got, want, rel, rtol):
    atol = rel * want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,groups,act", [
    ((16, 1024, 320), 32, "silu"),
    ((16, 256, 640), 32, None),
    ((16, 1024, 960), 32, "silu"),   # the up-block concat
    ((16, 16, 2560), 32, "silu"),
    ((3, 777, 96), 32, "silu"),      # ragged last chunk, C/G = 3
    ((2, 50, 36), 4, None),          # C % 8 != 0: scalar apply path
    ((4, 4096, 960), 32, "silu"),    # a non-portable cluster (> 8 blocks)
    ((1, 65536, 256), 32, None),     # two launches
])
def test_group_norm_bwd_kernel_matches_plain(cuda, dtype, shape, groups, act):
    x, g, scale, bias, mean, rstd = _gn_bwd_case(shape, groups, act, dtype,
                                                 cuda)
    before = gn.launches_bwd.value
    dx, dscale, dbias = gn.group_norm_bwd_cuda(x, scale, bias, mean, rstd, g,
                                               groups, act)
    torch.cuda.synchronize()
    assert gn.launches_bwd.value == before + 1
    want_dx, want_ds, want_db = gn.group_norm_bwd_reference(
        x, scale, bias, mean, rstd, g, groups, act)
    assert dscale.shape == dbias.shape == (shape[-1],)
    if dtype == torch.bfloat16:
        _assert_close_rel(dx, want_dx, 2 ** -7, 8e-3)
    else:
        _assert_close_rel(dx, want_dx, 1e-5, 1e-4)
    _assert_close_rel(dscale, want_ds, 1e-5, 1e-4)
    _assert_close_rel(dbias, want_db, 1e-5, 1e-4)


# one case per path of the plan, and both sides of the portable cluster size
_GN_PATHS = [
    ((16, 1024, 320), 32, "cluster"),
    ((1, 262144, 128), 32, "split"),     # the VAE decoder's last slab, 512px
    ((2, 50, 36), 4, "generic"),
    ((2, 4096, 320), 32, "cluster"),     # a cluster of 8 in the backward
    ((4, 4096, 960), 32, "cluster"),     # 8 forward, 16 backward blocks
]


@pytest.mark.parametrize("shift", [0.0, 1000.0], ids=["mean0", "mean1000"])
@pytest.mark.parametrize("shape,groups,path", _GN_PATHS)
def test_group_norm_paths_match_plain(cuda, shape, groups, path, shift):
    """Forward and backward on every path of the plan, bf16, at mean 0 and
    mean 1000 (where E[x^2] - E[x]^2 would cancel), within the tolerances
    of the tests above."""
    dtype = torch.bfloat16
    b, l, c = shape
    assert gn.plan(b, l, c, groups, 2).path == path
    x = _randn(shape, 0, dtype, cuda, shift=shift)
    g = _randn(shape, 3, dtype, cuda)
    scale = _randn((c,), 1, torch.float32, cuda)
    bias = _randn((c,), 2, torch.float32, cuda)
    y, mean, rstd = gn.group_norm_cuda(x, scale, bias, groups, 1e-5, "silu")
    want = gn.group_norm_reference(x, scale, bias, groups, 1e-5, "silu")
    torch.testing.assert_close(y.float(), want.float(), **_GN_TOL[dtype])
    want_mean, want_rstd = gn.group_norm_stats_reference(x, groups, 1e-5)
    torch.testing.assert_close(mean, want_mean, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, want_rstd, atol=1e-5, rtol=1e-4)
    dx, dscale, dbias = gn.group_norm_bwd_cuda(x, scale, bias, mean, rstd, g,
                                               groups, "silu")
    want_dx, want_ds, want_db = gn.group_norm_bwd_reference(
        x, scale, bias, mean, rstd, g, groups, "silu")
    _assert_close_rel(dx, want_dx, 2 ** -7, 8e-3)
    _assert_close_rel(dscale, want_ds, 1e-5, 1e-4)
    _assert_close_rel(dbias, want_db, 1e-5, 1e-4)


@pytest.mark.parametrize("shape", [(16, 1024, 960), (1, 65536, 256),
                                   (4, 4096, 960)])
def test_group_norm_bwd_is_deterministic(cuda, shape):
    """dscale and dbias sum over images and blocks in a fixed order (the
    last block to arrive adds the images' sums in image order): two runs
    agree bit for bit, and so does dx."""
    x, g, scale, bias, mean, rstd = _gn_bwd_case(shape, 32, "silu",
                                                 torch.bfloat16, cuda)
    first = gn.group_norm_bwd_cuda(x, scale, bias, mean, rstd, g, 32, "silu")
    torch.cuda.synchronize()
    for _ in range(2):
        again = gn.group_norm_bwd_cuda(x, scale, bias, mean, rstd, g, 32,
                                       "silu")
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def test_group_norm_autograd_on_card(cuda):
    """`group_norm` on CUDA is differentiable through the kernels: fp32
    gradients match autograd of the plain version; a non-contiguous
    cotangent is copied once (counted), never sent to the plain version."""
    x0, _, scale0, bias0, _, _ = _gn_bwd_case((2, 64, 96), 32, "silu",
                                              torch.float32, cuda)
    w = _randn((2, 96, 64), 4, torch.float32, cuda)
    grads = []
    for fn in (gn.group_norm, gn.group_norm_reference):
        x, scale, bias = (t.clone().requires_grad_() for t in (x0, scale0,
                                                              bias0))
        y = fn(x, scale, bias, 32, 1e-5, "silu")
        (y.transpose(1, 2) * w).sum().backward()
        grads.append((x.grad, scale.grad, bias.grad))
    torch.cuda.synchronize()
    for got, want in zip(*grads):
        _assert_close_rel(got, want, 1e-5, 1e-4)
    before = (gn.launches_bwd.value, gn.contiguity_copies.value)
    x = x0.clone().requires_grad_()
    (gn.group_norm(x, scale0, bias0, 32).transpose(1, 2) * w).sum().backward()
    assert gn.launches_bwd.value == before[0] + 1
    assert gn.contiguity_copies.value == before[1] + 1


def test_group_norm_bwd_raises_on_what_it_does_not_take(cuda):
    x, g, scale, bias, mean, rstd = _gn_bwd_case((2, 64, 96), 32, None,
                                                 torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        gn.group_norm_bwd_cuda(x, scale, bias, mean, rstd,
                               g.transpose(1, 2).contiguous().transpose(1, 2),
                               32)
    with pytest.raises(ValueError, match="cotangent"):
        gn.group_norm_bwd_cuda(x, scale, bias, mean, rstd, g.float(), 32)
    with pytest.raises(ValueError, match="groups"):
        gn.group_norm_bwd_cuda(x, scale, bias, mean, rstd, g, 64 + 1)
    with pytest.raises(ValueError, match="mean"):
        gn.group_norm_bwd_cuda(x, scale, bias, mean[:, :8], rstd, g, 32)


# Flash backward. Both sides recompute p from the same lse in fp32, round p
# and ds to bf16 before their products and accumulate in fp32; the outputs
# are one bf16 rounding apart (2**-7 relative of the largest element), plus
# the rare p whose bf16 rounding flips between exp2f and torch.exp.
_FA_BWD_REL, _FA_BWD_RTOL = 2 ** -6, 2e-2


def _flash_bwd_case(b, sq, skv, h, device):
    q = _randn((b, sq, h, 64), 0, torch.bfloat16, device)
    k = _randn((b, skv, h, 64), 1, torch.bfloat16, device)
    v = _randn((b, skv, h, 64), 2, torch.bfloat16, device)
    do = _randn((b, sq, h, 64), 5, torch.bfloat16, device)
    out, lse = fa.flash_attention_cuda(q, k, v)
    return q, k, v, out, lse, do


@pytest.mark.parametrize("b,sq,skv,h", [
    (16, 1024, 1024, 5),              # 256px training, first stage
    (4, 4096, 4096, 5),               # 512px, first stage
    (1, 128, 320, 3),                 # cross lengths, several tiles
    (1, 192, 320, 3),                 # a ragged last key block
])
def test_flash_bwd_kernel_matches_plain(cuda, b, sq, skv, h):
    q, k, v, out, lse, do = _flash_bwd_case(b, sq, skv, h, cuda)
    before = (fa.launches_bwd_dq.value, fa.launches_bwd_dkv.value)
    got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    assert (fa.launches_bwd_dq.value, fa.launches_bwd_dkv.value) == (
        before[0] + 1, before[1] + 1)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == w.shape and a.dtype == torch.bfloat16, name
        _assert_close_rel(a, w, _FA_BWD_REL, _FA_BWD_RTOL)
    again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do)
    for a, w in zip(got, again):                      # no atomics
        assert torch.equal(a, w)


@pytest.mark.parametrize("b,sq,skv,h", [
    (1, 192, 320, 3),                 # a ragged q block and key tile
    (2, 128, 192, 4),                 # a ragged last key tile
])
def test_flash_bwd_dq_kernel_with_strongly_negative_lse(cuda, b, sq, skv, h):
    """q near -5 and k near +5: every score is near -200 and every row's lse
    below -100, so a padded key's p = exp(0 - lse) would overflow to inf
    and meet its zero K row as NaN; the kernel's 64-key tiles hold no
    padded key, and its rows past Sq read no lse."""
    q = _randn((b, sq, h, 64), 10, torch.bfloat16, cuda, shift=-5.0)
    k = _randn((b, skv, h, 64), 11, torch.bfloat16, cuda, shift=5.0)
    v = _randn((b, skv, h, 64), 12, torch.bfloat16, cuda)
    do = _randn((b, sq, h, 64), 13, torch.bfloat16, cuda)
    out, lse = fa.flash_attention_cuda(q, k, v)
    assert lse.max().item() < -100
    before = fa.launches_bwd_dq.value
    dq, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    assert fa.launches_bwd_dq.value == before + 1
    assert torch.isfinite(dq).all()
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do)[0]
    _assert_close_rel(dq, want, _FA_BWD_REL, _FA_BWD_RTOL)
    # fp32 sums of the same products in another order
    prod = do.float() * out.float()
    err = (delta - prod.sum(-1).transpose(1, 2)).abs()
    assert (err <= 1e-5 * prod.abs().sum(-1).transpose(1, 2)).all()
    again, again_delta = fa.flash_attention_bwd_dq_cuda(q, k, v, out, lse, do)
    assert torch.equal(dq, again) and torch.equal(delta, again_delta)


_TAIL_SHAPES = [
    (1, 4250, 4250, 24),              # MMDiT's joint attention at 1,024px
    (1, 4096, 4250, 4),               # its last block: image queries only
    (2, 300, 277, 2),                 # both lengths ragged, a short tail
    (1, 1025, 1089, 3),               # one row and one key past a tile
]


@pytest.mark.parametrize("b,sq,skv,h", _TAIL_SHAPES)
def test_flash_tail_kernels_match_plain(cuda, b, sq, skv, h):
    """Lengths that are not multiples of 64: the forward, dQ and dK/dV
    kernels mask the ragged last tile, match the plain versions within the
    whole-tile bounds, and count each launch in its tail counter."""
    q, k, v, _, _, do = _flash_bwd_case(b, sq, skv, h, cuda)
    tails = (fa.launches_tail, fa.launches_bwd_dq_tail,
             fa.launches_bwd_dkv_tail)
    before = [c.value for c in tails]
    out, lse = fa.flash_attention_cuda(q, k, v)
    got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    assert [c.value for c in tails] == [n + 1 for n in before]
    want_out, want_lse = fa.flash_attention_reference(q, k, v)
    _assert_flash_out_close(out, want_out)
    torch.testing.assert_close(lse, want_lse, **_FA_LSE_TOL)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == w.shape and torch.isfinite(a).all(), name
        _assert_close_rel(a, w, _FA_BWD_REL, _FA_BWD_RTOL)
    again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do)
    for a, w in zip(got, again):                      # no atomics
        assert torch.equal(a, w)


@pytest.mark.parametrize("b,sq,skv,h", [(1, 300, 277, 3), (2, 1025, 1089, 2)])
def test_flash_tail_bwd_with_strongly_negative_lse(cuda, b, sq, skv, h):
    """Every lse below -100: a padded key's p = exp(0 - lse) would be inf
    against its zero K row, and a padded query's against its zero Q and dO
    rows; the tail kernels give those dS = 0, so dQ, dK and dV stay finite
    and match the plain backward."""
    q = _randn((b, sq, h, 64), 10, torch.bfloat16, cuda, shift=-5.0)
    k = _randn((b, skv, h, 64), 11, torch.bfloat16, cuda, shift=5.0)
    v = _randn((b, skv, h, 64), 12, torch.bfloat16, cuda)
    do = _randn((b, sq, h, 64), 13, torch.bfloat16, cuda)
    out, lse = fa.flash_attention_cuda(q, k, v)
    assert lse.max().item() < -100
    got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(a).all(), name
        _assert_close_rel(a, w, _FA_BWD_REL, _FA_BWD_RTOL)


def test_flash_bwd_op_launches_one_dq_and_one_dkv(cuda):
    """The backward's dispatcher op (what autograd and a FLOP count see)
    on CUDA tensors: one dQ and one dK/dV launch, the wrapper's results,
    the same from a strided cotangent."""
    q, k, v, out, lse, do = _flash_bwd_case(2, 1024, 1024, 5, cuda)
    before = (fa.launches_bwd_dq.value, fa.launches_bwd_dkv.value)
    got = fa.flash_attention_bwd_op(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    assert (fa.launches_bwd_dq.value, fa.launches_bwd_dkv.value) == (
        before[0] + 1, before[1] + 1)
    want = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    wide = torch.zeros((*do.shape[:3], 128), device=cuda,
                       dtype=do.dtype)
    wide[..., 32:96] = do
    strided = fa.flash_attention_bwd_op(q, k, v, out, lse, wide[..., 32:96])
    for a, w in zip(strided, want):
        assert torch.equal(a, w)


def test_flash_bwd_kernel_reads_strided_views(cuda):
    qkv = _randn((2, 256, 4, 192), 3, torch.bfloat16, cuda)
    q, k, v = qkv[..., :64], qkv[..., 64:128], qkv[..., 128:]
    out, lse = fa.flash_attention_cuda(q, k, v)
    do = _randn((2, 256, 4, 128), 6, torch.bfloat16, cuda)[..., 32:96]
    got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do)
    want = fa.flash_attention_bwd_reference(
        q.contiguous(), k.contiguous(), v.contiguous(), out, lse,
        do.contiguous())
    for a, w in zip(got, want):
        _assert_close_rel(a, w, _FA_BWD_REL, _FA_BWD_RTOL)


def test_flash_autograd_on_card(cuda):
    """`flash_attention` on CUDA backpropagates through the two kernels and
    gives what the backward wrapper gives."""
    q, k, v, out, lse, do = _flash_bwd_case(2, 1024, 1024, 5, cuda)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = fa.launches_bwd_dkv.value
    got_out, got_lse = fa.flash_attention(*leaves)
    got_out.backward(do)
    assert fa.launches_bwd_dkv.value == before + 1
    assert torch.equal(got_out, out) and torch.equal(got_lse, lse)
    want = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


def test_flash_bwd_kernel_raises_on_what_it_does_not_take(cuda):
    q, k, v, out, lse, do = _flash_bwd_case(1, 128, 128, 2, cuda)
    with pytest.raises(ValueError, match="bf16"):
        fa.flash_attention_bwd_cuda(q, k, v, out, lse, do.float())
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd_cuda(q, k, v, out, lse.double(), do)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd_cuda(q, k, v, out, lse[:, :, :64], do)
    with pytest.raises(ValueError, match="must match"):
        fa.flash_attention_bwd_cuda(q, k, v, out[:, :64], lse, do[:, :64])


# the fused AdamW (+ EMA) kernel's list: 1-element, odd-length and
# non-multiple-of-4 tensors, one of several million values, and (last) a
# view 4 bytes past a 16-byte boundary, which takes the scalar path
_ADAMW_SHAPES = [(1,), (7,), (1023,), (3, 333), (2_000_003, 2), (129, 65),
                 (4099,)]


def _adamw_list(seed, device, dtype=torch.float32, scale=1.0):
    out = []
    for i, shape in enumerate(_ADAMW_SHAPES):
        x = _randn(shape, seed * 100 + i, torch.float32, device) * scale
        if i < len(_ADAMW_SHAPES) - 1:
            out.append(x.to(dtype))
            continue
        buf = torch.empty(x.numel() + 1, device=device, dtype=dtype)
        view = buf[1:].view(shape)
        view.copy_(x)
        assert view.data_ptr() % 16 == buf.element_size()
        out.append(view)
    return out


@pytest.mark.parametrize("clip", [False, True], ids=["noclip", "clip"])
@pytest.mark.parametrize("smoothing", [None, 0.0, 0.9999],
                         ids=["noema", "ema0", "ema0.9999"])
@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16],
                         ids=["mu32", "mubf16"])
def test_adamw_kernel_matches_plain(cuda, mu_dtype, smoothing, clip):
    """Three updates by the kernel against the plain version's foreach
    passes from the same state: p, mu, nu and the EMA bit for bit. Two
    foreach operators round otherwise than one operation at a time, and
    the kernel rounds as they do: `_foreach_div(mu, bc1)` (and nu's) is a
    product with bc's fp32 reciprocal, and `_foreach_add_(ema, params,
    alpha=1 - s)` one fused multiply-add."""
    from diffusion_torch.ops import adamw as ka
    from diffusion_torch.train.optim import _bias_correction, global_norm

    sides = []
    for fn in (ka.adamw_cuda, ka.adamw_reference):
        p = _adamw_list(0, cuda)
        mu = _adamw_list(1, cuda, mu_dtype, scale=0.01)
        nu = _adamw_list(2, cuda)
        for v in nu:
            v.abs_().mul_(1e-4)
        ema = None
        if smoothing is not None:
            # an EMA that tracks the weights
            ema = _adamw_list(3, cuda)
            for e, w in zip(ema, p):
                e.mul_(0.01).add_(w)
        for step in range(1, 4):
            g = _adamw_list(10 + step, cuda, scale=0.1 * step)
            norm = global_norm(g)
            c = float(norm) * (0.5 if clip else 2.0)
            before = ka.launches.value
            fn(p, g, mu, nu, ema, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
               weight_decay=0.01, bc1=_bias_correction(0.9, step),
               bc2=_bias_correction(0.999, step), grad_norm=norm, clip=c,
               smoothing=1.0 if smoothing is None else smoothing)
            torch.cuda.synchronize()
            if fn is ka.adamw_cuda:
                assert ka.launches.value == before + 1
        sides.append((p, mu, nu, ema))
    (p, mu, nu, ema), (p0, mu0, nu0, ema0) = sides
    for got, want in ((p, p0), (mu, mu0), (nu, nu0)):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
    if ema is not None:
        for a, b in zip(ema, ema0):
            assert torch.equal(a, b)


def test_adamw_kernel_splits_long_lists(cuda):
    """600 tensors take two launches (512 a launch at most), equal to the
    plain version bit for bit."""
    from diffusion_torch.ops import adamw as ka

    def make(seed):
        x = _randn((600, 37), seed, torch.float32, cuda)
        return [r.clone() for r in x]

    kw = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
              bc1=0.1, bc2=0.001)
    sides = []
    for fn in (ka.adamw_cuda, ka.adamw_reference):
        p, g, mu, nu = make(0), make(1), make(2), [v.abs() for v in make(3)]
        before = ka.launches.value
        fn(p, g, mu, nu, **kw)
        torch.cuda.synchronize()
        sides.append((p, mu, nu, ka.launches.value - before))
    assert sides[0][3] == 2 and sides[1][3] == 0
    for got, want in zip(sides[0][:3], sides[1][:3]):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_adamw_kernel_raises_on_what_it_does_not_take(cuda):
    from diffusion_torch.ops import adamw as ka

    def lists():
        return [[torch.ones(5, device=cuda)] for _ in range(4)]

    kw = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
              bc1=0.1, bc2=0.001)
    p, g, mu, nu = lists()
    with pytest.raises(ValueError, match="fp32 or bf16"):
        ka.adamw_cuda(p, g, [mu[0].half()], nu, **kw)
    with pytest.raises(ValueError, match="grads"):
        ka.adamw_cuda(p, [g[0].cpu()], mu, nu, **kw)
    with pytest.raises(ValueError, match="not contiguous"):
        ka.adamw_cuda(p, g, mu, [torch.ones(10, device=cuda)[::2]], **kw)
    with pytest.raises(ValueError, match="params"):
        ka.adamw_cuda([p[0].double()], g, mu, nu, **kw)
    with pytest.raises(ValueError, match="size of its parameter"):
        ka.adamw_cuda(p, [torch.ones(6, device=cuda)], mu, nu, **kw)
    with pytest.raises(ValueError, match="norm"):
        ka.adamw_cuda(p, g, mu, nu, clip=1.0, **kw)


def test_tiny_trainer_on_card_matches_cpu(cuda):
    """Two steps of the port's Trainer on the tiny model (fp32: every
    GroupNorm forward and backward runs the kernels inside autograd) on the
    card, against the same run on the CPU with the plain versions: same
    weights, batches and draws."""
    from diffusion_torch.models.models import stable_diffusion_tiny
    from diffusion_torch.train.optim import adamw
    from diffusion_torch.train.trainer import Trainer

    rng = np.random.default_rng(0)
    batches = [{"image_latents": rng.standard_normal((4, 8, 8, 4)).astype(
                    np.float32),
                "caption_latents": rng.standard_normal((4, 8, 32)).astype(
                    np.float32)} for _ in range(2)]
    draws = {(s, i): (rng.standard_normal((2, 8, 8, 4)).astype(np.float32),
                      rng.integers(0, 1000, 2))
             for s in range(2) for i in range(2)}

    def hook(step, micro, n_accum, mb):
        noise, t = draws[(step, micro)]
        return torch.from_numpy(noise), torch.from_numpy(t)

    from diffusion_torch.train.events import Callback

    class Record(Callback):
        def __init__(self):
            self.metrics = []

        def batch_end(self, state, logger):
            self.metrics.append({k: float(v) for k, v in state.metrics.items()})

    params, metrics = [], []
    for device in ("cpu", cuda):
        model = stable_diffusion_tiny(device=device, precomputed_latents=True)
        if params:     # CPU and CUDA generators draw different weights
            model.unet.load_state_dict(initial)
        else:
            initial = {k: v.clone() for k, v in model.unet.state_dict().items()}
        before = gn.launches_bwd.value
        record = Record()
        # eps=1: an update smooth in g (Adam's first step with eps=1e-8 is
        # ~sign(g), which flips where g is at the summation-order noise)
        Trainer(model=model, train_dataloader=batches,
                optimizers=adamw(lr=1e-3, eps=1.0), callbacks=[record],
                max_duration="2ba", device_train_microbatch_size=2,
                device=device, noise_hook=hook).fit()
        torch.cuda.synchronize()
        if device == cuda:
            assert gn.launches_bwd.value > before
        metrics.append(record.metrics)
        params.append({n: p.detach().cpu()
                       for n, p in model.unet.named_parameters()})
    # fp32 on both (TF32 off): the kernels and cuDNN/cuBLAS sum in another
    # order than the CPU
    for got, want in zip(*metrics[::-1]):
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-4), k
    for name, want in params[0].items():
        torch.testing.assert_close(params[1][name], want, atol=1e-6,
                                   rtol=1e-5)


@pytest.mark.parametrize("dtype,shape", [
    (torch.float32, (2, 1024, 5, 64)),    # fp32 SD2 first stage at 256px
    (torch.float32, (1, 4096, 5, 64)),    # fp32 SD2 first stage at 512px
    (torch.float32, (2, 1024, 5, 128)),
    (torch.bfloat16, (2, 1024, 5, 128)),  # head dim 128
    (torch.float16, (2, 1024, 5, 64)),
])
def test_attention_dispatch_takes_plain_math_where_no_kernel(cuda, dtype,
                                                             shape):
    """What the flash kernels do not take (fp32, fp16, head dim 128) runs
    on plain math on the card without a launch, and matches it."""
    from diffusion_torch.ops import attention as attn
    q, k, v = (_randn(shape, s, dtype, cuda) for s in range(3))
    before = fa.launches.value
    out = attn.multi_head_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.launches.value == before
    assert out.dtype == dtype and out.shape == q.shape
    want = attn._xla_attention(q, k, v, None)
    assert torch.equal(out, want)
    ref = torch.nn.functional.scaled_dot_product_attention(
        *(t.double().transpose(1, 2) for t in (q, k, v))).transpose(1, 2)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.double(), ref, atol=tol, rtol=tol)


def test_attention_dispatch_launches_the_kernel_in_bf16(cuda):
    from diffusion_torch.ops import attention as attn
    q, k, v = (_randn((2, 1024, 5, 64), s, torch.bfloat16, cuda)
               for s in range(3))
    before = fa.launches.value
    out = attn.multi_head_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.launches.value == before + 1
    _assert_flash_out_close(out, fa.flash_attention_reference(q, k, v)[0])


@pytest.mark.parametrize("tower", ["inception", "clip"])
def test_metric_towers_on_card_match_cpu(cuda, tower):
    """The full-width metric towers (random weights, seed 0) on the card
    against fp32 CPU copies of themselves on 2 images, TF32 off: relative
    L2 within 1e-3 (InceptionV3 features and logits; CLIP image and text
    embeddings). Neither runs a hand-written kernel: the towers are fp32,
    and the attention dispatch keeps fp32 on plain math."""
    import copy

    from diffusion_torch.metrics import towers
    from diffusion_torch.models.inception import preprocess_images

    gen = torch.Generator().manual_seed(0)
    images = torch.rand((2, 256, 256, 3), generator=gen)
    ids = torch.randint(1, 49000, (2, 77), generator=gen)
    ids[:, 9] = 49407
    if tower == "inception":
        model = towers.inception_tower(allow_random_weights=True,
                                       device=cuda)

        def run(m, dev):
            x = preprocess_images(images.to(dev))
            return m(x), m(x, return_logits=True)
    else:
        model = towers.clip_tower(allow_random_weights=True, device=cuda)

        def run(m, dev):
            return m(ids.to(dev), towers.clip_pixels(images.to(dev), 224))
    before = fa.launches.value
    with torch.inference_mode():
        got = run(model, cuda)
        want = run(copy.deepcopy(model).to("cpu"), "cpu")
    assert fa.launches.value == before
    for g, w in zip(got, want):
        g = g.float().cpu()
        assert torch.isfinite(g).all()
        assert float((g - w).norm() / w.norm()) <= 1e-3


def test_metric_towers_release_card_memory(cuda, tmp_path):
    """Port fault 13 on the card: the full-width InceptionV3 and CLIP
    ViT-L/14 (random, fp32, about 1.8 GB) of a Trainer's generation-metric
    hook, and of the offline eval job, are freed once the Trainer is
    closed and once the job returns: `memory_allocated` comes back within
    64 MiB of its value before."""
    import gc
    import io

    from PIL import Image

    from diffusion_torch.data.coco import build_streaming_cocoval_dataloader
    from diffusion_torch.data.mds import MDSWriter
    from diffusion_torch.models.models import stable_diffusion_tiny
    from diffusion_torch.scripts import fid_clip_evaluation
    from diffusion_torch.train.trainer import Evaluator, Trainer

    coco = str(tmp_path / "coco")
    rng = np.random.default_rng(0)
    with MDSWriter(coco, {"image": "bytes", "captions": "json"}) as w:
        for i in range(4):
            buf = io.BytesIO()
            Image.fromarray(rng.integers(0, 255, (40, 48, 3), np.uint8)).save(
                buf, format="JPEG")
            w.write({"image": buf.getvalue(), "captions": [f"photo {i}"]})

    def allocated():
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated(cuda)

    before = allocated()
    model = stable_diffusion_tiny(
        device=cuda, val_guidance_scales=[3.0], allow_random_tower_weights=True,
        val_metrics=["FrechetInceptionDistance", "InceptionScore",
                     "CLIPScore"])
    loader = build_streaming_cocoval_dataloader(remote=coco, batch_size=4,
                                                resize_size=32, num_workers=0)
    trainer = Trainer(model=model, device=cuda, image_size=32,
                      max_duration="1ba",
                      eval_dataloader=[Evaluator("coco-val", loader,
                                                 model.val_metric_names)])
    with_towers = allocated()
    assert with_towers - before > 1 << 30          # the two fp32 towers
    trainer.close()
    del model, loader
    assert abs(allocated() - before) <= 64 << 20, "towers kept after close"
    del trainer
    before = allocated()
    fid_clip_evaluation.main([
        "--remote", coco, "--allow_random_towers", "--size", "32",
        "--batch_size", "4", "--num_inference_steps", "2",
        "--subset_num_batches", "1", "--builder",
        "diffusion_torch.models.models.stable_diffusion_tiny",
        "--out", str(tmp_path / "eval.jsonl")])
    assert abs(allocated() - before) <= 64 << 20, "towers kept after the job"


# --------------------------------------------- sequence parallelism's modes


def _sp_gn_case(device, shape=(2, 4096, 320)):
    """bf16 x, scale near 1 and a cotangent whose per-group mean runs along
    the rows (an offset per group times a ramp), so the per-group sums of
    the backward are of order 1 and each row shard's differ from the
    whole's."""
    b, l, c = shape
    x = _randn(shape, 0, torch.bfloat16, device)
    ramp = torch.linspace(-1.0, 2.0, l, device=device)[None, :, None]
    offset = _randn((1, 1, 32), 5, torch.float32, device).repeat_interleave(
        c // 32, -1)
    g = (_randn(shape, 3, torch.float32, device)
         + offset * ramp).to(torch.bfloat16)
    scale = 1 + 0.1 * _randn((c,), 1, torch.float32, device)
    bias = 0.1 * _randn((c,), 2, torch.float32, device)
    return x, g, scale, bias


def _sp_bwd(xs, gs, scale, bias, mean, rstd, own_only=False):
    """The backward stages over row shards; with `own_only`, stage 2 gets
    only its own shard's per-group sums (a merge left out)."""
    sums = [gn.group_norm_bwd_partials_cuda(x, scale, bias, mean, rstd, g,
                                            32, "silu")
            for x, g in zip(xs, gs)]
    gparts = torch.stack([gp for _, gp in sums])
    return [gn.group_norm_bwd_apply_cuda(
        x, scale, bias, mean, rstd, g, cp,
        gparts[r:r + 1].contiguous() if own_only else gparts, 32, "silu")
        for r, (x, g, (cp, _)) in enumerate(zip(xs, gs, sums))]


def _sp_dx_excess(dxs, xs, gs, scale, bias, mean, rstd):
    """The largest error of the shards' bf16 dx against the plain stages in
    fp32 on the same inputs, over its bound: bf16 rounding of dx (2^-8 of
    it) plus twice 2^-14 of the terms rstd (|scale dz| + |m1| + |x-hat m2|)
    that the fp32 dx adds (per-group sums in another order)."""
    xf, gf = [x.float() for x in xs], [g.float() for g in gs]
    sums = [gn.group_norm_bwd_partials_reference(x, scale, bias, mean, rstd,
                                                 g, 32, "silu")
            for x, g in zip(xf, gf)]
    gparts = torch.stack([gp for _, gp in sums])
    count = sum(x.shape[1] for x in xs) * (xs[0].shape[-1] // 32)
    m = (gparts.sum(dim=(0, 2)) / count)[:, None, :, None]   # (B, 1, G, 1, 2)
    worst = 0.0
    for dx, x, g, (cp, _) in zip(dxs, xf, gf, sums):
        ref = gn.group_norm_bwd_apply_reference(x, scale, bias, mean, rstd,
                                                g, cp, gparts, 32, "silu")[0]
        dz, xhat, sc = gn._dz_xhat(x, scale, bias, mean, rstd, g, 32, "silu")
        term = (rstd[:, None, :, None] * ((dz * sc).abs() + m[..., 0].abs()
                                          + (xhat * m[..., 1]).abs())
                ).reshape(x.shape)
        tol = 2.0 ** -8 * ref.abs() + 2.0 ** -13 * term
        worst = max(worst, ((dx.float() - ref).abs() / tol).max().item())
    return worst


@pytest.mark.parametrize("n", [1, 4])
def test_sp_group_norm_stages_match_plain(cuda, n):
    """The sp GroupNorm stages over n row shards: stage 2's statistics and
    y against the one-call kernel's, mean and rstd as tensors of their own
    (the sp op returns both); each shard's dx within its bf16 bound of the
    plain fp32 stages, and a stage 2 fed only its own shard's sums far
    outside it where n > 1."""
    x, g, scale, bias = _sp_gn_case(cuda)
    xs, gs = ([t.contiguous() for t in u.chunk(n, dim=1)] for u in (x, g))
    y, mean, rstd = gn.group_norm_cuda(x, scale, bias, 32, 1e-5, "silu")
    parts = torch.stack([gn.group_norm_partials_cuda(t, 32) for t in xs])
    ys = [gn.group_norm_apply_cuda(t, scale, bias, parts, 32, 1e-5, "silu")
          for t in xs]
    for y_r, m_r, r_r in ys:
        assert m_r.untyped_storage().data_ptr() \
            != r_r.untyped_storage().data_ptr()
        torch.testing.assert_close(m_r, mean, atol=1e-4, rtol=0)
        torch.testing.assert_close(r_r, rstd, atol=0, rtol=1e-4)
    torch.testing.assert_close(torch.cat([a for a, _, _ in ys], 1).float(),
                               y.float(), **_GN_TOL[torch.bfloat16])
    dxs = [dx for dx, _, _ in _sp_bwd(xs, gs, scale, bias, mean, rstd)]
    assert _sp_dx_excess(dxs, xs, gs, scale, bias, mean, rstd) <= 1.0
    if n > 1:
        own = [dx for dx, _, _ in _sp_bwd(xs, gs, scale, bias, mean, rstd,
                                          own_only=True)]
        assert _sp_dx_excess(own, xs, gs, scale, bias, mean, rstd) > 100.0


def test_sp_ops_on_a_one_rank_nccl_group(cuda, tmp_path):
    """`group_norm(shard=)` and `ring_attention` as the Trainer calls them
    under sp, on a one-rank NCCL group: the dispatcher ops, their autograd,
    the all-gather of the partials and the ring's loop run the kernels
    (launches counted) and agree with the one-call kernels."""
    import torch.distributed as dist

    from diffusion_torch.ops.ring_attention import ring_attention
    from diffusion_torch.parallel.sharding import RowShard, register_group

    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        shard = RowShard(register_group(dist.group.WORLD), 0, 1)
        x0, g, scale0, bias0 = _sp_gn_case(cuda)
        grads = []
        for sp in (shard, None):
            x, scale, bias = (t.clone().requires_grad_() for t in
                              (x0, scale0, bias0))
            before = (gn.launches.value, gn.launches_bwd.value)
            y = gn.group_norm(x, scale, bias, 32, 1e-5, "silu", shard=sp)
            y.backward(g)
            n = 2 if sp is not None else 1
            assert (gn.launches.value - before[0],
                    gn.launches_bwd.value - before[1]) == (n, n)
            grads.append((y.detach(), x.grad, scale.grad, bias.grad))
        (y, dx, ds, db), (y1, dx1, ds1, db1) = grads
        torch.testing.assert_close(y.float(), y1.float(),
                                   **_GN_TOL[torch.bfloat16])
        _assert_close_rel(dx, dx1, 2 ** -7, 8e-3)
        _assert_close_rel(ds, ds1, 1e-5, 1e-4)
        _assert_close_rel(db, db1, 1e-5, 1e-4)

        q, k, v, out, lse, do = _flash_bwd_case(1, 1024, 1024, 2, cuda)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = (fa.launches.value, fa.launches_bwd_dq.value,
                  fa.launches_bwd_dkv.value)
        o = ring_attention(*leaves, shard)
        o.backward(do)
        assert (fa.launches.value - before[0],
                fa.launches_bwd_dq.value - before[1],
                fa.launches_bwd_dkv.value - before[2]) == (1, 1, 1)
        assert torch.equal(o, out)
        want = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do)
        for leaf, w in zip(leaves, want):
            _assert_close_rel(leaf.grad, w, _FA_BWD_REL, _FA_BWD_RTOL)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("heads,tokens", [(10, 1024), (5, 4096)])
def test_tp_attention_shards_match_the_whole(cuda, heads, tokens):
    """SD2's 10-head and 5-head self-attention at 512px (64 x heads
    channels, batch 2, bf16) as tp = 2 shards in one process
    (`chip_smoke.py::tp_local_twin`: the partials summed where `tp_reduce`
    would) against the whole layer through the kernels: the 10-head
    layer's shards run the flash kernel on 5 heads each, within two bf16
    ulps of the largest output, input gradient and weight gradient; the
    5-head layer stays whole (the head gate) and equals itself bit for
    bit."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    from chip_smoke import tp_local_twin, tp_twin_grads
    from diffusion_torch.models.layers import Attention, init_like_flax_

    gen = torch.Generator(device=cuda).manual_seed(0)
    channels = 64 * heads
    layer = Attention(channels, heads, 64).to(cuda)
    init_like_flax_(layer, gen)
    with torch.no_grad():
        layer.to_out[0].bias.normal_(0, 0.1, generator=gen)
    twin = tp_local_twin(layer, 2, 64)
    x = _randn((2, tokens, channels), 0, torch.bfloat16, cuda)
    dy = _randn((2, tokens, channels), 1, torch.bfloat16, cuda)
    got = []
    for m in (layer, twin):
        xi = x.clone().requires_grad_()
        before = fa.launches.value
        y = m(xi)
        calls = fa.launches.value - before
        y.backward(dy)
        grads = (tp_twin_grads(m) if m is twin else
                 {n: p.grad for n, p in m.named_parameters()})
        got.append((y.detach(), xi.grad, grads, calls))
    (y1, dx1, g1, n1), (y2, dx2, g2, n2) = got
    if heads % 2:
        assert twin is not layer and n2 == n1 == 1
        assert torch.equal(y2, y1) and torch.equal(dx2, dx1)
        return
    assert (n1, n2) == (1, 2)
    assert sorted(g2) == sorted(g1)
    for a, b in [(y2, y1), (dx2, dx1)] + [(g2[n], g1[n]) for n in g1]:
        bound = 2.0 ** -6 * b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= bound
