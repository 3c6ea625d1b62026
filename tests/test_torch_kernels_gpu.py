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
    with pytest.raises(ValueError, match="multiples of 64"):
        fa.flash_attention(q[:, :100], q[:, :100], q[:, :100])
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
