"""The port's GroupNorm, forward and backward (plain PyTorch versions, what
the CPU runs) against the JAX package: its Pallas `_fwd_kernel` and
`_bwd_kernel` in interpret mode and its two-pass XLA path. The kernel on the card is held to this same plain
version by tests/test_torch_kernels_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_tpu.ops import groupnorm as jgn
from diffusion_torch.ops import groupnorm as tgn

torch.set_num_threads(1)

_INTERPRET = "DIFFUSION_TPU_PALLAS_INTERPRET"


def _inputs(shape, seed, shift=0.0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.standard_normal(shape) + shift).astype(np.float32)
    scale = rng.standard_normal(c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    return x, scale, bias


def _port(x, scale, bias, groups, eps, act):
    return tgn.group_norm(torch.from_numpy(x), torch.from_numpy(scale),
                          torch.from_numpy(bias), groups, eps, act).numpy()


def _jax(x, scale, bias, groups, eps, act):
    return np.asarray(jgn.group_norm(jnp.asarray(x), jnp.asarray(scale),
                                     jnp.asarray(bias), groups, eps, act))


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("c,groups", [(64, 8), (64, 32), (96, 8), (96, 32)])
def test_matches_pallas_kernel(monkeypatch, c, groups, act):
    monkeypatch.setenv(_INTERPRET, "1")
    monkeypatch.delenv("DIFFUSION_TPU_GN", raising=False)
    assert jgn._pallas_usable(64, c, groups)      # really the Pallas kernel
    x, scale, bias = _inputs((2, 64, c), seed=c + groups)
    want = _jax(x, scale, bias, groups, 1e-5, act)
    got = _port(x, scale, bias, groups, 1e-5, act)
    # fp32 both ways; one-pass vs two-pass variance on unit-scale data and
    # another summation order differ by a few fp32 ulps of |y| <= ~10
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_stats_match_pallas_kernel(monkeypatch):
    """mean/rstd (B, G), which the kernel writes for the backward."""
    monkeypatch.setenv(_INTERPRET, "1")
    x, scale, bias = _inputs((2, 64, 96), seed=5)
    _, mean, rstd = jgn._fwd(jnp.asarray(x), jnp.asarray(scale)[None],
                             jnp.asarray(bias)[None], 32, 1e-5, False)
    got_mean, got_rstd = tgn.group_norm_stats_reference(torch.from_numpy(x),
                                                        32, 1e-5)
    np.testing.assert_allclose(got_mean.numpy(), np.asarray(mean)[:, 0],
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got_rstd.numpy(), np.asarray(rstd)[:, 0],
                               atol=1e-5, rtol=1e-5)


def test_large_mean_matches_two_pass_xla(monkeypatch):
    """Where the Pallas kernel's one-pass E[x^2]-E[x]^2 cancels (mean 1000,
    unit variance), the port agrees with JAX's two-pass `_xla_group_norm`,
    the path its tolerances are set against."""
    monkeypatch.setenv(_INTERPRET, "1")
    x, scale, bias = _inputs((2, 64, 96), seed=7, shift=1000.0)
    want = np.asarray(jgn._xla_group_norm(jnp.asarray(x), jnp.asarray(scale),
                                          jnp.asarray(bias), 32, 1e-5, True))
    got = _port(x, scale, bias, 32, 1e-5, "silu")
    # ulp(1000) = 6e-5: the fp32 group means carry ~1e-4 of summation-order
    # error, scaled by |scale| (up to ~3) into y
    np.testing.assert_allclose(got, want, atol=3e-3, rtol=0)
    one_pass = _jax(x, scale, bias, 32, 1e-5, "silu")
    assert np.abs(one_pass - want).max() > 0.1    # the kernel's cancellation


def test_ragged_channels_raise_on_both_sides(monkeypatch):
    """C % G != 0: JAX routes it to `_xla_group_norm`, whose group reshape
    fails; the port refuses it up front."""
    monkeypatch.setenv(_INTERPRET, "1")
    x, scale, bias = _inputs((2, 64, 36), seed=9)
    assert not jgn._pallas_usable(64, 36, 8)
    calls = []
    real = jgn._xla_group_norm

    def spy(*args):
        calls.append(args[3])
        return real(*args)

    monkeypatch.setattr(jgn, "_xla_group_norm", spy)
    with pytest.raises(TypeError, match="reshape"):
        _jax(x, scale, bias, 8, 1e-5, None)
    assert calls == [8]                            # the XLA path was taken
    with pytest.raises(ValueError, match="groups"):
        _port(x, scale, bias, 8, 1e-5, None)
    with pytest.raises(ValueError, match="groups"):
        tgn.group_norm_reference(torch.from_numpy(x), torch.from_numpy(scale),
                                 torch.from_numpy(bias), 8)


def test_dispatch_by_device():
    """CPU tensors take the plain version; the kernel wrapper refuses them;
    other devices are refused."""
    x, scale, bias = (torch.from_numpy(a) for a in _inputs((2, 8, 32), 1))
    torch.testing.assert_close(
        tgn.group_norm(x, scale, bias, 8, 1e-5, "silu"),
        tgn.group_norm_reference(x, scale, bias, 8, 1e-5, "silu"),
        rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        tgn.group_norm_cuda(x, scale, bias, 8)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tgn.group_norm(x.to("meta"), scale, bias, 8)
    with pytest.raises(ValueError, match="activation"):
        tgn.group_norm(x, scale, bias, 8, act="gelu")


# ---------------------------------------------------------------- backward


def _bwd_inputs(c, groups, seed):
    x, scale, bias = _inputs((2, 64, c), seed=seed)
    g = np.random.default_rng(seed + 1).standard_normal(x.shape).astype(
        np.float32)
    return x, scale, bias, g


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)   # copies


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("c,groups", [(64, 8), (64, 32), (96, 8), (96, 32)])
def test_bwd_matches_pallas_kernel(monkeypatch, c, groups, act):
    """The plain backward against the Pallas `_bwd_kernel` in interpret
    mode, both given the Pallas forward's (mean, rstd); the kernel's
    per-image dscale/dbias partials are summed here."""
    monkeypatch.setenv(_INTERPRET, "1")
    x, scale, bias, g = _bwd_inputs(c, groups, seed=c * groups)
    jx, js, jb = jnp.asarray(x), jnp.asarray(scale)[None], jnp.asarray(bias)[None]
    _, mean, rstd = jgn._fwd(jx, js, jb, groups, 1e-5, act == "silu")
    dx, ds_p, db_p = jgn._bwd(jx, js, jb, mean, rstd, jnp.asarray(g), groups,
                              act == "silu")
    got_dx, got_ds, got_db = tgn.group_norm_bwd_reference(
        *_t(x, scale, bias, np.asarray(mean)[:, 0], np.asarray(rstd)[:, 0], g),
        groups, act)
    assert got_ds.shape == got_db.shape == (c,)
    # fp32 both ways, same statistics; sums over 64 rows (dx's m1/m2) and
    # 128 rows (dscale/dbias) in another order
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(dx),
                               atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(got_ds.numpy(), np.asarray(ds_p).sum((0, 1)),
                               atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(got_db.numpy(), np.asarray(db_p).sum((0, 1)),
                               atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("c,groups", [(64, 8), (96, 32)])
def test_grad_matches_xla_vjp(monkeypatch, c, groups, act):
    """`group_norm`'s gradient (the autograd function with the plain
    backward) against `jax.grad` of the two-pass `_xla_group_norm`."""
    monkeypatch.setenv(_INTERPRET, "0")
    x, scale, bias, w = _bwd_inputs(c, groups, seed=c + 7 * groups)

    def loss(x_, s_, b_):
        y = jgn._xla_group_norm(x_, s_, b_, groups, 1e-5, act == "silu")
        return jnp.sum(y * jnp.asarray(w))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    leaves = [t.requires_grad_() for t in _t(x, scale, bias)]
    (tgn.group_norm(*leaves, groups, 1e-5, act) * torch.from_numpy(w)
     ).sum().backward()
    # fp32; the statistics and the VJP sum in another order
    for got, ref in zip(leaves, want):
        assert got.grad.shape == ref.shape
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("act", [None, "silu"])
def test_autograd_function_matches_autograd_of_reference(act):
    x, scale, bias, w = _bwd_inputs(96, 8, seed=11)
    grads = []
    for fn in (tgn.group_norm, tgn.group_norm_reference):
        leaves = [t.requires_grad_() for t in _t(x, scale, bias)]
        # a non-contiguous cotangent, as the NCHW side can hand it back
        (fn(*leaves, 8, 1e-5, act).transpose(1, 2)
         * torch.from_numpy(w).transpose(1, 2)).sum().backward()
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        assert got.shape == want.shape
        # fp32: the analytic VJP against autograd's chain of the two-pass
        # statistics, ~1e-6 apart
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_bwd_wrapper_refuses_cpu_tensors():
    x, scale, bias, g = _t(*_bwd_inputs(64, 8, seed=2))
    mean, rstd = tgn.group_norm_stats_reference(x, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tgn.group_norm_bwd_cuda(x, scale, bias, mean, rstd, g, 8)
    with pytest.raises(ValueError, match="groups"):
        tgn.group_norm_bwd_reference(x, scale, bias, mean, rstd, g, 7)
