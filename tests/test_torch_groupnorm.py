"""The port's GroupNorm (plain PyTorch version, what the CPU runs) against
the JAX package: its Pallas `_fwd_kernel` in interpret mode and its
two-pass XLA path. The kernel on the card is held to this same plain
version by tests/test_torch_kernels_gpu.py."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

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
