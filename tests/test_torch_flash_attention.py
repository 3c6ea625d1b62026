"""The port's flash attention (plain version, what the CPU runs) and its
dispatch rule against the JAX package: `flash_attention_with_lse` with the
Pallas `_fwd_kernel` in interpret mode, and `_flash_eligible`."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_tpu.ops import attention as jattn
from diffusion_tpu.ops import flash_attention as jfa
from diffusion_torch.ops import attention as tattn
from diffusion_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

_INTERPRET = "DIFFUSION_TPU_PALLAS_INTERPRET"


def _qkv(b, sq, skv, h, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, sq, h, d), (b, skv, h, d), (b, skv, h, d)))


@pytest.mark.parametrize("s,block_kv", [(128, None), (256, None), (256, "128")])
def test_matches_pallas_kernel(monkeypatch, s, block_kv):
    monkeypatch.setenv(_INTERPRET, "1")
    monkeypatch.delenv("DIFFUSION_TPU_FLASH_BQ", raising=False)
    if block_kv:       # read per call: the TPU kernel streams 2 KV blocks
        monkeypatch.setenv("DIFFUSION_TPU_FLASH_BK", block_kv)
    else:
        monkeypatch.delenv("DIFFUSION_TPU_FLASH_BK", raising=False)
    q, k, v = _qkv(1, s, s, 2, 64, seed=s)
    assert jfa._kernel_usable(jnp.asarray(q), jnp.asarray(k))
    want_out, want_lse = jfa.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got_out, got_lse = tfa.flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)))
    # fp32 throughout; the online softmax and the plain softmax differ only
    # in summation order
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=2e-5, rtol=1e-6)


@pytest.mark.parametrize("mask", [False, True])
def test_plain_attention_matches_xla(mask):
    """`multi_head_attention` on CPU (plain math) against JAX's XLA path,
    unmasked (cross-attention shape) and causal (CLIP)."""
    q, k, v = _qkv(2, 16, 16 if mask else 7, 2, 8, seed=3)
    m = np.tril(np.ones((16, 16), bool))[None, None] if mask else None
    want = jattn._xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                None if m is None else jnp.asarray(m))
    got = tattn.multi_head_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        mask=None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


_SHAPES = [
    ((2, 4096, 5, 64), (2, 4096, 5, 64)),     # 512px, first stage: kernel
    ((2, 1024, 10, 64), (2, 1024, 10, 64)),   # 512px, second stage: kernel
    ((2, 4096, 5, 64), (2, 77, 5, 64)),       # cross-attention
    ((2, 256, 20, 64), (2, 256, 20, 64)),
    ((2, 64, 20, 64), (2, 64, 20, 64)),
    ((1, 1000, 2, 64), (1, 1000, 2, 64)),     # ragged length
    ((1, 1024, 2, 40), (1, 1024, 2, 40)),     # head dim not a 64 multiple
    ((1, 1024, 2, 64), (1, 128, 2, 64)),      # too few keys
]


@pytest.mark.parametrize("q_shape,k_shape", _SHAPES)
def test_dispatch_rule_matches_jax(monkeypatch, q_shape, k_shape):
    """The port's rule is JAX's `_flash_eligible` with "the backend is a
    TPU" read as "the tensor is on CUDA"."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    q = types.SimpleNamespace(shape=q_shape)
    k = types.SimpleNamespace(shape=k_shape)
    want = jattn._flash_eligible(q, k, None)
    assert tattn._shape_eligible(q_shape, k_shape) == want
    assert not jattn._flash_eligible(q, k, object())
    # a tensor that is not on CUDA never takes the kernel, masked or not
    tq = torch.empty(q_shape, device="meta")
    tk = torch.empty(k_shape, device="meta")
    assert not tattn._flash_eligible(tq, tk, None)


def test_dispatch_by_device():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 64, 64, 2, 64, seed=1))
    out, lse = tfa.flash_attention(q, k, v)
    want_out, want_lse = tfa.flash_attention_reference(q, k, v)
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tfa.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
