"""The port's flash attention, forward and backward (plain versions, what
the CPU runs), and its dispatch rule against the JAX package:
`flash_attention_with_lse` and `flash_attention_bwd_with_lse` with the
Pallas kernels in interpret mode, `jax.vjp` of `_xla_attention`, and
`_flash_eligible` (with the kernels' dtype and head dim,
`tests/test_torch_attention_dispatch.py`)."""

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
    for device_type in ("meta", "cpu"):
        assert not tattn.flash_eligible(device_type, torch.bfloat16, q_shape,
                                        k_shape, False)


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


# ---------------------------------------------------------------- backward


@pytest.mark.parametrize("s,block_kv", [(128, None), (256, "128")])
def test_bwd_matches_pallas_kernels(monkeypatch, s, block_kv):
    """The plain backward against `flash_attention_bwd_with_lse` with the
    Pallas dQ and dK/dV kernels in interpret mode, both given the Pallas
    forward's out and lse; with a 128-key block the TPU kernels stream two
    KV blocks (dQ) and two Q blocks (dK/dV)."""
    monkeypatch.setenv(_INTERPRET, "1")
    monkeypatch.delenv("DIFFUSION_TPU_FLASH_BQ", raising=False)
    if block_kv:
        monkeypatch.setenv("DIFFUSION_TPU_FLASH_BK", block_kv)
        monkeypatch.setenv("DIFFUSION_TPU_FLASH_BQ", block_kv)
    else:
        monkeypatch.delenv("DIFFUSION_TPU_FLASH_BK", raising=False)
    q, k, v = _qkv(2, s, s, 2, 64, seed=s + 1)
    do = np.random.default_rng(s).standard_normal(q.shape).astype(np.float32)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    assert jfa._kernel_usable(jq, jk)
    out, lse = jfa.flash_attention_with_lse(jq, jk, jv)
    want = jfa.flash_attention_bwd_with_lse(jq, jk, jv, out, lse,
                                            jnp.asarray(do))
    got = tfa.flash_attention_bwd_reference(
        *(torch.from_numpy(np.array(a)) for a in (q, k, v, out, lse, do)))
    # fp32 throughout; blockwise sums against one einsum per product
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("s", [64, 128])
def test_grad_matches_xla_vjp(s):
    """`flash_attention` (the autograd function, plain versions on the CPU)
    backpropagates what `jax.vjp` of JAX's `_xla_attention` gives."""
    q, k, v = _qkv(2, s, s, 2, 64, seed=7 * s)
    do = np.random.default_rng(s + 3).standard_normal(q.shape).astype(
        np.float32)
    out, vjp = jax.vjp(lambda a, b, c: jattn._xla_attention(a, b, c, None),
                       *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got_out, _ = tfa.flash_attention(*leaves)
    got_out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out),
                               atol=2e-5, rtol=1e-5)
    # fp32: the lse-based VJP against XLA's softmax VJP
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   atol=2e-5, rtol=1e-4)


def _tiled_dq(q, k, v, out, lse, do, keys, mask=True, rows=128):
    """The dQ kernel's tiling in torch: 128-row q blocks and `keys`-key K/V
    tiles (64 in the kernel; 128 shows what a ragged key tile needs), with
    the zero rows past Sq and Skv that its tensor maps read; `mask` forces
    p to 0 on padded keys. Rows past Sq take lse 0 and are not returned.
    Returns (dq, delta)."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    pad_q, pad_k = -sq % rows, -skv % keys

    def pad(t, n):                      # zero rows after dim 1
        return torch.cat([t, t.new_zeros((b, n) + t.shape[2:])], dim=1)
    qp, op, dop = (pad(t, pad_q) for t in (q, out, do))
    kp, vp = pad(k, pad_k), pad(v, pad_k)
    lsep = torch.cat([lse, lse.new_zeros((b, h, pad_q))], dim=-1)
    delta = (dop.float() * op.float()).sum(-1).transpose(1, 2)  # (B, H, Sq)
    dq = torch.empty(qp.shape, dtype=torch.float32)
    for r0 in range(0, sq + pad_q, rows):
        rs = slice(r0, r0 + rows)
        acc = torch.zeros((b, rows, h, d))
        for k0 in range(0, skv + pad_k, keys):
            kt, vt = kp[:, k0:k0 + keys], vp[:, k0:k0 + keys]
            s = torch.einsum("bqhd,bkhd->bhqk", qp[:, rs].float(), kt.float())
            if mask:
                s[..., torch.arange(k0, k0 + keys) >= skv] = -torch.inf
            p = torch.exp(s * d ** -0.5 - lsep[..., rs, None])
            dp = torch.einsum("bqhd,bkhd->bhqk", dop[:, rs].float(), vt.float())
            ds = p * (dp - delta[..., rs, None])
            acc += torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype), kt).float()
        dq[:, rs] = acc * d ** -0.5
    return dq[:, :sq].to(q.dtype), delta[..., :sq]


def _bwd_inputs(b, sq, skv, h, seed, negative):
    """q, k, v, out, lse, do (fp32); `negative`: q near -5 and k near +5,
    so every score is near -200 and every row's lse below -100."""
    rng = np.random.default_rng(seed)
    shift = 5.0 if negative else 0.0
    q = torch.from_numpy(rng.standard_normal((b, sq, h, 64)) - shift).float()
    k = torch.from_numpy(rng.standard_normal((b, skv, h, 64)) + shift).float()
    v, do = (torch.from_numpy(rng.standard_normal(shape)).float()
             for shape in ((b, skv, h, 64), (b, sq, h, 64)))
    out, lse = tfa.flash_attention_reference(q, k, v)
    assert not negative or lse.max().item() < -100
    return q, k, v, out, lse, do


@pytest.mark.parametrize("keys", [64, 128])
@pytest.mark.parametrize("negative", [False, True])
@pytest.mark.parametrize("b,sq,skv,h", [
    (1, 192, 320, 3),                 # a ragged q block and key tile
    (2, 128, 192, 4),                 # a ragged last key tile
    (1, 256, 256, 2),                 # whole tiles
    (2, 64, 128, 1),                  # half a q block, one key tile
])
def test_dq_kernel_tiling_matches_plain(b, sq, skv, h, negative, keys):
    """The dQ kernel's tiling (emulated in fp32) gives what the plain
    backward gives, at ragged shapes and where every lse is below -100."""
    q, k, v, out, lse, do = _bwd_inputs(b, sq, skv, h, sq + skv, negative)
    dq, delta = _tiled_dq(q, k, v, out, lse, do, keys)
    want = tfa.flash_attention_bwd_reference(q, k, v, out, lse, do)[0]
    # fp32 throughout; blockwise sums against one einsum per product
    assert torch.isfinite(dq).all()
    np.testing.assert_allclose(dq.numpy(), want.numpy(), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(
        delta.numpy(), (do * out).sum(-1).transpose(1, 2).numpy(),
        atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("b,sq,skv,h", [(1, 192, 320, 3), (2, 128, 192, 4)])
def test_dq_tiling_needs_the_padded_key_mask(b, sq, skv, h):
    """With 128-key tiles and without the mask, a padded key's
    p = exp(0 - lse) overflows to inf where lse < -100 and meets its zero K
    row: inf * 0 = NaN in dQ. 64-key tiles have no padded keys."""
    q, k, v, out, lse, do = _bwd_inputs(b, sq, skv, h, sq + skv, True)
    dq, _ = _tiled_dq(q, k, v, out, lse, do, 128, mask=False)
    assert not torch.isfinite(dq).all()
    dq, _ = _tiled_dq(q, k, v, out, lse, do, 64, mask=False)
    assert torch.isfinite(dq).all()


def test_bwd_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 64, 64, 2, 64, seed=2))
    out, lse = tfa.flash_attention_reference(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd_cuda(q, k, v, out, lse, out)


def test_multi_head_attention_is_differentiable():
    """The plain branch (a matmul, a softmax and a matmul) carries
    gradients; on the CPU no shape takes the kernel."""
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(1, 32, 16, 2, 8, seed=4))
    tattn.multi_head_attention(q, k, v).square().sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (q, k, v))
