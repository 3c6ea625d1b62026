"""Sequence parallelism's ops in the port against JAX and against the
unsharded ops, on gloo ranks on the CPU (fp32, inputs from numpy seeds).

One spawn of 4 ranks (`test_torch_ranks.ops_case`) runs every case on the group
of 4, on groups of 2 and on one-rank groups: ring attention (forward and dq/dk/dv), the 3x3
convolution with its row halo (stride 1 and 2) and the sp GroupNorm(+SiLU)
forward and backward. The JAX side runs `ring_attention` under `shard_map`
on 4 of the 8 virtual CPU devices in this process; the ranks import no
JAX. The ring over n local shards on one rank (the body the card runs in
`chip_smoke.py` phase 16) is held against the ranks' results."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import test_torch_ranks as torch_ranks
from diffusion_tpu.ops import groupnorm as jgn
from diffusion_tpu.ops.attention import _xla_attention
from diffusion_tpu.ops.ring_attention import ring_attention as jax_ring
from diffusion_torch.models.layers import Conv2d
from diffusion_torch.ops.flash_attention import flash_attention_reference
from diffusion_torch.ops.groupnorm import group_norm
from diffusion_torch.ops.ring_attention import (ring_attention_shards,
                                                ring_attention_shards_bwd)

torch.set_num_threads(1)

B, S, H, D = 2, 256, 2, 64
GROUPS = 4


def _t(rng, *shape, scale=1.0, mean=0.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale + mean).astype(np.float32))


def _inputs():
    rng = np.random.default_rng(0)
    cl = torch.channels_last
    conv = Conv2d(8, 8, 3, padding=1)
    with torch.no_grad():
        conv.weight.copy_(_t(rng, 8, 8, 3, 3, scale=0.2))
        conv.bias.copy_(_t(rng, 8, scale=0.2))
    return {**_tp_inputs(),
            "attn": [_t(rng, B, S, H, D) for _ in range(4)],
            "x": _t(rng, 2, 8, 16, 12).contiguous(memory_format=cl),
            "dy1": _t(rng, 2, 8, 16, 12).contiguous(memory_format=cl),
            "dy2": _t(rng, 2, 8, 8, 6).contiguous(memory_format=cl),
            "conv": conv.state_dict(),
            "gn": _t(rng, 2, 64, 16), "gn_mean": _t(rng, 2, 64, 16,
                                                    mean=1000.0),
            "gy": _t(rng, 2, 64, 16),
            "scale": _t(rng, 16, scale=0.5, mean=1.0),
            "bias": _t(rng, 16, scale=0.5)}


def _tp_inputs():
    """The tensor-parallel cases' weights (every one drawn, LoRA B too)
    and activations; `tp_g` holds 4 ranks' own tensors."""
    rng = np.random.default_rng(1)
    out = {"tp_" + name: {k: _t(rng, *v.shape, scale=0.3)
                          for k, v in layer.state_dict().items()}
           for name, layer in torch_ranks.tp_layers().items()}
    return dict(out, tp_x=_t(rng, 2, 6, 32), tp_g=_t(rng, 4, 2, 6, 32),
                tp_h=_t(rng, 2, 6, 32), tp_ctx=_t(rng, 2, 5, 16),
                tp_dy=_t(rng, 2, 6, 32))


@pytest.fixture(scope="module")
def ops_ranks(tmp_path_factory):
    inputs = _inputs()
    results = torch_ranks.spawn(torch_ranks.ops_case, 4,
                                tmp_path_factory.mktemp("ops_ranks"), inputs,
                                timeout=240)
    return inputs, results


def _joined(results, key, n, i, dim):
    """Shard `i` of the outputs under `key`, joined over the n ranks of the
    first group of n."""
    return torch.cat([results[r][key][i] for r in range(n)], dim)


def _summed(results, key, n, i):
    return sum(results[r][key][i] for r in range(n))


def _close(got, want, tol=1e-5):
    """Within tol of the reference's largest magnitude (fp32 sums in
    another order)."""
    scale = max(float(want.abs().max()), 1.0)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=tol * scale, rtol=tol)


def _jax_ring(q, k, v, do):
    mesh = Mesh(np.array(jax.devices()[:4]), ("sp",))
    fn = shard_map(functools.partial(jax_ring, axis_name="sp"), mesh=mesh,
                   in_specs=(P(None, "sp"),) * 3, out_specs=P(None, "sp"))
    with mesh:
        out, vjp = jax.vjp(fn, q, k, v)
        grads = vjp(do)
    return [np.array(a) for a in (out, *grads)]


@pytest.mark.parametrize("n", [1, 2, 4])
def test_ring_attention_matches_jax(ops_ranks, monkeypatch, n):
    """The port's ring over n gloo ranks against JAX's ring over 4 virtual
    devices, outputs and dq/dk/dv within 1e-5; both within 1e-5 of
    unsharded attention."""
    monkeypatch.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "0")
    inputs, results = ops_ranks
    q, k, v, do = inputs["attn"]
    want = _jax_ring(*(jnp.asarray(t.numpy()) for t in (q, k, v, do)))
    got = [_joined(results, ("ring", n), n, i, 1) for i in range(4)]
    qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
    full, _ = flash_attention_reference(qq, kk, vv)
    full.backward(do)
    plain = [full.detach(), qq.grad, kk.grad, vv.grad]
    for g, w, p in zip(got, want, plain):
        _close(g, torch.from_numpy(w))
        _close(g, p)
        _close(torch.from_numpy(w), p)
    # JAX's own full attention agrees with the port's plain one
    _close(torch.from_numpy(np.array(_xla_attention(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)), None))), plain[0])


@pytest.mark.parametrize("n", [1, 2, 4])
def test_local_shard_ring_equals_the_ranks(ops_ranks, n):
    """The ring's body over n local shards on one process gives what n
    ranks give, bit for bit: the same steps in the same order."""
    inputs, results = ops_ranks
    q, k, v, do = (torch.chunk(t, n, dim=1) for t in inputs["attn"])
    outs, lses = ring_attention_shards(list(q), list(k), list(v))
    dqs, dks, dvs = ring_attention_shards_bwd(q, k, v, outs, lses, do)
    for r in range(n):
        want = results[r][("ring", n)]
        for got, w in zip((outs[r], dqs[r], dks[r], dvs[r]), want):
            assert torch.equal(got, w), r


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("stride", [1, 2])
def test_halo_conv_matches_unsharded(ops_ranks, n, stride):
    """The 3x3 convolution over row shards (a row from each neighbour,
    zeros at the image's edges; its backward returns the halo's gradient)
    against the whole image's, forward and backward."""
    inputs, results = ops_ranks
    conv = Conv2d(8, 8, 3, stride=stride, padding=1)
    conv.load_state_dict(inputs["conv"])
    x = inputs["x"].clone().requires_grad_(True)
    y = conv(x)
    y.backward(inputs[f"dy{stride}"])
    key = ("conv", n, stride)
    _close(_joined(results, key, n, 0, 2), y.detach())
    _close(_joined(results, key, n, 1, 2), x.grad)
    _close(_summed(results, key, n, 2), conv.weight.grad)
    _close(_summed(results, key, n, 3), conv.bias.grad)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("act", [None, "silu"])
def test_sp_group_norm_matches_unsharded(ops_ranks, n, act):
    """GroupNorm over row shards, statistics merged over the group (Chan)
    and the backward's per-group sums likewise, against the one-call op;
    dscale/dbias are each rank's rows' part and sum to the whole's."""
    inputs, results = ops_ranks
    x = inputs["gn"].clone().requires_grad_(True)
    scale = inputs["scale"].clone().requires_grad_(True)
    bias = inputs["bias"].clone().requires_grad_(True)
    y = group_norm(x, scale, bias, GROUPS, 1e-5, act)
    y.backward(inputs["gy"])
    key = ("gn", n, act)
    _close(_joined(results, key, n, 0, 1), y.detach())
    _close(_joined(results, key, n, 1, 1), x.grad)
    _close(_summed(results, key, n, 2), scale.grad)
    _close(_summed(results, key, n, 3), bias.grad)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_sp_group_norm_large_mean_two_pass(ops_ranks, monkeypatch, n):
    """Mean 1000, unit variance: the merged partials keep the two-pass
    accuracy, within the port's bound against JAX's two-pass
    `_xla_group_norm` (test_torch_groupnorm.py's
    `test_large_mean_matches_two_pass_xla`: 3e-3)."""
    monkeypatch.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "0")
    inputs, results = ops_ranks
    x, scale, bias = (inputs[k].numpy() for k in ("gn_mean", "scale", "bias"))
    want = np.asarray(jgn._xla_group_norm(jnp.asarray(x), jnp.asarray(scale),
                                          jnp.asarray(bias), GROUPS, 1e-5,
                                          True))
    got = _joined(results, ("gn_mean", n, "silu"), n, 0, 1).numpy()
    np.testing.assert_allclose(got, want, atol=3e-3, rtol=0)


@pytest.mark.parametrize("n", [2, 4])
def test_tp_copy_and_reduce(ops_ranks, n):
    """Megatron's f and g over tp groups of n gloo ranks: tp_copy is the
    identity whose backward sums the group's cotangents; tp_reduce sums
    the group's partials and hands the cotangent back as it is."""
    inputs, results = ops_ranks
    for first in range(0, 4, n):
        group = range(first, first + n)
        g_sum = sum(inputs["tp_g"][r] for r in group)
        for r in group:
            y, dx = results[r][("tp_copy", n)]
            assert torch.equal(y, inputs["tp_x"])
            _close(dx, g_sum)
            y, dx = results[r][("tp_reduce", n)]
            _close(y, g_sum)
            assert torch.equal(dx, inputs["tp_x"])


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["attn", "xattn", "ff"])
def test_tp_layers_match_the_whole_layer(ops_ranks, name, n):
    """An Attention (self and cross, LoRA on: q/k/v's B and to_out's A
    sliced, the other factors whole) and a GEGLU sliced over n tp ranks
    against the whole layer: every rank's output and input gradient, its
    slices' gradients against the whole gradient's slices, and its whole
    parameters' gradients against the whole's, within 1e-5."""
    from diffusion_torch.parallel.sharding import tp_placement, tp_slice
    inputs, results = ops_ranks
    layer = torch_ranks.tp_layers(inputs)[name]
    placed = tp_placement(layer, n, 8)
    assert len(placed) == {"attn": 8, "xattn": 8, "ff": 3}[name]
    h = inputs["tp_h"].clone().requires_grad_(True)
    y = layer(h, inputs["tp_ctx"]) if name == "xattn" else layer(h)
    y.backward(inputs["tp_dy"])
    for r in range(4):
        got_y, got_dh, grads = results[r][(name, n)]
        _close(got_y, y.detach())
        _close(got_dh, h.grad)
        for k, p in layer.named_parameters():
            want = p.grad if k not in placed else tp_slice(
                k, p.grad, placed[k], r % n, n)
            _close(grads[k], want)
