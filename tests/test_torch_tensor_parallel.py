"""Megatron tensor parallelism in the port against the JAX package, in one
process (no ranks; the gloo ranks' cases are in test_torch_ring_attention.py
and test_torch_mesh_trainer.py):

- the table: every UNet parameter's tp dim (or none) under
  `parallel/sharding.py::tp_placement` equals the tp entry of JAX's
  `param_spec` for its counterpart (names through `port_jax`), on JAX
  meshes of the virtual devices, for the tiny geometry, with LoRA, for
  JAX's odd-head config (a 5-head stage, gated at tp = 2) and for SD2's
  geometry (shapes only); `model_tp_head_dim` agrees with JAX's;
- the GEGLU interleave: rank r's slice of the fused `ff.net.0.proj`
  chunks into JAX's `proj_in`/`proj_gate` columns of rank r, and the
  slices join back into the whole;
- the layer math: a block or Transformer2D split into tp shards in one
  process (`chip_smoke.py::tp_local_twin`, the partials summed where
  `tp_reduce` would) against the whole module, output and every gradient
  within 1e-5 (fp32);
- `chip_smoke.py::bit_checksums`, with which the gloo ranks' tests and the
  card's check hold a tp group's whole tensors bit-equal, sees a one-bit
  change and two swapped elements.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from diffusion_tpu.models.unet import UNet2DCondition as JaxUNet
from diffusion_tpu.models.unet import UNetConfig as JaxUNetConfig
from diffusion_tpu.parallel.mesh import create_mesh as jax_create_mesh
from diffusion_tpu.parallel.sharding import \
    model_tp_head_dim as jax_model_tp_head_dim
from diffusion_tpu.parallel.sharding import param_spec
from diffusion_torch.models.layers import (Attention, BasicTransformerBlock,
                                           Transformer2D)
from diffusion_torch.models.port_jax import _LEAF, _block_name, unet_from_jax
from diffusion_torch.models.unet import UNet2DCondition, UNetConfig
from diffusion_torch.parallel.sharding import (model_tp_head_dim,
                                               tp_join, tp_placement,
                                               tp_slice)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import (bit_checksums, tp_local_twin,  # noqa: E402
                        tp_twin_grads)

torch.set_num_threads(1)

TINY = dict(in_channels=4, out_channels=4, block_out_channels=(32, 64),
            layers_per_block=1, block_has_attention=(True, False),
            attention_head_dim=(2, 4), cross_attention_dim=32,
            norm_num_groups=8)
# tests/test_tensor_parallel.py::test_odd_head_count_gates_attention_tp
ODD = dict(in_channels=4, out_channels=4, block_out_channels=(40, 64),
           layers_per_block=1, block_has_attention=(True, True),
           attention_head_dim=(5, 8), cross_attention_dim=16,
           norm_num_groups=8)
CONFIGS = {"tiny": TINY, "tiny_lora": dict(TINY, lora_rank=2),
           "odd_lora": dict(ODD, lora_rank=2), "sd2": {}}


class _Model:
    def __init__(self, unet):
        self.unet = unet


def _jax_shapes(fields):
    cfg = JaxUNetConfig(**fields)
    unet = JaxUNet(cfg)
    x = np.zeros((1, 8, 8, cfg.in_channels), np.float32)
    ctx = np.zeros((1, 5, cfg.cross_attention_dim), np.float32)
    shapes = jax.eval_shape(unet.init, jax.random.key(0), x,
                            np.zeros((1,), np.int32), ctx)
    return unet, shapes


def _port_name(parts):
    """A JAX UNet param path -> the port's parameter name."""
    leaf = parts[-1]
    if len(parts) >= 3 and parts[-3] == "ff":
        mod = {"proj_in": "net.0.proj", "proj_gate": "net.0.proj",
               "proj_out": "net.2"}[parts[-2]]
        prefix = ".".join(_block_name(p) for p in parts[:-3])
        return f"{prefix}.ff.{mod}.{_LEAF[leaf]}"
    return ".".join(_block_name(p) for p in parts[:-1]) + "." + _LEAF[leaf]


def _jax_placement(shapes, mesh, head_dim):
    """{port name: port dim} of every leaf JAX's param_spec puts on tp."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(shapes["params"]):
        parts = tuple(str(k.key) for k in path)
        spec = tuple(param_spec(leaf, mesh, min_size=0, path=parts,
                                tp_head_dim=head_dim))
        if "tp" not in spec:
            continue
        d = spec.index("tp")
        if parts[-1] == "kernel" and len(leaf.shape) == 2:
            d = 1 - d                    # (in, out) -> the port's (out, in)
        name = _port_name(parts)
        assert out.setdefault(name, d) == d, name   # proj_in == proj_gate
    return out


@pytest.mark.parametrize("tp,data", [(2, 4), (4, 2)])
@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_tp_table_matches_jax_param_spec(case, tp, data):
    fields = CONFIGS[case]
    junet, shapes = _jax_shapes(fields)
    with torch.device("meta"):        # shapes only: SD2 at full width
        unet = UNet2DCondition(UNetConfig(**fields))
    head_dim = model_tp_head_dim(_Model(unet))
    assert head_dim == jax_model_tp_head_dim(_Model(junet))
    mesh = jax_create_mesh(dcn=1, fsdp=1, data=data, tp=tp)
    want = _jax_placement(shapes, mesh, head_dim)
    got = tp_placement(unet, tp, head_dim)
    assert got == want
    names = dict(unet.named_parameters())
    assert set(got) <= set(names)
    # what the table holds: q/k/v (+ LoRA B), to_out (+ LoRA A), the GEGLU
    # pair; never a bias of to_out, LoRA A of q/k/v, or the spatial
    # proj_in/proj_out
    for name in got:
        assert name.endswith(("to_q.weight", "to_k.weight", "to_v.weight",
                              "_lora_b.weight", "to_out.0.weight",
                              "to_out_lora_a.weight", "ff.net.0.proj.weight",
                              "ff.net.0.proj.bias", "ff.net.2.weight")), name
        assert not name.endswith("to_out_lora_b.weight"), name
    if case == "odd_lora" and tp == 2:
        # the 5-head stage's attention stays whole, its GEGLU shards
        stage0 = "down_blocks.0.attentions.0.transformer_blocks.0."
        assert stage0 + "ff.net.0.proj.weight" in got
        assert not any(n.startswith(stage0 + "attn") for n in got)
    if case == "sd2" and tp == 2:
        # SD2's Megatron pairs less the 5-head stage's attention: 242.3M
        # values split, so each of 2 tp ranks keeps 744.7M of 865.9M
        sliced = sum(names[n].numel() for n in got)
        total = sum(p.numel() for p in unet.parameters())
        assert (sliced, total) == (242337280, 865910724)
        assert total - sliced // 2 == 744742084


def test_geglu_slices_pair_value_and_gate():
    """Rank r's slice of the fused projection is JAX's proj_in columns of
    rank r, then its proj_gate columns: the local chunk(2) pairs them."""
    cfg = JaxUNetConfig(**TINY)
    junet = JaxUNet(cfg)
    params = junet.init(jax.random.key(1), np.zeros((1, 8, 8, 4), np.float32),
                        np.zeros((1,), np.int32),
                        np.zeros((1, 5, 32), np.float32))
    port = unet_from_jax(params)
    ff = params["params"]["down_0_attn_0"]["blocks_0"]["ff"]
    name = "down_blocks.0.attentions.0.transformer_blocks.0.ff.net.0.proj"
    inner = np.asarray(ff["proj_in"]["kernel"]).shape[1]
    for tp in (2, 4):
        n = inner // tp
        for leaf, jleaf in (("weight", "kernel"), ("bias", "bias")):
            whole = port[f"{name}.{leaf}"]
            parts = []
            for r in range(tp):
                part = tp_slice(f"{name}.{leaf}", whole, 0, r, tp)
                value, gate = part.chunk(2, 0)
                for got, key in ((value, "proj_in"), (gate, "proj_gate")):
                    want = np.asarray(ff[key][jleaf])[..., r * n:(r + 1) * n]
                    np.testing.assert_array_equal(
                        got.numpy(), want.T if leaf == "weight" else want)
                parts.append(part)
            assert torch.equal(tp_join(f"{name}.{leaf}", parts, 0), whole)


def _twin_case(kind, tp):
    gen = torch.Generator().manual_seed(7)
    if kind == "block":
        module, head_dim = BasicTransformerBlock(32, 4, 8, 16), 8
        x = torch.randn((2, 12, 32), generator=gen)
    elif kind == "attention":          # the layer alone, cross-attention
        module, head_dim = Attention(32, 4, 8, cross_dim=16), 8
        x = torch.randn((2, 12, 32), generator=gen)
    else:          # the odd config's 5-head stage: attention gated whole
        module, head_dim = Transformer2D(40, 5, 16, groups=8), 8
        x = torch.randn((2, 40, 4, 4), generator=gen).contiguous(
            memory_format=torch.channels_last)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    ctx = torch.randn((2, 5, 16), generator=gen)
    return module, head_dim, x, ctx, torch.randn(x.shape, generator=gen)


@pytest.mark.parametrize("kind,tp", [("block", 2), ("block", 4),
                                     ("transformer", 2), ("attention", 2)])
def test_local_twin_matches_the_whole_module(kind, tp):
    module, head_dim, x, ctx, dy = _twin_case(kind, tp)
    twin = tp_local_twin(module, tp, head_dim)
    outs = []
    for m in (module, twin):
        xi = x.clone().requires_grad_(True)
        y = m(xi, ctx)
        y.backward(dy)
        outs.append((y.detach(), xi.grad))
    for got, want in zip(outs[1], outs[0]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                                   rtol=1e-5)
    got = tp_twin_grads(twin)
    assert sorted(got) == sorted(n for n, _ in module.named_parameters())
    for name, p in module.named_parameters():
        scale = max(float(p.grad.abs().max()), 1.0)
        np.testing.assert_allclose(got[name].numpy(), p.grad.numpy(),
                                   atol=1e-5 * scale, rtol=1e-5,
                                   err_msg=name)
    sums = [n for n, m in twin.named_modules()
            if type(m).__name__ == "TpSum"]
    if kind == "transformer":     # 5 heads over 2 ranks: only the GEGLU
        assert sums == ["transformer_blocks.0.ff"]
    elif kind == "attention":
        assert sums == [""]
    else:
        assert sums == ["attn1", "attn2", "ff"]


def test_twin_refuses_lora():
    with pytest.raises(ValueError, match="LoRA"):
        tp_local_twin(BasicTransformerBlock(32, 4, 8, 16, lora_rank=2), 2, 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bit_checksums_see_a_bit_and_a_swap(dtype):
    gen = torch.Generator().manual_seed(3)
    t = torch.randn((64, 33), generator=gen).to(dtype)
    flipped = t.clone()
    flipped.view(-1)[100:101].view(torch.int16 if t.element_size() == 2
                                   else torch.int32).bitwise_xor_(1)
    swapped = t.clone().view(-1)
    swapped[[5, 6]] = swapped[[6, 5]]
    sums = bit_checksums([t, t.clone(), flipped, swapped.view(t.shape),
                          t.t()])
    assert sums.shape == (5, 2) and sums.dtype == torch.int64
    assert torch.equal(sums[0], sums[1])
    assert not torch.equal(sums[0, :1], sums[2, :1])
    assert torch.equal(sums[0, :1], sums[3, :1])
    assert not torch.equal(sums[0], sums[3])
    assert not torch.equal(sums[0], sums[4])     # the same bits transposed
