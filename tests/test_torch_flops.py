"""The port's FLOP count (`diffusion_torch/utils/flops.py`) against the JAX
package's (`diffusion_tpu/utils/flops.py`), on the same numpy-seeded inputs
and, for the UNet, the same weights (through `port_jax`):

- a matmul, a dense layer's forward + backward and a stride-1 conv's count
  the same on both sides; a stride-2 conv's forward + backward reads 3x
  its forward in the port and 6x in JAX (reference fault 14: JAX prices
  the input gradient's lhs dilation zeros);
- the flash op at (1, 128, 2, 64): 2 units forward and 9 with the
  backward in the port (the dQ kernel's 3 and dK/dV's 4), 2 and 8 in
  JAX's Pallas path (reference fault 15: it prices dK/dV at 3);
- the tiny UNet's loss-and-grad microbatch, remat off and on: dot equal,
  conv equal less fault 14's term of its Downsample convs; a 3-step DDIM
  CFG `generate` equal;
- SD2 at full width on the meta device: the 256px microbatch of 16 against
  JAX's count of the same step, and the card's route beside it;
- the remat policy keeps the flash op's outputs (no forward recomputed),
  and `measure_flops` runs on the CPU.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diffusion_tpu.models.models import stable_diffusion_tiny as jax_tiny
from diffusion_tpu.models.unet import UNet2DCondition as JaxUNet
from diffusion_tpu.ops import flash_attention as jfa
from diffusion_tpu.utils import flops as jflops
from diffusion_torch.inference.inference_model import StableDiffusionInference
from diffusion_torch.models.layers import Downsample
from diffusion_torch.models.models import (stable_diffusion_2,
                                           stable_diffusion_tiny)
from diffusion_torch.models.port_jax import unet_from_jax
from diffusion_torch.models.unet import UNet2DCondition, UNetConfig
from diffusion_torch.ops import flash_attention as tfa
from diffusion_torch.scripts import measure_flops
from diffusion_torch.utils import flops as tflops
from diffusion_torch.utils.device import route_meta_as

torch.set_num_threads(1)


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jax_by_class(fn, *args):
    return jflops.jaxpr_flops_by_class(jax.make_jaxpr(fn)(*args))


@pytest.fixture(scope="module")
def jax_weights():
    """JAX's tiny model with its towers and its weights (the UNet's are the
    latent model's too)."""
    jsd = jax_tiny()
    params, frozen = jsd.init_params(jax.random.key(0), image_size=64)
    return jsd, params, frozen


# ------------------------------------------------ tests/test_flops.py's three

def test_lowered_flops_matmul_exact():
    m, k, n = 64, 128, 32
    a, b = (torch.from_numpy(_np(s, *shape))
            for s, shape in ((0, (m, k)), (1, (k, n))))
    assert tflops.lowered_flops(torch.matmul, a, b) == 2 * m * k * n
    assert tflops.traced_flops(torch.matmul, a, b) == 2 * m * k * n
    assert jflops.traced_flops(jnp.matmul, jnp.asarray(a.numpy()),
                               jnp.asarray(b.numpy())) == 2 * m * k * n


def test_lowered_flops_counts_train_like_graph():
    """A dense layer's forward + backward (gradients of w and x) is 3x its
    forward, on both sides."""
    m, k, n = 32, 64, 16
    w_np, x_np = _np(2, k, n), _np(3, m, k)

    def jloss(w, x):
        return jnp.sum((x @ w) ** 2)

    jfwd = jflops.traced_flops(jloss, w_np, x_np)
    jboth = jflops.traced_flops(jax.grad(jloss, argnums=(0, 1)), w_np, x_np)
    w, x = (torch.from_numpy(a).requires_grad_() for a in (w_np, x_np))

    def loss():
        return ((x @ w) ** 2).sum()

    fwd = tflops.lowered_flops(loss)
    both = tflops.lowered_flops(lambda: loss().backward())
    assert fwd == jfwd == 2 * m * k * n
    assert both == jboth == 3 * fwd


def test_device_peak_flops_none_or_positive():
    peak = tflops.device_peak_flops()
    assert peak is None or peak > 0       # this CPU: None (never fabricated)
    assert tflops.device_peak_flops("cpu") is None


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA H100 PCIe", 756e12),
    ("NVIDIA A100-SXM4-80GB", None), ("NVIDIA H200", None)])
def test_device_peak_flops_by_name(monkeypatch, name, peak):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    assert tflops.device_peak_flops() == peak


# ------------------------------------------------------------ convolutions

def _conv_pair(stride):
    """(port fwd, port fwd+bwd, jax fwd, jax fwd+bwd) of a 3x3 conv, padding
    1, over (2, 16, 16, 8) -> 12 channels, gradients of input and kernel."""
    x_np, w_np = _np(4, 2, 16, 16, 8), _np(5, 3, 3, 8, 12)

    def jconv(x, w):
        return jnp.sum(jax.lax.conv_general_dilated(
            x, w, (stride, stride), ((1, 1), (1, 1)),
            dimension_numbers=("NHWC", "HWIO", "NHWC")) ** 2)

    jf = _jax_by_class(jconv, x_np, w_np)["conv"]
    jb = _jax_by_class(jax.grad(jconv, argnums=(0, 1)), x_np, w_np)["conv"]
    x = torch.from_numpy(x_np).permute(0, 3, 1, 2).requires_grad_()
    w = torch.from_numpy(w_np).permute(3, 2, 0, 1).requires_grad_()

    def conv():
        return (F.conv2d(x, w, stride=stride, padding=1) ** 2).sum()

    with torch.no_grad():
        np.testing.assert_allclose(conv().item(), float(jconv(x_np, w_np)),
                                   rtol=1e-5)
    tf = tflops.flops_by_class(conv)["conv"]
    tb = tflops.flops_by_class(lambda: conv().backward())["conv"]
    out = 16 // stride
    assert tf == jf == 2 * 2 * out * out * 12 * 8 * 9
    return tf, tb, jf, jb


def test_stride1_conv_counts_the_same():
    tf, tb, jf, jb = _conv_pair(1)
    assert tb == jb == 3 * tf


def test_stride2_conv_input_gradient_fault_14():
    """JAX prices the input gradient of a stride-2 conv (a conv over the
    cotangent dilated by 2) at 4x the forward: 6x in all, the port 3x."""
    tf, tb, jf, jb = _conv_pair(2)
    assert tb == 3 * tf
    assert jb == 6 * jf == tb + 3 * tf


# ------------------------------------------------------------ flash attention

def test_flash_op_units_fault_15(monkeypatch):
    """Port: forward 2 units, forward + backward 9 (the backward op's dQ 3
    and dK/dV 4), seen whatever the op runs inside. JAX's Pallas path
    (interpret mode, traced only): 2 and 8."""
    shape = (1, 128, 2, 64)
    q_np, k_np, v_np = (_np(10 + i, *shape) for i in range(3))
    unit = tflops.attention_unit(shape, shape)
    assert unit == 2 * 1 * 2 * 128 * 128 * 64
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (q_np, k_np,
                                                                v_np))
    fwd = tflops.flops_by_class(tfa.flash_attention, q, k, v)

    def both():
        out, _ = tfa.flash_attention(q, k, v)
        out.sum().backward()

    got = tflops.flops_by_class(both)
    assert fwd == {"dot": 0.0, "conv": 0.0, "flash": 2.0 * unit}
    assert got == {"dot": 0.0, "conv": 0.0, "flash": 9.0 * unit}

    monkeypatch.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("DIFFUSION_TPU_GN", "xla")

    def jloss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v))

    assert jfa._kernel_usable(jnp.asarray(q_np), jnp.asarray(k_np))
    assert _jax_by_class(jfa.flash_attention, q_np, k_np, v_np) == {
        "dot": 0.0, "conv": 0.0, "flash": 2.0 * unit}
    assert _jax_by_class(jax.grad(jloss, argnums=(0, 1, 2)), q_np, k_np,
                         v_np) == {"dot": 0.0, "conv": 0.0,
                                   "flash": 8.0 * unit}


# ------------------------------------------------------------ the tiny UNet

@contextlib.contextmanager
def _fault14_term(unet):
    """Yields a list that holds, once the block has run, 3x the forward
    FLOPs of the Downsample convs it called: what JAX's counter adds to
    their input gradients."""
    shapes, term = [], []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: shapes.append((inp[0].shape, out.shape)))
        for m in unet.modules() if isinstance(m, Downsample)]
    try:
        yield term
    finally:
        for h in hooks:
            h.remove()
    assert shapes
    term.append(sum(3 * 2 * float(np.prod(out)) * x[1] * 9
                    for x, out in shapes))


@pytest.mark.parametrize("remat", [False, True])
def test_unet_microbatch_matches_jax(monkeypatch, jax_weights, remat):
    """One loss-and-grad microbatch: the dots agree exactly (remat's
    recompute too: both policies keep the dots without batch dimensions
    and recompute the attention's batched products); the convs agree but
    for fault 14's term of the one Downsample conv."""
    monkeypatch.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "0")
    _, params, _ = jax_weights
    frozen = {}
    jsd = jax_tiny(precomputed_latents=True)
    jsd = dataclasses.replace(jsd, unet=JaxUNet(jsd.unet.config,
                                                dtype=jsd.unet.dtype,
                                                remat=remat))
    batch = {"image_latents": _np(20, 2, 8, 8, 4),
             "caption_latents": _np(21, 2, 8, 32)}
    want = _jax_by_class(jax.value_and_grad(jsd.loss_fn), params, frozen,
                         {k: jnp.asarray(v) for k, v in batch.items()},
                         jax.random.key(11))

    model = stable_diffusion_tiny(device="cpu", precomputed_latents=True)
    unet = UNet2DCondition(model.unet.config, remat=remat)
    unet.load_state_dict(unet_from_jax(params))
    model = dataclasses.replace(model, unet=unet)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with _fault14_term(unet) as term:
        got = tflops.flops_by_class(
            lambda: model.loss_fn(tbatch).backward())
    assert term == [3 * 2 * (2 * 4 * 4 * 32) * 32 * 9]
    assert got["dot"] == want["dot"] > 0
    assert got["conv"] == want["conv"] - term[0]
    assert got["flash"] == want["flash"] == 0.0


def test_generate_matches_jax(monkeypatch, jax_weights):
    """A 3-step DDIM CFG `generate` (CLIP, 3 x the UNet at batch 4, the VAE
    decode): the port's count equals JAX's, whose scan prices its body
    times its length."""
    monkeypatch.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "0")
    jsd, params, frozen = jax_weights
    port = StableDiffusionInference(builder=stable_diffusion_tiny,
                                    device="cpu", default_size=64,
                                    jax_params=(params, frozen))
    ids = np.asarray(jsd.tokenizer(["a red fox", "a lighthouse"])[
        "input_ids"])
    common = dict(height=64, width=64, guidance_scale=7.5,
                  num_inference_steps=3)
    want = _jax_by_class(lambda p, f, i: jsd.generate(p, f, i, seed=3,
                                                        **common),
                         params, frozen, jnp.asarray(ids))
    model = port._model_for(None)
    with torch.no_grad():
        got = tflops.flops_by_class(
            lambda: model.generate(torch.from_numpy(ids), **common))
    assert got == want and got["conv"] > 0


# ------------------------------------------------------------ the meta device

def test_sd2_microbatch_at_full_width():
    """SD2's 256px microbatch of 16 on the meta device (shapes only). On
    the CPU's route it is JAX's count of the same step (JAX's
    `jaxpr_flops_by_class` over `eval_shape`d parameters, XLA attention:
    dot 3.609e12, conv 5.088e12 to four figures) less fault 14's term of
    the three Downsample convs. On the card's route the five (16, 1024, 5,
    64) self-attention calls go to the flash op: 9 units each instead of
    the plain path's 6 products."""
    model = stable_diffusion_2(precomputed_latents=True, device="meta")
    batch = {"image_latents": torch.empty((16, 32, 32, 4), device="meta"),
             "caption_latents": torch.empty((16, 77, 1024), device="meta")}

    def step():
        model.loss_fn(batch).backward()

    with route_meta_as("cpu"), _fault14_term(model.unet) as term:
        cpu = tflops.flops_by_class(step)
    with route_meta_as("cuda"):
        card = tflops.flops_by_class(step)
    # 32 -> 16 at 320 channels, 16 -> 8 at 640, 8 -> 4 at 1280: equal work
    assert term == [3 * 3 * (2 * 16 * 256 * 320 * 320 * 9)]
    assert cpu["flash"] == 0.0
    assert cpu["dot"] == pytest.approx(3.609e12, abs=5e8)
    assert cpu["conv"] + term[0] == pytest.approx(5.088e12, abs=5e8)
    units = 5 * tflops.attention_unit((16, 1024, 5, 64), (16, 1024, 5, 64))
    assert card["conv"] == cpu["conv"]
    assert card["flash"] == 9 * units
    assert card["dot"] == cpu["dot"] - 6 * units


@pytest.mark.parametrize("remat", [False, True])
def test_remat_keeps_the_flash_outputs(remat):
    """A 64-wide, one-head first level at 32x32 latents (S = 1024, head dim
    64) in bf16 on the meta device, routed as the card: each self-attention
    call's forward op is counted once (the policy keeps its outputs) and its
    backward op once, remat or not."""
    cfg = UNetConfig(block_out_channels=(64, 128), layers_per_block=1,
                     block_has_attention=(True, False),
                     attention_head_dim=(1, 2), cross_attention_dim=32,
                     norm_num_groups=8)
    with torch.device("meta"):
        unet = UNet2DCondition(cfg, dtype=torch.bfloat16, remat=remat)
    sample = torch.empty((2, 4, 32, 32), device="meta").contiguous(
        memory_format=torch.channels_last)
    t = torch.zeros((2,), dtype=torch.int64, device="meta")
    ctx = torch.empty((2, 8, 32), device="meta")
    with route_meta_as("cuda"):
        got = tflops.flops_by_class(
            lambda: unet(sample, t, ctx).float().sum().backward())
    # the first level's transformers: one down, two up
    calls = 3
    unit = tflops.attention_unit((2, 1024, 1, 64), (2, 1024, 1, 64))
    assert got["flash"] == calls * 9 * unit


def test_meta_tensors_refused_outside_the_route():
    q = torch.empty((1, 1024, 1, 64), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tfa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="cuda or cpu"):
        with route_meta_as("meta"):
            pass
    with route_meta_as("cuda"):
        out, lse = tfa.flash_attention(q, q, q)
    assert out.shape == q.shape and lse.shape == (1, 1, 1024)
    assert lse.dtype == torch.float32


def test_measure_flops_script_on_the_cpu(capsys):
    got = measure_flops.main([
        "--batch", "2", "--size", "64", "--device", "cpu", "--builder",
        "diffusion_torch.models.models.stable_diffusion_tiny"])
    line = capsys.readouterr().out.splitlines()[0]
    assert line.startswith("flops_per_batch: ") and "on cpu" in line
    assert float(line.split()[1]) == pytest.approx(sum(got.values()),
                                                   rel=1e-6)
    assert got["flash"] == 0.0 and got["dot"] > 0 and got["conv"] > 0
