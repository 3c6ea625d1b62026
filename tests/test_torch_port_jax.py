"""`models/port_jax.py` is the exact inverse of `port_hf.port_*`, and the
port imports no JAX."""

import os
import subprocess
import sys

import torch

from diffusion_tpu.models.port_hf import port_clip_text, port_unet, port_vae
from diffusion_torch.models.clip import CLIPTextConfig, CLIPTextModel
from diffusion_torch.models.layers import init_like_flax_
from diffusion_torch.models.port_jax import (clip_text_from_jax,
                                             unet_from_jax, vae_from_jax)
from diffusion_torch.models.unet import UNet2DCondition, UNetConfig
from diffusion_torch.models.vae import AutoencoderKL, VAEConfig
from tools.capture_goldens import ASYM_UNET_SPEC, WIDTHS_VAE_SPEC
from tools.torch_ref import TorchAutoencoderKL

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random(module, seed):
    init_like_flax_(module, torch.Generator().manual_seed(seed))
    with torch.no_grad():   # norms and biases off their constant init too
        for p in module.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator()
                               .manual_seed(seed + p.numel())) * 0.1)
    return {k: v.clone() for k, v in module.state_dict().items()}


def _numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


def test_unet_round_trip():
    for spec, seed in ((ASYM_UNET_SPEC, 0), (dict(ASYM_UNET_SPEC,
                       use_linear_projection=False), 1)):
        sd = _random(UNet2DCondition(UNetConfig(**spec)), seed)
        _assert_same(unet_from_jax(port_unet(_numpy(sd))), sd)


def test_vae_round_trip():
    """The whole VAE, encoder and quant_conv included, through port_vae
    and back; its keys are the diffusers-named torch reference's."""
    sd = _random(AutoencoderKL(VAEConfig(**WIDTHS_VAE_SPEC)), 2)
    assert sorted(sd) == sorted(TorchAutoencoderKL(WIDTHS_VAE_SPEC)
                                .state_dict())
    assert any(k.startswith("encoder.down_blocks.0.downsamplers.0.conv")
               for k in sd) and "quant_conv.weight" in sd
    _assert_same(vae_from_jax(port_vae(_numpy(sd))), sd)


def test_clip_text_round_trip():
    cfg = CLIPTextConfig(vocab_size=514, hidden_size=32, intermediate_size=64,
                         num_hidden_layers=3, num_attention_heads=2)
    sd = _random(CLIPTextModel(cfg), 3)
    _assert_same(clip_text_from_jax(port_clip_text(_numpy(sd))), sd)


def test_port_imports_no_jax():
    """Every diffusion_torch module, the training slice's and the composed
    run's included, imports without pulling in jax/flax/optax, any module
    of the JAX package, or the safetensors and msgpack packages (the card's
    machine has neither: the port reads both formats itself)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import diffusion_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "diffusion_torch.__path__, 'diffusion_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'orbax', 'diffusion_tpu', "
        "'safetensors', 'msgpack')]\n"
        "assert not bad, bad\n"
        "print(' '.join(names))\n")
    env = dict(os.environ)
    env.pop("PYTHONSTARTUP", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    seen = set(proc.stdout.split())
    # the training slice's modules among them, and the composed run's
    assert {f"diffusion_torch.{m}" for m in (
        "train.trainer", "train.optim", "train.state", "train.events",
        "algorithms.ema", "utils.time", "utils.logging", "utils.device",
        "ops.flash_attention", "ops.groupnorm", "config.loader",
        "data.dataloader", "data.laion", "data.coco", "data.native",
        "metrics.mse", "callbacks.monitors", "algorithms.low_precision",
        "train.train", "run", "train.checkpoint", "models.pretrained",
        "utils.safetensors", "utils.flax_msgpack", "data.wds",
        "data.datapipes", "data.filters")} <= seen
    assert len(seen) >= 50                          # every module was seen
