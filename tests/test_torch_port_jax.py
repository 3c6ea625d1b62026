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
    """port_vae needs the encoder too: take it from the diffusers-named
    torch reference; vae_from_jax keeps only what the port decodes with."""
    sd = _random(AutoencoderKL(VAEConfig(**WIDTHS_VAE_SPEC)), 2)
    encoder = {k: v for k, v in TorchAutoencoderKL(WIDTHS_VAE_SPEC)
               .state_dict().items()
               if k.startswith(("encoder.", "quant_conv."))}
    _assert_same(vae_from_jax(port_vae(_numpy({**sd, **encoder}))), sd)


def test_clip_text_round_trip():
    cfg = CLIPTextConfig(vocab_size=514, hidden_size=32, intermediate_size=64,
                         num_hidden_layers=3, num_attention_heads=2)
    sd = _random(CLIPTextModel(cfg), 3)
    _assert_same(clip_text_from_jax(port_clip_text(_numpy(sd))), sd)


def test_port_imports_no_jax():
    """Every diffusion_torch module imports without pulling in jax/flax or
    any module of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import diffusion_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "diffusion_torch.__path__, 'diffusion_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'orbax', 'diffusion_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ)
    env.pop("PYTHONSTARTUP", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 15      # every module was seen
