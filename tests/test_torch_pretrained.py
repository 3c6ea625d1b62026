"""Published weights through the port: its safetensors and flax-msgpack
readers, `pretrained=True`, and serving a Trainer checkpoint.

A tiny diffusers-layout directory is built as `tests/test_pretrained.py`
builds it: `tools/torch_ref.py`'s diffusers-faithful UNet and VAE (the
encoder included) and a `transformers` `CLIPTextModel`, with seeded random
weights, in both layouts the loaders read: the msgpack trio
(`tools/port_weights.py`'s format, through `flax.serialization`) and
safetensors subdirectories (written by the `safetensors` package, the
text encoder's file carrying transformers' `position_ids` buffer). The
JAX package's `load_pretrained_params` and the port's builder load each;
their UNet outputs, VAE decodes, CLIP hidden states and a 2-step
`generate` must agree at fp32 tolerances (stated at each check), and both
layouts must give the port identical tensors.

The endpoint: a Trainer checkpoint of the port (EMA-active) served through
`file://` beside the pretrained towers."""

import base64
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffusion_tpu.models.models import stable_diffusion_tiny as jax_tiny
from diffusion_tpu.models.port_hf import port_clip_text, port_unet, port_vae
from diffusion_tpu.models.pretrained import load_pretrained_params as jload
from diffusion_torch.algorithms.ema import EMA
from diffusion_torch.inference.inference_model import StableDiffusionInference
from diffusion_torch.models import pretrained as tpre
from diffusion_torch.models.models import stable_diffusion_tiny
from diffusion_torch.train import checkpoint as ckpt
from diffusion_torch.train.optim import adamw
from diffusion_torch.train.trainer import Trainer
from diffusion_torch.utils import flax_msgpack
from diffusion_torch.utils import safetensors as tsafe

transformers = pytest.importorskip("transformers")
torch.set_num_threads(1)

# geometry of both packages' stable_diffusion_tiny
UNET_SPEC = dict(in_channels=4, out_channels=4, block_out_channels=(32, 64),
                 layers_per_block=1, block_has_attention=(True, False),
                 attention_head_dim=(2, 4), cross_attention_dim=32,
                 norm_num_groups=8, use_linear_projection=True)
VAE_SPEC = dict(in_channels=3, out_channels=3, latent_channels=4,
                block_out_channels=(8, 8, 8, 8), layers_per_block=1,
                norm_num_groups=4)
_FILES = {"unet": "diffusion_pytorch_model.safetensors",
          "vae": "diffusion_pytorch_model.safetensors",
          "text_encoder": "model.safetensors"}


def _torch_towers():
    from tools.torch_ref import TorchAutoencoderKL, TorchUNet2DCondition
    torch.manual_seed(0)
    unet = TorchUNet2DCondition(UNET_SPEC).eval()
    vae = TorchAutoencoderKL(VAE_SPEC).eval()
    text = transformers.CLIPTextModel(transformers.CLIPTextConfig(
        vocab_size=514, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=2,
        max_position_embeddings=77, hidden_act="gelu",
        layer_norm_eps=1e-5)).eval()
    with torch.no_grad():          # norms and biases off their constant init
        for module in (unet, vae, text):
            for p in module.parameters():
                p.add_(torch.randn(p.shape) * 0.05)
    return {"unet": unet, "vae": vae, "text_encoder": text}


def _state_dicts(towers):
    sds = {k: {n: v.detach().clone() for n, v in m.state_dict().items()}
           for k, m in towers.items()}
    # older transformers checkpoints carry the position-index buffer
    sds["text_encoder"]["text_model.embeddings.position_ids"] = \
        torch.arange(77)[None]
    return sds


def _write_safetensors(root, sds, dtype=None):
    from safetensors.torch import save_file
    for name, sd in sds.items():
        os.makedirs(os.path.join(root, name))
        save_file({k: (v.to(dtype) if dtype and v.is_floating_point() else v)
                   .contiguous() for k, v in sd.items()},
                  os.path.join(root, name, _FILES[name]))
    return str(root)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    import flax.serialization
    towers = _torch_towers()
    sds = _state_dicts(towers)
    trio = tmp_path_factory.mktemp("msgpack_trio")
    for name, porter in (("unet", port_unet), ("vae", port_vae),
                         ("text_encoder", port_clip_text)):
        tree = porter({k: v.numpy() for k, v in sds[name].items()})
        (trio / f"{name}.msgpack").write_bytes(
            flax.serialization.msgpack_serialize(tree))
    subdirs = _write_safetensors(tmp_path_factory.mktemp("safetensors"), sds)
    return {"msgpack": str(trio), "safetensors": subdirs, "sds": sds}


@pytest.fixture(scope="module")
def loaded(dirs):
    """Per layout: the JAX (params, frozen) and the port's model."""
    out = {}
    for layout in ("msgpack", "safetensors"):
        jmodel = jax_tiny(pretrained=True, model_name=dirs[layout])
        out[layout] = (jmodel, *jload(jmodel, image_size=64),
                       stable_diffusion_tiny(device="cpu", pretrained=True,
                                             model_name=dirs[layout]))
    return out


def _all_tensors(model):
    return {f"{part}.{k}": v for part in ("unet", "vae", "text_encoder")
            for k, v in getattr(model, part).state_dict().items()}


def test_both_layouts_give_identical_port_tensors(dirs, loaded):
    a = _all_tensors(loaded["msgpack"][3])
    b = _all_tensors(loaded["safetensors"][3])
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == torch.float32 and torch.equal(a[k], b[k]), k
    # and they are the published tensors, under their own names
    for name in ("unet", "text_encoder"):
        own = getattr(loaded["safetensors"][3], name).state_dict()
        for k, v in own.items():
            assert torch.equal(v, dirs["sds"][name][k]), k
    assert loaded["safetensors"][3].pretrained_path == dirs["safetensors"]


@pytest.mark.parametrize("layout", ["msgpack", "safetensors"])
def test_outputs_match_jax(monkeypatch, loaded, layout):
    monkeypatch.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "0")
    jmodel, params, frozen, model = loaded[layout]
    rng = np.random.default_rng(1)
    ids = rng.integers(1, 500, (2, 77)).astype(np.int64)
    want_text, _ = jmodel.text_encoder.apply(frozen["text_encoder"],
                                             jnp.asarray(ids, jnp.int32))
    sample = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.asarray([7, 421], np.int64)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    want_unet = jmodel.unet.apply(params, jnp.asarray(sample),
                                  jnp.asarray(t), jnp.asarray(ctx))
    want_vae = jmodel.vae.apply(frozen["vae"], jnp.asarray(sample),
                                method=jmodel.vae.decode)
    with torch.no_grad():
        text, _ = model.text_encoder(torch.from_numpy(ids))
        unet = model.unet(torch.from_numpy(sample).permute(0, 3, 1, 2),
                          torch.from_numpy(t), torch.from_numpy(ctx))
        vae = model.vae.decode(torch.from_numpy(sample).permute(0, 3, 1, 2))
    # fp32 both ways, the tolerances of the port's module parity tests:
    # CLIP (flax LayerNorm's one-pass variance) and the VAE decoder 1e-4;
    # the UNet's ~25 layers 1e-4 + 1e-4 relative
    np.testing.assert_allclose(text.numpy(), np.asarray(want_text),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(unet.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_unet), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(vae.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_vae), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("layout", ["msgpack", "safetensors"])
def test_generate_matches_jax(monkeypatch, loaded, layout):
    monkeypatch.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "0")
    jmodel, params, frozen, model = loaded[layout]
    ids = jmodel.tokenizer(["a red fox", "a lighthouse"])["input_ids"]
    seed, shape = 3, (2, 8, 8, 4)
    want = jmodel.generate(params, frozen, jnp.asarray(ids), height=64,
                           width=64, guidance_scale=7.5,
                           num_inference_steps=2, seed=seed)
    noise = np.array(jax.random.normal(jax.random.key(seed), shape,
                                       jnp.float32))
    got = model.generate(torch.from_numpy(ids), height=64, width=64,
                         guidance_scale=7.5, num_inference_steps=2,
                         latents=torch.from_numpy(noise))
    # test_torch_generate.py's tolerance: two CFG UNet calls, then decode
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=0)


def test_fp16_weights_become_fp32_masters(dirs, tmp_path):
    root = _write_safetensors(tmp_path, dirs["sds"], dtype=torch.float16)
    model = stable_diffusion_tiny(device="cpu", pretrained=True,
                                  model_name=root)
    for name in ("unet", "vae", "text_encoder"):
        for k, v in getattr(model, name).state_dict().items():
            want = dirs["sds"][name][k].half().float()
            assert v.dtype == torch.float32 and torch.equal(v, want), k


def test_precomputed_latents_load_no_towers(dirs, tmp_path):
    """The JAX rule: no towers on the precomputed-latent path, so a
    directory without them loads."""
    root = _write_safetensors(tmp_path, {"unet": dirs["sds"]["unet"]})
    model = stable_diffusion_tiny(device="cpu", precomputed_latents=True,
                                  pretrained=True, model_name=root)
    assert model.vae is None and model.text_encoder is None
    assert torch.equal(model.unet.conv_in.weight,
                       dirs["sds"]["unet"]["conv_in.weight"])


def _bad(dirs, tmp_path, component, edit):
    sds = {k: dict(v) for k, v in dirs["sds"].items()}
    edit(sds[component])
    return _write_safetensors(tmp_path, sds)


@pytest.mark.parametrize("component,edit,match", [
    ("unet", lambda sd: sd.update({"conv_in.weight": torch.zeros(
        32, 4, 5, 3)}), "shape mismatch conv_in.weight"),
    ("unet", lambda sd: sd.pop("conv_out.bias"), "missing conv_out.bias"),
    ("unet", lambda sd: sd.update({"mid_block.extra.weight": torch.zeros(
        2)}), "unexpected mid_block.extra.weight"),
    ("text_encoder", lambda sd: sd.update({
        "text_model.embeddings.position_scale": torch.zeros(1)}),
     "unexpected text_model.embeddings.position_scale"),
])
def test_geometry_problems_raise_together(dirs, tmp_path, component, edit,
                                         match):
    root = _bad(dirs, tmp_path, component, edit)
    with pytest.raises(ValueError, match=match):
        stable_diffusion_tiny(device="cpu", pretrained=True, model_name=root)


def test_every_problem_in_one_error(dirs):
    model = stable_diffusion_tiny(device="cpu", precomputed_latents=True)
    sd = dict(dirs["sds"]["unet"])
    sd.pop("conv_out.bias")
    sd["extra"] = torch.zeros(1)
    sd["conv_in.weight"] = torch.zeros(1)
    with pytest.raises(ValueError, match="3 problems") as err:
        tpre.load_state_into("unet", model.unet, sd)
    for part in ("missing conv_out.bias", "unexpected extra",
                 "shape mismatch conv_in.weight"):
        assert part in str(err.value)


def test_missing_component_raises(dirs, tmp_path):
    root = _write_safetensors(tmp_path, {k: dirs["sds"][k]
                                         for k in ("unet", "vae")})
    with pytest.raises(FileNotFoundError, match="'text_encoder'"):
        stable_diffusion_tiny(device="cpu", pretrained=True, model_name=root)


def test_vae_encoder_keys_are_set_aside_by_name(monkeypatch, dirs, loaded):
    """No VAE key is set aside any more: the published encoder.* and
    quant_conv.* keys load from both layouts, and the loaded VAE encodes
    as JAX's does. The named rule left is transformers' position_ids; a
    key outside it still raises (above)."""
    monkeypatch.setenv("DIFFUSION_TPU_PALLAS_INTERPRET", "0")
    sd = tpre.load_component(dirs["safetensors"], "vae")
    published = dirs["sds"]["vae"]
    assert sorted(sd) == sorted(published)
    assert any(k.startswith("encoder.") for k in sd) and \
        "quant_conv.weight" in sd
    assert "vae" not in tpre.SET_ASIDE
    text = tpre.load_component(dirs["safetensors"], "text_encoder")
    assert "text_model.embeddings.position_ids" not in text
    x = np.random.default_rng(2).uniform(-1, 1, (2, 32, 48, 3)).astype(
        np.float32)
    for layout in ("msgpack", "safetensors"):
        jmodel, _, frozen, model = loaded[layout]
        for k, v in model.vae.state_dict().items():
            assert torch.equal(v, published[k]), (layout, k)
        want = jmodel.vae.apply(frozen["vae"], jnp.asarray(x),
                                method=jmodel.vae.encode)
        with torch.no_grad():
            got = model.vae.encode(torch.from_numpy(x).permute(0, 3, 1, 2))
        # fp32 both ways, the encoder parity tests' tolerance
        for g, w in ((got.mean, want.mean), (got.logvar, want.logvar)):
            np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                       np.asarray(w), atol=1e-4, rtol=1e-3)


# ------------------------------------------------------------- formats


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16, torch.int64])
def test_safetensors_agrees_with_the_package(tmp_path, dtype):
    st = pytest.importorskip("safetensors.torch")
    g = torch.Generator().manual_seed(0)
    tensors = {"a": torch.randn(3, 5, generator=g), "b": torch.randn(
        7, generator=g), "s": torch.randn((), generator=g),
        "e": torch.zeros(0, 4)}
    tensors = {k: (v * 100).to(dtype) for k, v in tensors.items()}
    mine, theirs = str(tmp_path / "mine.st"), str(tmp_path / "theirs.st")
    tsafe.save_file(tensors, mine, metadata={"format": "pt"})
    st.save_file(tensors, theirs, metadata={"format": "pt"})
    for got in (st.load_file(mine), tsafe.load_file(theirs),
                tsafe.load_file(mine)):
        assert sorted(got) == sorted(tensors)
        for k, v in tensors.items():
            assert got[k].dtype == dtype and torch.equal(got[k], v), k
    assert tsafe.read_header(theirs)[1] == {"format": "pt"}


def test_msgpack_reader_refuses_other_ext_types():
    with pytest.raises(ValueError, match="ext type 5"):
        flax_msgpack.unpackb(b"\xd4\x05\x00")


# ------------------------------------------------------------ serving


@pytest.fixture(scope="module")
def trained(dirs, tmp_path_factory):
    """A port Trainer run from the pretrained UNet with an EMA: ba2."""
    folder = str(tmp_path_factory.mktemp("run"))
    rng = np.random.default_rng(0)
    batches = [{"image_latents": rng.standard_normal(
        (2, 8, 8, 4)).astype(np.float32),
        "caption_latents": rng.standard_normal((2, 77, 32)).astype(
            np.float32)} for _ in range(2)]
    model = stable_diffusion_tiny(device="cpu", precomputed_latents=True,
                                  pretrained=True,
                                  model_name=dirs["safetensors"])
    tr = Trainer(model=model, train_dataloader=batches,
                 optimizers=adamw(lr=1e-2), algorithms=[EMA(smoothing=0.5)],
                 max_duration="2ba", save_folder=folder, save_interval="2ba",
                 device="cpu")
    tr.fit()
    tr.close()
    ema = {n: e.clone() for n, e in tr.train_state.ema_params.items()}
    assert any(not torch.equal(ema[n], p)
               for n, p in tr.train_state.params.items())
    return os.path.join(folder, "ba2"), ema


def test_endpoint_serves_the_checkpoint_and_the_towers(dirs, trained,
                                                       monkeypatch,
                                                       tmp_path):
    monkeypatch.setenv("HOME", str(tmp_path))          # the fetch cache
    path, ema = trained
    endpoint = StableDiffusionInference(
        builder=stable_diffusion_tiny, device="cpu", pretrained=True,
        model_name=dirs["safetensors"], checkpoint_path="file://" + path,
        default_size=64)
    assert endpoint.checkpoint_file.startswith(str(tmp_path))
    model = endpoint.model
    for n, p in model.unet.named_parameters():
        assert torch.equal(p, ema[n]), n              # EMA-active params
    for name in ("vae", "text_encoder"):
        for k, v in getattr(model, name).state_dict().items():
            assert torch.equal(v, dirs["sds"][name][k]), k
    png = endpoint.predict(prompt="a fox", num_inference_steps=1,
                           height=32, width=32)[0]
    img = Image.open(io.BytesIO(base64.b64decode(png)))
    assert img.size == (32, 32)


def test_second_fetch_downloads_nothing(trained, monkeypatch, tmp_path):
    path, _ = trained
    first = ckpt.fetch_checkpoint_dir("file://" + path, str(tmp_path))
    assert os.path.exists(os.path.join(first, "state", "params.safetensors"))

    def no_download(*a, **k):
        raise AssertionError("downloaded again")

    monkeypatch.setattr(ckpt.ObjectStore, "download", no_download)
    assert ckpt.fetch_checkpoint_dir("file://" + path, str(tmp_path)) == first


def test_weights_only_directory_serves(trained, tmp_path):
    path, ema = trained
    tsafe.save_file(ema, str(tmp_path / "params.safetensors"))
    endpoint = StableDiffusionInference(
        builder=stable_diffusion_tiny, device="cpu", checkpoint_path=str(
            tmp_path), allow_random_frozen=True, default_size=32)
    for n, p in endpoint.model.unet.named_parameters():
        assert torch.equal(p, ema[n]), n


def test_endpoint_refusals(trained):
    path, _ = trained
    with pytest.raises(RuntimeError, match="randomly initialized"):
        StableDiffusionInference(builder=stable_diffusion_tiny, device="cpu",
                                 checkpoint_path=path)
    with pytest.raises(ValueError, match="hdfs://"):
        StableDiffusionInference(builder=stable_diffusion_tiny, device="cpu",
                                 checkpoint_path="hdfs://x/ba2",
                                 allow_random_frozen=True)
    with pytest.raises(FileNotFoundError, match="neither"):
        StableDiffusionInference(builder=stable_diffusion_tiny, device="cpu",
                                 checkpoint_path=os.path.dirname(path),
                                 allow_random_frozen=True)
