"""The CLIPScore towers: the port's `CLIPModel` (ViT vision tower with its
class token, quick-GELU text tower, both projections) against Flax's at a
small config with the same weights, and `clip_embed_fn`'s resize (bilinear,
antialiased) and CLIP normalization at 256 and 512 against the JAX
package's, both reading one `.npz` in `port_clip_metric` layout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_tpu.metrics import towers as jtowers
from diffusion_tpu.models import clip as jclip
from diffusion_tpu.models.port_hf import port_clip_metric
from diffusion_torch.metrics import towers as ttowers
from diffusion_torch.models import clip as tclip
from diffusion_torch.models.port_jax import clip_model_from_jax

torch.set_num_threads(1)

# small towers; the vision tower keeps ViT-L/14's 224px input and 14px
# patches, so the resize and the 257-token sequence are the real ones
TEXT = dict(vocab_size=514, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=2,
            hidden_act="quick_gelu", projection_dim=24)
VISION = dict(image_size=224, patch_size=14, hidden_size=32,
              intermediate_size=64, num_hidden_layers=2,
              num_attention_heads=2)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / np.linalg.norm(want))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if hasattr(v, "items"):
            out.update(_flat(v, path))
        else:
            out[path] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def flax_clip():
    model = jclip.CLIPModel(jclip.CLIPTextConfig(**TEXT),
                            jclip.CLIPVisionConfig(**VISION))
    params = model.init(jax.random.key(0), jnp.zeros((1, 77), jnp.int32),
                        jnp.zeros((1, 224, 224, 3)))
    # every leaf off its constant init (norms, biases, embeddings)
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda v: np.asarray(v) + rng.normal(
        0, 0.1, v.shape).astype(np.float32), params)
    return model, params


def _ids(n=2):
    rng = np.random.default_rng(3)
    ids = rng.integers(1, 400, (n, 77)).astype(np.int32)
    ids[:, 9] = 513                  # the EOT token, the highest id
    return ids


def test_clip_model_matches_flax(flax_clip):
    """Text features (pooled at EOT, projected), image features (the
    post-LayerNormed class token, projected) and the vision tower's last
    hidden state, fp32 both ways: bound 1e-5 relative L2."""
    model, params = flax_clip
    port = tclip.CLIPModel(tclip.CLIPTextConfig(**TEXT),
                           tclip.CLIPVisionConfig(**VISION))
    port.load_state_dict(clip_model_from_jax(params))
    ids = _ids()
    pix = np.random.default_rng(4).normal(
        0, 1, (2, 224, 224, 3)).astype(np.float32)
    want_t, want_i = model.apply(params, jnp.asarray(ids), jnp.asarray(pix))
    with torch.inference_mode():
        got_t, got_i = port(torch.from_numpy(ids).long(),
                            torch.from_numpy(pix))
        hidden, _ = tclip._vision_forward(port.vision_model, torch.float32,
                                          torch.from_numpy(pix))
    want_h, _ = jclip.CLIPVisionModel(jclip.CLIPVisionConfig(**VISION)).apply(
        {"params": params["params"]["vision_model"]}, jnp.asarray(pix))
    assert got_t.shape == (2, 24) and got_i.shape == (2, 768)
    assert hidden.shape == (2, 257, 32)
    assert _rel(got_t.numpy(), want_t) <= 1e-5
    assert _rel(got_i.numpy(), want_i) <= 1e-5
    assert _rel(hidden.numpy(), want_h) <= 1e-5


def test_clip_model_keys_are_transformers(flax_clip):
    """The port's CLIPModel carries transformers' CLIPModel names, so
    `clip_model_from_jax` inverts `port_clip_metric` exactly."""
    _, params = flax_clip
    sd = clip_model_from_jax(params)
    port = tclip.CLIPModel(tclip.CLIPTextConfig(**TEXT),
                           tclip.CLIPVisionConfig(**VISION))
    assert sorted(sd) == sorted(port.state_dict())
    assert "vision_model.pre_layrnorm.weight" in sd
    assert "vision_model.embeddings.class_embedding" in sd
    assert "text_projection.bias" not in sd
    flat = port_clip_metric({k: v.numpy() for k, v in sd.items()})
    want = _flat(params)
    assert sorted(flat) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k])


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_activations(act):
    """Exact erf GELU and quick GELU on [-6, 6]. torch's and XLA's fp32
    erf differ in the negative tail (torch rounds GELU(-6) to -0, XLA
    gives -6e-9), by at most 6e-7 there: bound 1e-6 absolute."""
    x = torch.linspace(-6, 6, 97)
    want = np.asarray(jclip._act(act)(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(tclip._act(act, x).numpy(), want,
                               rtol=1e-6, atol=1e-6)


def test_clip_embed_fn_matches_jax(flax_clip, tmp_path, monkeypatch):
    """Both packages' `clip_embed_fn` read the same `.npz` (named by
    `DIFFUSION_TPU_CLIP_WEIGHTS`) into the small towers (the configs
    monkeypatched on both sides), resize [0, 1] images from 256 and 512
    to 224 and normalize them: embeddings within 1e-5 relative L2, and the
    normalized pixels within 1e-5 absolute."""
    _, params = flax_clip
    npz = tmp_path / "clip.npz"
    np.savez(npz, **_flat(params))
    monkeypatch.setenv("DIFFUSION_TPU_CLIP_WEIGHTS", str(npz))
    for mod, pkg in ((jtowers, jclip), (ttowers, tclip)):
        monkeypatch.setattr(mod, "VIT_L14_TEXT_CONFIG",
                            pkg.CLIPTextConfig(**TEXT))
        monkeypatch.setattr(mod, "VIT_L14_VISION_CONFIG",
                            pkg.CLIPVisionConfig(**VISION))
    jfn = jtowers.clip_embed_fn()
    tfn = ttowers.clip_embed_fn(device="cpu")
    rng = np.random.default_rng(5)
    ids = _ids()
    for size in (256, 512, 224):
        img = rng.uniform(0, 1, (2, size, size, 3)).astype(np.float32)
        want_i, want_t = jfn(jnp.asarray(img), jnp.asarray(ids))
        got_i, got_t = tfn(torch.from_numpy(img), ids)
        assert got_i.dtype == np.float32 and got_i.shape == (2, 768)
        assert _rel(got_i, want_i) <= 1e-5, size
        assert _rel(got_t, want_t) <= 1e-5, size
        want_px = jax.image.resize(jnp.asarray(img), (2, 224, 224, 3),
                                   "bilinear")
        want_px = (want_px - jtowers._CLIP_MEAN) / jtowers._CLIP_STD
        got_px = ttowers.clip_pixels(torch.from_numpy(img), 224)
        np.testing.assert_allclose(got_px.numpy(), np.asarray(want_px),
                                   atol=1e-5, rtol=0)


def test_random_towers_refused(monkeypatch):
    """Without weights, both packages refuse the towers unless allowed (by
    argument or `DIFFUSION_TPU_ALLOW_RANDOM_TOWERS=1`); a configured path
    that does not exist raises on both sides."""
    for var in ("DIFFUSION_TPU_CLIP_WEIGHTS",
                "DIFFUSION_TPU_INCEPTION_WEIGHTS",
                "DIFFUSION_TPU_ALLOW_RANDOM_TOWERS"):
        monkeypatch.delenv(var, raising=False)
    for fn in ("clip_embed_fn", "inception_feature_fn",
               "inception_logits_fn"):
        with pytest.raises(RuntimeError, match="No pretrained weights"):
            getattr(jtowers, fn)()
        with pytest.raises(RuntimeError, match="No pretrained weights"):
            getattr(ttowers, fn)(device="cpu")
        with pytest.raises(FileNotFoundError):
            getattr(ttowers, fn)("/nonexistent/tower.npz", device="cpu")
    monkeypatch.setenv("DIFFUSION_TPU_INCEPTION_WEIGHTS", "/nonexistent.npz")
    with pytest.raises(FileNotFoundError, match="does not exist"):
        jtowers.inception_feature_fn()
    with pytest.raises(FileNotFoundError, match="does not exist"):
        ttowers.inception_feature_fn(device="cpu")
    monkeypatch.delenv("DIFFUSION_TPU_INCEPTION_WEIGHTS")
    monkeypatch.setenv("DIFFUSION_TPU_ALLOW_RANDOM_TOWERS", "1")
    fn = ttowers.inception_feature_fn(device="cpu")
    assert fn(np.zeros((1, 32, 32, 3), np.float32)).shape == (1, 2048)


def test_towers_need_cuda_unless_asked(monkeypatch):
    """The towers' default device is CUDA: without it they raise, naming
    device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ttowers.inception_feature_fn(allow_random_weights=True)


class _FlagProbe(torch.nn.Module):
    """A stand-in tower that records the TF32 flags its forward sees."""

    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(1, 1)
        self.text_projection = torch.nn.Linear(1, 1)
        self.vision_config = tclip.CLIPVisionConfig(image_size=8)
        self.seen = []

    def forward(self, *args, **kwargs):
        self.seen.append((torch.backends.cudnn.allow_tf32,
                          torch.backends.cuda.matmul.allow_tf32))
        z = torch.zeros(args[0].shape[0], 4)
        return (z, z) if len(args) == 2 else z


def test_tower_forwards_run_without_tf32(monkeypatch):
    """Every tower forward runs with TF32 off for cuDNN and cuBLAS, however
    the caller left the flags, and gives the caller's flags back."""
    probe = _FlagProbe()
    monkeypatch.setattr(ttowers, "_tower", lambda kind, path, device: probe)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    images = np.zeros((2, 8, 8, 3), np.float32)
    kw = dict(allow_random_weights=True, device="cpu")
    ttowers.inception_feature_fn(**kw)(images)
    ttowers.inception_logits_fn(**kw)(images)
    ttowers.clip_embed_fn(**kw)(images, np.zeros((2, 77), np.int64))
    assert probe.seen == [(False, False)] * 3
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32
