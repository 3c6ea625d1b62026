"""The port's full-width FID InceptionV3 against the Flax one: random params
with randomized BatchNorm statistics, moved by `inception_from_jax` and
also loaded from an `.npz` in `tools/port_weights.py`'s layout; features
and logits on 2 images at 299, 256 (upsampled) and 512 (downsampled)
through both packages' `preprocess_images`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_tpu.models import inception as jinception
from diffusion_tpu.models.port_hf import port_inception
from diffusion_torch.metrics import towers
from diffusion_torch.models import inception as tinception
from diffusion_torch.models.port_jax import inception_from_jax

torch.set_num_threads(1)

SIZES = (299, 256, 512)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / np.linalg.norm(want))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, path))
        else:
            out[path] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def variables():
    """Flax variables: the init's params, with the BatchNorm scales, biases
    and running statistics drawn away from their constant init (a wrong
    mapping of any of them shows)."""
    model = jinception.InceptionV3()
    init = jax.jit(lambda k: model.init(k, jnp.zeros((1, 75, 75, 3)),
                                        return_logits=True))
    tree = jax.tree.map(np.asarray, init(jax.random.key(0)))
    rng = np.random.default_rng(0)
    flat = _flat(tree)
    for path, v in flat.items():
        if path.endswith("bn/scale"):
            flat[path] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif path.endswith("bn/bias") or path.endswith("bn/mean"):
            flat[path] = rng.normal(0.0, 0.5, v.shape).astype(np.float32)
        elif path.endswith("bn/var"):
            flat[path] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        for p in path.split("/")[:-1]:
            node = node.setdefault(p, {})
        node[path.split("/")[-1]] = v
    return model, tree, flat


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(1)
    return {s: rng.uniform(0, 1, (2, s, s, 3)).astype(np.float32)
            for s in SIZES}


def test_preprocess_matches_jax(images):
    """`F.interpolate(bilinear, antialias=True)` is `jax.image.resize`'s
    bilinear, which antialiases when it shrinks (bound 1e-5 absolute on
    [-1, 1] images; without antialiasing the 512 -> 299 shrink is off by
    up to 0.55)."""
    for s, img in images.items():
        want = np.asarray(jinception.preprocess_images(jnp.asarray(img)))
        got = tinception.preprocess_images(torch.from_numpy(img)).numpy()
        assert got.shape == want.shape == (2, 299, 299, 3)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_state_dict_keys_are_torchvision(variables):
    """`inception_from_jax` gives exactly the port module's keys, and is
    the inverse of `port_inception` (one weights file serves both)."""
    _, tree, flat = variables
    sd = inception_from_jax(tree)
    net = tinception.InceptionV3()
    assert sorted(sd) == sorted(net.state_dict())
    back = port_inception({k: v.numpy() for k, v in sd.items()})
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)


def test_features_and_logits_match_flax(variables, images, tmp_path):
    """All three sizes' preprocessed pairs go through each tower as one
    batch of 6 (one compile on the JAX side). fp32 both ways: XLA's and
    oneDNN's convolutions sum in different orders, about 1e-7 relative a
    layer over ~100 layers; bound 1e-5 relative L2 (features and
    logits). The port runs the weights moved in memory and the same
    weights read back from an `.npz` in `port_weights` layout."""
    model, tree, flat = variables
    jx = jnp.concatenate([jinception.preprocess_images(jnp.asarray(images[s]))
                          for s in SIZES])
    want_f = np.asarray(jax.jit(lambda x: model.apply(tree, x))(jx))
    want_l = np.asarray(jax.jit(lambda x: model.apply(
        tree, x, return_logits=True))(jx))
    tx = torch.cat([tinception.preprocess_images(torch.from_numpy(images[s]))
                    for s in SIZES])
    npz = tmp_path / "inception.npz"
    np.savez(npz, **flat)
    for source in ("memory", "npz"):
        net = tinception.InceptionV3()
        if source == "memory":
            net.load_state_dict(inception_from_jax(tree))
        else:
            loaded = tinception.load_inception_params(str(npz))
            net.load_state_dict(inception_from_jax(loaded))
        net.eval()
        with torch.inference_mode():
            got_f = net(tx).numpy()
            got_l = net(tx, return_logits=True).numpy()
        assert got_f.shape == (6, 2048) and got_l.shape == (6, 1008)
        for i, s in enumerate(SIZES):
            rows = slice(2 * i, 2 * i + 2)
            assert _rel(got_f[rows], want_f[rows]) <= 1e-5, (source, s)
            assert _rel(got_l[rows], want_l[rows]) <= 1e-5, (source, s)


def test_tower_fns_load_the_npz(variables, images, tmp_path, monkeypatch):
    """`inception_feature_fn` / `inception_logits_fn` read the weights
    file named by `DIFFUSION_TPU_INCEPTION_WEIGHTS`, as the JAX package's
    do, share one module, and return host float32 arrays."""
    model, tree, flat = variables
    npz = tmp_path / "env_inception.npz"
    np.savez(npz, **flat)
    monkeypatch.setenv("DIFFUSION_TPU_INCEPTION_WEIGHTS", str(npz))
    feats = towers.inception_feature_fn(device="cpu")
    logits = towers.inception_logits_fn(device="cpu", tower=feats.tower)
    # one module shared by hand (`tower=`), as the hook shares it; no
    # tower is cached for the process
    assert logits.tower is feats.tower
    assert towers.inception_tower(device="cpu") is not feats.tower
    f = feats(images[256])
    lg = logits(torch.from_numpy(images[256]))
    assert f.dtype == np.float32 and f.shape == (2, 2048)
    want = np.asarray(model.apply(tree, jinception.preprocess_images(
        jnp.asarray(images[256]))))
    assert _rel(f, want) <= 1e-5 and lg.shape == (2, 1008)
