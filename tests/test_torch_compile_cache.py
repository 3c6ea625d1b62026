"""The kernel library's build cache (`diffusion_torch/utils/compile_cache.py`),
the counterpart of JAX's persistent compilation cache: where
`ops/_build.py` builds and finds the library, from the argument, the
environment, the yaml's `compile_cache_dir` through `train()`, and the
server's `--compile-cache`. Path resolution only: the kernels are built on
the card (`chip_smoke.py` phase 18(d) shows a second process on a shared
directory running no nvcc)."""

import os
import types

import pytest

from diffusion_torch.config import load_config
from diffusion_torch.inference import serve
from diffusion_torch.ops import _build
from diffusion_torch.train import train as ttrain
from diffusion_torch.utils.compile_cache import enable_compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def restore_build_dir(monkeypatch):
    monkeypatch.delenv("DIFFUSION_TORCH_COMPILE_CACHE", raising=False)
    before = _build.BUILD_DIR
    yield
    _build.set_build_dir(before)


def test_noop_when_unset():
    before = _build.library_path()
    assert enable_compile_cache(None) is None
    assert _build.library_path() == before
    assert os.path.dirname(before) == os.path.join(ROOT, "build",
                                                   "diffusion_torch")


def test_moves_the_library_under_the_directory(tmp_path):
    got = enable_compile_cache(tmp_path / "cc", min_compile_time_secs=0.0)
    assert got == str(tmp_path / "cc") and os.path.isdir(got)
    name = f"libdiffusion_torch_{_build._digest()}.so"
    assert _build.library_path() == os.path.join(got, name)
    assert os.path.dirname(_build.build_log()) == got


def test_env_var_fallback(tmp_path, monkeypatch):
    monkeypatch.setenv("DIFFUSION_TORCH_COMPILE_CACHE", str(tmp_path / "env"))
    got = enable_compile_cache(None)
    assert got == str(tmp_path / "env") and os.path.isdir(got)
    assert os.path.dirname(_build.library_path()) == got
    # an argument wins over the environment
    assert enable_compile_cache(tmp_path / "arg") == str(tmp_path / "arg")


def test_a_new_directory_drops_the_loaded_library(tmp_path, monkeypatch):
    """`library()` is cached per process: a new directory clears it, so
    the next launch loads the cache's library (here a stand-in file,
    loaded by a stand-in for ctypes)."""
    class _Lib:
        def __init__(self, path):
            self.path = path

        def __getattr__(self, name):
            return types.SimpleNamespace()

    monkeypatch.setattr(_build.ctypes, "CDLL", _Lib)
    for d in ("a", "b"):
        enable_compile_cache(tmp_path / d)
        open(_build.library_path(), "w").close()
    enable_compile_cache(tmp_path / "a")
    first = _build.library()
    assert first is _build.library()
    assert os.path.dirname(first.path) == str(tmp_path / "a")
    enable_compile_cache(tmp_path / "b")
    assert os.path.dirname(_build.library().path) == str(tmp_path / "b")
    _build.library.cache_clear()


def test_the_yamls_compile_cache_dir_reaches_train(tmp_path, monkeypatch):
    """`yamls/SD-2-base-256-lora.yaml` carries `compile_cache_dir`; set, it
    moves the library before the trainer is built."""
    seen = {}

    class _Trainer:
        evaluators = []

        def fit(self):
            seen["fit"] = _build.library_path()

        def close(self):
            pass

    def build_trainer(config):
        seen["build"] = _build.BUILD_DIR
        return _Trainer()

    monkeypatch.setattr(ttrain, "build_trainer", build_trainer)
    path = os.path.join(ROOT, "yamls", "SD-2-base-256-lora.yaml")
    config = load_config(path)
    assert "compile_cache_dir" in config and not config["compile_cache_dir"]
    ttrain.train(config)
    assert seen["build"] == _build.BUILD_DIR != str(tmp_path)
    config = load_config(path, [f"compile_cache_dir={tmp_path / 'cc'}"])
    ttrain.train(config)
    assert seen["build"] == str(tmp_path / "cc")
    assert os.path.dirname(seen["fit"]) == str(tmp_path / "cc")


def test_the_server_takes_compile_cache():
    args = serve._parser().parse_args(["--compile-cache", "/tmp/cc",
                                       "--device", "cpu"])
    assert args.compile_cache == "/tmp/cc" and args.device == "cpu"
    assert serve._parser().parse_args([]).compile_cache is None
