"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names; the reference loads nothing of the
program."""

import ast
import glob
import os
import subprocess
import sys

from portbench import common
from portbench.tests.tiny import ROOT


def test_whole_top_level_names(monkeypatch):
    for name in ("jaxtyping", "diffusion_torch.x", "flaxen", "optax_like"):
        monkeypatch.setitem(sys.modules, name, object())
    assert common.forbidden_modules() == []
    for name in ("jax", "jaxlib.xla", "flax.linen", "optax", "orbax.ckpt",
                 "diffusion_tpu.models"):
        monkeypatch.setitem(sys.modules, name, object())
    assert common.forbidden_modules() == sorted(
        ["jax", "jaxlib.xla", "flax.linen", "optax", "orbax.ckpt",
         "diffusion_tpu.models"])


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_sources_import_no_jax_and_the_reference_nothing_of_the_port():
    files = glob.glob(os.path.join(common.HERE, "**", "*.py"), recursive=True)
    for path in files:
        assert not set(_imports(path)) & set(common.FORBIDDEN), path
    for path in glob.glob(os.path.join(common.HERE, "reference", "*.py")):
        assert "diffusion_torch" not in set(_imports(path)), path


def test_a_run_and_the_reference_load_none_of_it():
    code = (
        "import sys, time, torch\n"
        "import portbench.reference.train, portbench.reference.lowp\n"
        "assert not [m for m in sys.modules "
        "if m.split('.')[0] == 'diffusion_torch'], 'reference'\n"
        "from portbench.tests.tiny import tiny_files\n"
        "from portbench.kinds import train\n"
        "train.run(tiny_files(), 5, 0.2, False, torch.device('cpu'), "
        "time.perf_counter())\n"
        "from portbench import common\n"
        "print(common.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
