"""What `diffusion_torch.ops._build` knows of the CUDA sources, checked
without nvcc: every source is compiled, every header is hashed into the
library's digest (so an edit rebuilds), and every `extern "C"` entry point
has the ctypes signature its C parameters need (a short or mistyped list
lets ctypes cut a 64-bit pointer or stride to 32 bits without an error)."""

import ctypes
import glob
import os
import re

import pytest

from diffusion_torch.ops import _build

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    _build.__file__))), "csrc")
_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(dt_\w+)\s*\(([^)]*)\)')
_CTYPE = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
          "long long": ctypes.c_longlong, "float": ctypes.c_float}


def _names(pattern):
    return sorted(os.path.basename(p)
                  for p in glob.glob(os.path.join(_CSRC, pattern)))


def _entry_points():
    found = {}
    for name in _names("*.cu"):
        with open(os.path.join(_CSRC, name)) as f:
            for fn, params in _ENTRY.findall(f.read()):
                found[fn] = [" ".join(p.split()) for p in params.split(",")]
    return found


def _ctype(param: str):
    """The ctypes type of one C parameter declaration."""
    decl = re.sub(r"\b(const|__restrict__)\b", "", param)
    if "*" in decl:
        return ctypes.c_void_p
    base = " ".join(decl.split()[:-1])           # drop the parameter name
    return _CTYPE[base]


def test_every_source_is_compiled():
    assert _names("*.cu") == sorted(_build._SOURCES)


def test_every_header_is_hashed():
    assert _names("*.cuh") == sorted(_build._HEADERS)


def test_digest_follows_every_header(monkeypatch, tmp_path):
    """An edit of any header changes the library's name."""
    for name in _build._SOURCES + _build._HEADERS:
        (tmp_path / name).write_bytes(
            open(os.path.join(_CSRC, name), "rb").read())
    monkeypatch.setattr(_build, "_CSRC", str(tmp_path))
    before = _build._digest()
    for name in _build._HEADERS:
        path = tmp_path / name
        original = path.read_bytes()
        path.write_bytes(original + b"\n// edited\n")
        assert _build._digest() != before, name
        path.write_bytes(original)
    assert _build._digest() == before


def test_every_entry_point_has_a_signature():
    assert sorted(_entry_points()) == sorted(_build._SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_signature_matches_the_c_parameters(name):
    params = _entry_points()[name]
    want = [_ctype(p) for p in params]
    assert len(_build._SIGNATURES[name]) == len(params), params
    assert _build._SIGNATURES[name] == want, params
