"""The port's copy of the CLIP tokenizer gives the JAX package's ids: the
byte-level tiny tokenizer the serving path uses, and a BPE vocabulary with
merges and an SD2-style pad token loaded from a directory."""

import json

import numpy as np
import pytest

from diffusion_torch.text import tokenizer as port
from diffusion_tpu.text import tokenizer as ref

TEXTS = [
    "a lighthouse on a cliff at dusk",
    "the long cat and the thing of the cat",
    "Hello, World!  Mixed   CASE and punctuation...",
    "don't can't won't it's",
    "numbers 123 456 7",
    "unicode café naïve 中文",
    "",
    "&amp; html &lt;escapes&gt;",
    "word " * 100,                       # truncated at 77 ids
]


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("vocab")
    syms = list(ref._bytes_to_unicode().values())
    vocab = {s: i for i, s in enumerate(syms + [s + "</w>" for s in syms])}
    merges = [("t", "h"), ("th", "e</w>"), ("c", "a"), ("ca", "t</w>"),
              ("a", "n"), ("an", "d</w>"), ("o", "f</w>"), ("l", "o"),
              ("lo", "n"), ("lon", "g</w>")]
    for a, b in merges:
        vocab[a + b] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (root / "vocab.json").write_text(json.dumps(vocab))
    (root / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    # SD2's tokenizer pads with "!" (id 0), not with the end token
    (root / "tokenizer_config.json").write_text(json.dumps({"pad_token": "!"}))
    return str(root)


def _assert_same(ours, theirs):
    for attr in ("bos_token_id", "eos_token_id", "pad_token_id"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    got, want = ours(TEXTS), theirs(TEXTS)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def test_tiny_tokenizer_matches_jax():
    _assert_same(port.tiny_tokenizer(), ref.tiny_tokenizer())


def test_pretrained_bpe_matches_jax(vocab_dir):
    ours = port.CLIPTokenizer.from_pretrained(vocab_dir)
    theirs = ref.CLIPTokenizer.from_pretrained(vocab_dir)
    assert ours.pad_token_id == 0
    _assert_same(ours, theirs)
