"""Pure-Python CLIP BPE tokenizer (host-side).

A copy of `diffusion_tpu/text/tokenizer.py` without its decode helpers, so
that the port's serving path imports nothing of the JAX package. The two
must give the same ids (`tests/test_torch_tokenizer.py`); ROADMAP.md lists
lifting them into one framework-free module.

Loads a HuggingFace tokenizer directory (vocab.json + merges.txt) from a local
path, with no network. `tiny_tokenizer()` builds a self-contained byte-level
vocab for tests and offline development.
"""

from __future__ import annotations

import functools
import html
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import regex as re

__all__ = ["CLIPTokenizer", "tiny_tokenizer"]

_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
    re.IGNORECASE)


@functools.lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode map (GPT-2/CLIP convention)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


def _split_cjk(text: str) -> str:
    """Space-pad CJK ideographs so each becomes its own BPE word —
    transformers.CLIPTokenizer runs BasicTokenizer._tokenize_chinese_chars
    before BPE; we match its ids exactly (tests/test_tokenizer_parity.py)."""
    if not any(_is_cjk(ord(c)) for c in text):
        return text
    out = []
    for c in text:
        if _is_cjk(ord(c)):
            out.append(f" {c} ")
        else:
            out.append(c)
    return "".join(out)


def _get_pairs(word: Tuple[str, ...]) -> set:
    return {(a, b) for a, b in zip(word[:-1], word[1:])}


class CLIPTokenizer:
    """BPE tokenizer with CLIP semantics: lowercase, </w> word-end marker,
    <|startoftext|>/<|endoftext|> specials, pad-with-eot to model_max_length."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]],
                 model_max_length: int = 77, pad_token: Optional[str] = None):
        self.encoder = dict(vocab)
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.model_max_length = model_max_length
        self.bos_token_id = self.encoder["<|startoftext|>"]
        self.eos_token_id = self.encoder["<|endoftext|>"]
        # HF parity: pad_token comes from tokenizer_config.json. OpenAI CLIP
        # has none (pads with EOS); SD2's tokenizer pads with '!' (id 0) —
        # padded ids and CFG negative prompts must match the checkpoint's.
        if pad_token is not None and pad_token in self.encoder:
            self.pad_token_id = self.encoder[pad_token]
        else:
            self.pad_token_id = self.eos_token_id
        self._bpe_cache: Dict[str, str] = {}

    # ---- constructors -------------------------------------------------
    @classmethod
    def from_pretrained(cls, path: str, model_max_length: int = 77) -> "CLIPTokenizer":
        """Load from a local HF tokenizer dir (vocab.json + merges.txt +
        tokenizer_config.json/special_tokens_map.json for pad_token)."""
        if os.path.isdir(os.path.join(path, "tokenizer")):
            path = os.path.join(path, "tokenizer")
        with open(os.path.join(path, "vocab.json")) as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(os.path.join(path, "merges.txt")) as f:
            for line in f.read().split("\n"):
                if not line or line.startswith("#version"):
                    continue
                a, _, b = line.partition(" ")
                if b:
                    merges.append((a, b))
        pad_token = None
        for cfg_name in ("tokenizer_config.json", "special_tokens_map.json"):
            cfg_path = os.path.join(path, cfg_name)
            if pad_token is None and os.path.exists(cfg_path):
                with open(cfg_path) as f:
                    cfg = json.load(f)
                tok = cfg.get("pad_token")
                if isinstance(tok, dict):
                    tok = tok.get("content")
                pad_token = tok
        return cls(vocab, merges, model_max_length, pad_token=pad_token)

    # ---- BPE ----------------------------------------------------------
    def _bpe(self, token: str) -> str:
        if token in self._bpe_cache:
            return self._bpe_cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._bpe_cache[token] = out
        return out

    def tokenize(self, text: str) -> List[int]:
        """Raw BPE ids, no specials/padding."""
        text = _whitespace_clean(html.unescape(html.unescape(text)).strip()).lower()
        text = _split_cjk(text)
        ids: List[int] = []
        for token in re.findall(_PAT, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            for bpe_token in self._bpe(token).split(" "):
                ids.append(self.encoder[bpe_token])
        return ids

    def __call__(self, text: Union[str, Sequence[str]], padding: str = "max_length",
                 truncation: bool = True,
                 max_length: Optional[int] = None) -> Dict[str, np.ndarray]:
        """HF-call parity: returns {'input_ids': (B, 77) int32, 'attention_mask'}."""
        if isinstance(text, str):
            text = [text]
        max_length = max_length or self.model_max_length
        ids_batch, mask_batch = [], []
        for t in text:
            ids = [self.bos_token_id] + self.tokenize(t) + [self.eos_token_id]
            if truncation and len(ids) > max_length:
                ids = ids[:max_length - 1] + [self.eos_token_id]
            mask = [1] * len(ids)
            if padding == "max_length":
                pad = max_length - len(ids)
                ids = ids + [self.pad_token_id] * pad
                mask = mask + [0] * pad
            ids_batch.append(ids)
            mask_batch.append(mask)
        return {"input_ids": np.asarray(ids_batch, np.int32),
                "attention_mask": np.asarray(mask_batch, np.int32)}


def tiny_tokenizer(model_max_length: int = 77) -> CLIPTokenizer:
    """Self-contained byte-level tokenizer (no merges) for tests/offline dev.

    Every byte maps to its own token; vocab = 256 byte symbols + the same with
    </w> + the two specials = 514 ids. Deterministic and network-free.
    """
    byte_syms = list(_bytes_to_unicode().values())
    vocab: Dict[str, int] = {}
    for s in byte_syms:
        vocab[s] = len(vocab)
    for s in byte_syms:
        vocab[s + "</w>"] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    return CLIPTokenizer(vocab, merges=[], model_max_length=model_max_length)
