"""CLIP BPE tokenizer (pure Python, loads the standard vocab.json +
merges.txt of openai/clip-vit-large-patch14).

A copy of edgestyle_tpu/data/tokenizer.py (framework-free host code; the
port imports nothing of the JAX package). The reference tokenizes through
HF CLIPTokenizer (model/utils.py:698-710 TextEmbeddings; train...py:948-956
empty prompt). This is a dependency-free implementation of the same
byte-level BPE with CLIP's lowercasing + whitespace cleanup, 77-token
padding, and <|startoftext|>/<|endoftext|> specials.
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import os
import re
from typing import Dict, List

import numpy as np


@functools.lru_cache()
def _bytes_to_unicode():
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return {(a, b) for a, b in zip(word, word[1:])}


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


# CLIP's canonical ids in the openai/clip-vit-large-patch14 vocab.
CLIP_BOS_ID = 49406
CLIP_EOS_ID = 49407


def empty_prompt_ids(batch: int = 1, max_length: int = 77,
                     bos: int = CLIP_BOS_ID, eos: int = CLIP_EOS_ID) -> np.ndarray:
    """The empty-prompt encoding HF CLIPTokenizer('') produces: BOS, EOS,
    then EOS padding. Use this when no tokenizer files are available —
    all-zero ids would decode to '!' repeated (token 0), which is NOT an
    empty prompt."""
    out = np.full((batch, max_length), eos, np.int32)
    out[:, 0] = bos
    return out


# CLIP's word-split pattern uses true Unicode letter/number classes
# (\p{L}/\p{N}); stdlib `re` can't express those, so use the third-party
# `regex` module (the same one HF/OpenAI use) with an ASCII fallback that
# is exact for ASCII text.
try:
    import regex as _regex

    _WORD_PATTERN = _regex.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
        _regex.IGNORECASE,
    )
except ImportError:  # pragma: no cover - regex is baked into this image
    _WORD_PATTERN = re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
        re.IGNORECASE,
    )


class CLIPTokenizer:
    """Byte-level BPE with CLIP's `</w>` word-end convention."""

    PATTERN = _WORD_PATTERN

    def __init__(self, vocab: Dict[str, int], merges: List[str], max_length: int = 77):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        ranks = {}
        for i, line in enumerate(merges):
            parts = tuple(line.split())
            if len(parts) == 2:
                ranks[parts] = len(ranks)
        self.bpe_ranks = ranks
        self.cache = {}
        self.max_length = max_length
        self.bos = self.encoder["<|startoftext|>"]
        self.eos = self.encoder["<|endoftext|>"]

    @classmethod
    def from_files(cls, vocab_path: str, merges_path: str, max_length: int = 77):
        with open(vocab_path) as f:
            vocab = json.load(f)
        opener = gzip.open if merges_path.endswith(".gz") else open
        with opener(merges_path, "rt") as f:
            merges = f.read().split("\n")
        if merges and merges[0].startswith("#"):
            merges = merges[1:]
        return cls(vocab, [m for m in merges if m], max_length)

    @classmethod
    def from_pretrained_dir(cls, path: str, max_length: int = 77):
        return cls.from_files(
            os.path.join(path, "vocab.json"), os.path.join(path, "merges.txt"), max_length
        )

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
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
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        text = _whitespace_clean(html.unescape(html.unescape(text))).lower()
        ids: List[int] = []
        for tok in self.PATTERN.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok).split(" "))
        return ids

    def __call__(self, texts, padding: str = "max_length") -> np.ndarray:
        """list[str] → (B, 77) int32 with BOS/EOS + EOS-padding (CLIP pads
        with the EOS token, matching HF CLIPTokenizer(pad_token=eos))."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), self.max_length), self.eos, np.int32)
        for i, t in enumerate(texts):
            ids = [self.bos] + self.encode(t)[: self.max_length - 2] + [self.eos]
            out[i, : len(ids)] = ids
        return out

    def decode(self, ids) -> str:
        toks = [self.decoder.get(int(i), "") for i in ids]
        text = "".join(t for t in toks if not t.startswith("<|"))
        data = bytearray(self.byte_decoder.get(c, 32) for c in text)
        return data.decode("utf-8", errors="replace").replace("</w>", " ").strip()


def make_tiny_tokenizer() -> CLIPTokenizer:
    """Self-contained toy tokenizer for tests (character-level vocab)."""
    chars = [chr(c) for c in range(ord("a"), ord("z") + 1)] + [str(d) for d in range(10)]
    byte_vocab = list(_bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(sorted(set(byte_vocab)))}
    n = len(vocab)
    for c in chars:
        vocab.setdefault(c + "</w>", len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    return CLIPTokenizer(vocab, [], max_length=16)
