r"""CLIP BPE tokenizer — self-contained (no HF hub download). The PyTorch
port's own copy of stablediffusioneo_tpu/models/tokenizer.py, on the
standard library's `re`: the letter and number classes that the original's
`regex` spells \p{L} and \p{N} are built from `unicodedata` when the module
is imported, and whitespace is Unicode's White_Space set (what `regex`'s \s
matches; the stdlib's \s also takes U+001C-U+001F). tests/test_torch_text.py
holds the two to the same tokens on every code point and names where they
disagree, and why.

The reference relies on HF `CLIPTokenizer.from_pretrained("openai/clip-vit-
large-patch14")` downloads (ldm/modules/encoders/modules.py:97-100). This
framework ships the full byte-level BPE machinery and loads the vocabulary
from local files in either format:
  - OpenAI CLIP `bpe_simple_vocab_16e6.txt.gz` (merges list), or
  - HF `vocab.json` + `merges.txt`.

Padding/special-token behavior matches CLIPTokenizer under
`padding="max_length", truncation=True, max_length=77` as FrozenCLIPEmbedder
calls it (modules.py:117-121): [SOT] + tokens[:75] + [EOT], padded with EOT.
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import os
import re
import sys
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _category_class(initials: str, major: str) -> str:
    """The body of a character class holding every code point whose general
    category starts with `major` ("L": letters, "N": numbers), as ranges."""
    return "".join(f"{re.escape(chr(m.start()))}-{re.escape(chr(m.end() - 1))}"
                   for m in re.finditer(f"{major}+", initials))


_INITIALS = "".join(c[0] for c in map(unicodedata.category,
                                      map(chr, range(sys.maxunicode + 1))))
LETTERS = _category_class(_INITIALS, "L")
NUMBERS = _category_class(_INITIALS, "N")
del _INITIALS
# Unicode's White_Space property
WHITESPACE = "\t\n\x0b\x0c\r\x20\x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f\u205f\u3000"

_TOKEN_PATTERN = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    rf"|[{LETTERS}]+|[{NUMBERS}]|[^{WHITESPACE}{LETTERS}{NUMBERS}]+",
    re.IGNORECASE,
)


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2-style reversible byte <-> printable-unicode mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: Tuple[str, ...]):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _whitespace_clean(text: str) -> str:
    text = re.sub(f"[{WHITESPACE}]+", " ", text)
    return text.strip()


def _basic_clean(text: str) -> str:
    # ftfy.fix_text unavailable offline; html unescape covers the common case
    text = html.unescape(html.unescape(text))
    return text.strip()


class CLIPTokenizer:
    """Byte-level BPE with </w> end-of-word markers (CLIP flavor)."""

    def __init__(
        self,
        encoder: Dict[str, int],
        bpe_merges: List[Tuple[str, str]],
        max_length: int = 77,
    ):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.encoder = encoder
        self.decoder = {v: k for k, v in encoder.items()}
        self.bpe_ranks = dict(zip(bpe_merges, range(len(bpe_merges))))
        self.max_length = max_length
        self.sot = encoder["<|startoftext|>"]
        self.eot = encoder["<|endoftext|>"]
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        # textual-inversion placeholders: literal word -> id run (a k-vector
        # concept occupies k consecutive ids past the base vocab)
        self.added_tokens: Dict[str, List[int]] = {}

    def add_placeholder(self, word: str, ids: List[int]) -> None:
        """Register a placeholder word that tokenizes to a fixed id run
        (checkpoint/textual_inversion.py). Matched case-insensitively as a
        WHOLE word before BPE: no adjacent alphanumerics ('sks' must not
        fire inside 'tasks'), longest placeholder wins ('<ab>' beats
        '<a>')."""
        self.added_tokens[word.lower()] = list(ids)
        alts = "|".join(re.escape(w) for w in
                        sorted(self.added_tokens, key=len, reverse=True))
        self._added_re = re.compile(
            rf"((?<![a-z0-9])(?:{alts})(?![a-z0-9]))")

    # ------------------------------------------------------------ BPE core

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
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
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        text = _whitespace_clean(_basic_clean(text)).lower()
        if self.added_tokens:
            out: List[int] = []
            for part in self._added_re.split(text):
                if part in self.added_tokens:
                    out.extend(self.added_tokens[part])
                elif part:
                    out.extend(self._encode_bpe(part))
            return out
        return self._encode_bpe(text)

    def _encode_bpe(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        for token in re.findall(_TOKEN_PATTERN, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(
                self.encoder[t] for t in self.bpe(token).split(" ")
            )
        return bpe_tokens

    def decode(self, tokens: Sequence[int]) -> str:
        text = "".join(
            self.decoder[t]
            for t in tokens
            if t not in (self.sot, self.eot)
        )
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    # ----------------------------------------------------- padded batching

    def __call__(self, texts, max_length: Optional[int] = None) -> np.ndarray:
        """Tokenize to (B, max_length) int32 with SOT/EOT and EOT padding."""
        if isinstance(texts, str):
            texts = [texts]
        L = max_length or self.max_length
        out = np.full((len(texts), L), self.eot, np.int32)
        for i, text in enumerate(texts):
            ids = self.encode(text)[: L - 2]
            row = [self.sot] + ids + [self.eot]
            out[i, : len(row)] = row
        return out

    # ------------------------------------------------------------- loaders

    @classmethod
    def from_clip_bpe(cls, merges_path: str, max_length: int = 77) -> "CLIPTokenizer":
        """OpenAI `bpe_simple_vocab_16e6.txt.gz` format."""
        opener = gzip.open if merges_path.endswith(".gz") else open
        with opener(merges_path, "rt", encoding="utf-8") as f:
            merge_lines = f.read().split("\n")
        merge_lines = merge_lines[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merge_lines]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        encoder = dict(zip(vocab, range(len(vocab))))
        return cls(encoder, merges, max_length)

    @classmethod
    def from_hf_files(
        cls, vocab_json: str, merges_txt: str, max_length: int = 77
    ) -> "CLIPTokenizer":
        with open(vocab_json, encoding="utf-8") as f:
            encoder = json.load(f)
        with open(merges_txt, encoding="utf-8") as f:
            lines = f.read().split("\n")
        if lines and lines[0].startswith("#"):
            lines = lines[1:]
        merges = [tuple(l.split()) for l in lines if l and len(l.split()) == 2]
        return cls(encoder, merges, max_length)

    @classmethod
    def from_pretrained(cls, path: str, max_length: int = 77) -> "CLIPTokenizer":
        """Auto-detect format inside a directory or from a single file path."""
        if os.path.isdir(path):
            vj = os.path.join(path, "vocab.json")
            mt = os.path.join(path, "merges.txt")
            if os.path.exists(vj) and os.path.exists(mt):
                return cls.from_hf_files(vj, mt, max_length)
            for name in os.listdir(path):
                if "bpe" in name and (name.endswith(".gz") or name.endswith(".txt")):
                    return cls.from_clip_bpe(os.path.join(path, name), max_length)
            raise FileNotFoundError(f"no tokenizer files in {path}")
        return cls.from_clip_bpe(path, max_length)


def toy_tokenizer(vocab_size: int = 1000, max_length: int = 16) -> CLIPTokenizer:
    """Deterministic miniature tokenizer for tests: byte vocab + few merges."""
    vocab = list(bytes_to_unicode().values())
    vocab = vocab + [v + "</w>" for v in vocab]
    merges = [("t", "h"), ("th", "e</w>"), ("a", "n"), ("an", "d</w>"), ("i", "n")]
    for m in merges:
        vocab.append("".join(m))
    vocab.extend(["<|startoftext|>", "<|endoftext|>"])
    vocab = vocab[:vocab_size]
    # ensure specials exist even after truncation
    encoder = dict(zip(vocab, range(len(vocab))))
    encoder.setdefault("<|startoftext|>", vocab_size - 2)
    encoder.setdefault("<|endoftext|>", vocab_size - 1)
    merges = [m for m in merges if "".join(m) in encoder]
    return CLIPTokenizer(encoder, merges, max_length)
