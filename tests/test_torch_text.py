"""The port's prompt front end against the JAX package's, on the CPU: the
CLIP BPE tokenizer (its own copy, on the standard library's `re` where the
original uses `regex`), the long-prompt windows, the emphasis grammar and
`apply_emphasis`, and process(long_prompt=, prompt_emphasis=) at
tiny_pipeline() size, fp32.

Tolerances: token ids, windows and emphasis weights are equal; apply_emphasis
within 1e-6 x max |ref| (fp32 means summed in another order); images within
1 uint8 LSB, as tests/test_torch_pipeline.py holds the default path.
"""

import collections
import json
import sys
import unicodedata

import jax.numpy as jnp
import numpy as np
import pytest
import regex
import torch

from stablediffusioneo_tpu.models import text_encoding as jax_text
from stablediffusioneo_tpu.models import tokenizer as jax_tok
from stablediffusioneo_tpu.pipeline.canny2image import (
    Canny2ImagePipeline as JaxPipeline,
)
from stablediffusioneo_tpu_torch.models import text_encoding as port_text
from stablediffusioneo_tpu_torch.models import tokenizer as port_tok
from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline

from torch_port_util import CFG, PORT_CFG, assert_close_scaled, port_model, tiny_params

CORPUS = [
    "a photograph of an astronaut riding a horse, best quality",
    "Café crème brûlée, naïve façade — Ærøskøbing",
    "東京の夜景、高層ビル 和 漢字 한국어 텍스트",
    "room 101, 3.14159, 2024-05-17 and ١٢٣ ٤٥ (arabic digits) Ⅻ ½",
    "emoji 🐈‍⬛🚀 ✨ 👩🏽‍🚀 and flags 🇯🇵",
    "punctuation!!! ... ??? (((x))) [y] {z} <tag> #hash @at $5 100% a/b\\c",
    "  tabs\tand\nnewlines   and&amp;entities &lt;3 it's you'll we've I'd ",
    "MiXeD CaSe WoRdS with UPPER and lower",
    "",
]


def _learn_merges(words, n):
    """A small BPE learner over byte-unicode words (with </w>): n merges of
    the most frequent adjacent pair, ties broken by the pair itself."""
    enc = jax_tok.bytes_to_unicode()
    vocab = collections.Counter()
    for w in words:
        chars = [enc[b] for b in w.encode("utf-8")]
        vocab[tuple(chars[:-1]) + (chars[-1] + "</w>",)] += 1
    merges = []
    for _ in range(n):
        pairs = collections.Counter()
        for word, c in vocab.items():
            for p in zip(word, word[1:]):
                pairs[p] += c
        if not pairs:
            break
        best = max(pairs, key=lambda p: (pairs[p], p))
        merges.append(best)
        merged = collections.Counter()
        for word, c in vocab.items():
            out, i = [], 0
            while i < len(word):
                if i + 1 < len(word) and (word[i], word[i + 1]) == best:
                    out.append(word[i] + word[i + 1])
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            merged[tuple(out)] += c
        vocab = merged
    return merges


@pytest.fixture(scope="module")
def bpe_files(tmp_path_factory):
    """A merges file in the OpenAI format, and the vocab.json + merges.txt
    pair of the tokenizer it gives, synthesised from the corpus."""
    d = tmp_path_factory.mktemp("bpe")
    words = " ".join(CORPUS * 3).lower().split()
    merges = _learn_merges(words, 300)
    clip_bpe = d / "bpe_simple_vocab_16e6.txt"
    clip_bpe.write_text("#version: 0.2\n" + "\n".join(" ".join(m) for m in merges),
                        encoding="utf-8")
    hf = d / "hf"
    hf.mkdir()
    encoder = jax_tok.CLIPTokenizer.from_clip_bpe(str(clip_bpe)).encoder
    (hf / "vocab.json").write_text(json.dumps(encoder), encoding="utf-8")
    (hf / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(" ".join(m) for m in merges) + "\n",
        encoding="utf-8")
    return clip_bpe, hf


def _pair(kind, files):
    """(JAX tokenizer, port tokenizer) of one kind."""
    if kind == "toy":
        return jax_tok.toy_tokenizer(), port_tok.toy_tokenizer()
    clip_bpe, hf = files
    if kind == "from_clip_bpe":
        return (jax_tok.CLIPTokenizer.from_clip_bpe(str(clip_bpe), 77),
                port_tok.CLIPTokenizer.from_clip_bpe(str(clip_bpe), 77))
    if kind == "from_hf_files":
        args = (str(hf / "vocab.json"), str(hf / "merges.txt"), 77)
        return (jax_tok.CLIPTokenizer.from_hf_files(*args),
                port_tok.CLIPTokenizer.from_hf_files(*args))
    return (jax_tok.CLIPTokenizer.from_pretrained(str(hf)),
            port_tok.CLIPTokenizer.from_pretrained(str(clip_bpe.parent)))


@pytest.mark.parametrize("kind", ["toy", "from_clip_bpe", "from_hf_files", "from_pretrained"])
def test_tokenizer_matches_jax(bpe_files, kind):
    ref, tok = _pair(kind, bpe_files)
    assert tok.encoder == ref.encoder and tok.bpe_ranks == ref.bpe_ranks
    for text in CORPUS:
        ids = tok.encode(text)
        assert ids == ref.encode(text), text
        assert tok.decode(ids) == ref.decode(ids)
    for length in (None, 16):
        np.testing.assert_array_equal(tok(CORPUS, max_length=length),
                                      ref(CORPUS, max_length=length))
    np.testing.assert_array_equal(tok("one text"), ref("one text"))


def test_bpe_merges_apply(bpe_files):
    """The synthesised vocabulary merges: corpus words become fewer ids than
    bytes, so the BPE loop itself is held, not only the byte fallback."""
    _, tok = _pair("from_clip_bpe", bpe_files)
    text = CORPUS[0]
    assert len(tok.encode(text)) < len(text.replace(" ", "").encode())
    assert len(tok.bpe_ranks) > 200


def test_placeholders_match_jax(bpe_files):
    ref, tok = _pair("from_clip_bpe", bpe_files)
    for t in (ref, tok):
        t.add_placeholder("<cat-toy>", [49408, 49409])
        t.add_placeholder("sks", [49410])
    for text in ("a <cat-toy> on a sks table", "tasks with sks", "<CAT-TOY>!"):
        assert tok.encode(text) == ref.encode(text)


def test_missing_tokenizer_files_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="no tokenizer files"):
        port_tok.CLIPTokenizer.from_pretrained(str(tmp_path))


# U+0345 COMBINING GREEK YPOGEGRAMMENI (Mn) folds to the letter U+03B9: in a
# case-insensitive pattern `regex` takes it into no alternative and drops it,
# the stdlib's `re` matches it as a non-letter run.
KNOWN_DIFFERENT = {0x345: "case-folds to a letter; regex drops it, re keeps it"}


def test_character_classes_match_regex():
    """The stdlib pattern against the original's `regex` pattern on every
    code point, each in the context 'a' + c + c + ' ' (a letter joins the
    'a', a number stands alone, anything else pairs with itself), so the
    tokens say which class took c. Where they differ, c is U+0345 or
    unassigned in the standard library's Unicode table (`regex` carries a
    newer one that assigns it)."""
    cps = [cp for cp in range(sys.maxunicode + 1) if not 0xD800 <= cp <= 0xDFFF]
    text = "".join(f"a{chr(cp)}{chr(cp)} " for cp in cps)

    def by_code_point(pattern):
        groups = collections.defaultdict(list)
        for m in pattern.finditer(text):
            groups[m.start() // 4].append(m.group())
        return groups

    port, ref = by_code_point(port_tok._TOKEN_PATTERN), by_code_point(jax_tok._TOKEN_PATTERN)
    differ = [cps[i] for i in set(port) | set(ref) if port.get(i) != ref.get(i)]
    unexplained = [hex(cp) for cp in differ if cp not in KNOWN_DIFFERENT
                   and unicodedata.category(chr(cp)) != "Cn"]
    assert not unexplained, unexplained
    assert len(differ) < 20_000  # code points Unicode assigned after the stdlib's table
    # the whitespace set is regex's \s, not the stdlib's (which adds U+001C-U+001F)
    ws = [chr(cp) for cp in range(0x3001) if regex.fullmatch(r"\s", chr(cp))]
    text = "a\x1c" + "".join(ws) + "b"
    assert port_tok._whitespace_clean(text) == jax_tok._whitespace_clean(text) == "a\x1c b"


# ----------------------------------------------------------- text encoding


@pytest.fixture(scope="module")
def toks():
    """(JAX, port) toy tokenizers of the tiny CLIP's 16-token windows."""
    return (jax_tok.toy_tokenizer(max_length=CFG.clip.max_length),
            port_tok.toy_tokenizer(max_length=CFG.clip.max_length))


@pytest.mark.parametrize("words,windows", [(3, 1), (6, 2), (40, 3)])
def test_tokenize_windowed_matches_jax(toks, words, windows):
    """A prompt of 1, 2 and 3 windows' worth of tokens (14 a window here)."""
    texts = [" ".join(["cat"] * words), "a dog"]
    assert port_text.needed_windows(toks[1], texts) == \
        jax_text.needed_windows(toks[0], texts) == windows
    for n in (1, 2, 3):
        out = port_text.tokenize_windowed(toks[1], texts, windows=n)
        np.testing.assert_array_equal(out, jax_text.tokenize_windowed(toks[0], texts, windows=n))
        assert out.shape == (2, n, CFG.clip.max_length) and out.dtype == np.int32


PROMPTS = [
    "plain text",
    "a (red) [blue] ((very red)) [[very blue]]",
    "a (cat:1.5) and (dog:.5) and (nested (inner:2) outer:0.8)",
    r"escaped \(paren\) and \[bracket\] and \\ slash",
    "malformed (open and close] and (x:1..5) and :colon ) [unclosed (also",
    "(:2)  and (a:-0.5) ((",
    "",
]


@pytest.mark.parametrize("text", PROMPTS)
def test_parse_prompt_attention_matches_jax(text):
    out = port_text.parse_prompt_attention(text)
    ref = jax_text.parse_prompt_attention(text)
    assert [s for s, _ in out] == [s for s, _ in ref]
    np.testing.assert_allclose([w for _, w in out], [w for _, w in ref], rtol=0, atol=0)


def test_tokenize_weighted_matches_jax(toks):
    ids, w = port_text.tokenize_weighted(toks[1], PROMPTS)
    ref_ids, ref_w = jax_text.tokenize_weighted(toks[0], PROMPTS)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_array_equal(w, ref_w)
    assert (w != 1).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_emphasis_matches_jax(rng, dtype):
    """Contexts with a clear row mean (a trained CLIP's final LayerNorm bias
    gives one; with a mean near 0 the ratio of means is noise)."""
    ctx = (rng.standard_normal((2, 16, 32)) + 0.5).astype(np.float32)
    weights = np.ones((2, 16), np.float32)
    weights[0, 2:5], weights[1, 7] = 1.5, 1 / 1.1
    jax_ctx = jnp.asarray(ctx, dtype)
    port_ctx = torch.from_numpy(ctx).to(getattr(torch, dtype))
    ref = np.asarray(jax_text.apply_emphasis(jax_ctx, weights).astype(jnp.float32))
    out = port_text.apply_emphasis(port_ctx, weights)
    assert out.dtype == port_ctx.dtype
    if dtype == "float32":
        assert_close_scaled(out.numpy(), ref, tol=1e-6)
    else:  # both round the same fp32 value once: at most one bf16 step apart
        step = np.abs(ref) * 2.0 ** -7
        assert (np.abs(out.float().numpy() - ref) <= step + 1e-30).all()
    assert port_text.apply_emphasis(port_ctx, np.ones((2, 16))) is port_ctx


# --------------------------------------------------------------- process()


@pytest.fixture(scope="module")
def pipes(toks):
    """Both pipelines on the tiny weights, CLIP's final LayerNorm bias moved
    off 0: its rows then have a mean that emphasis can restore."""
    params = tiny_params()
    ln = params["clip"]["final_ln"]
    params["clip"]["final_ln"] = dict(ln, b=ln["b"] + 0.3)
    return (JaxPipeline(params, toks[0], CFG, persistent_cache=False),
            Canny2ImagePipeline(port_model(params), toks[1], PORT_CFG, device="cpu"))


LONG = ", ".join(f"a bird number {i}" for i in range(12))


@pytest.mark.parametrize("prompt,kwargs", [
    (LONG, {"long_prompt": True}),
    ("a short bird", {"long_prompt": "auto"}),
    (LONG[:30], {"long_prompt": "auto"}),
    ("a (bird:1.4) on a [branch], ((sunny))", {"prompt_emphasis": True}),
], ids=["long", "auto_1", "auto_2", "emphasis"])
def test_process_prompt_front_end_matches_jax(pipes, prompt, kwargs):
    jax_pipe, port_pipe = pipes
    rng = np.random.default_rng(1)
    image = (rng.random((64, 64, 3)) * 255).astype(np.uint8)
    x_T = rng.standard_normal((1, 8, 8, 4), dtype=np.float32)
    kw = dict(a_prompt="best quality", n_prompt="lowres", num_samples=1,
              image_resolution=64, ddim_steps=2, seed=7, eta=0.0, x_T=x_T, **kwargs)
    ref = jax_pipe.process(image, prompt, **kw)
    out = port_pipe.process(image, prompt, **kw)
    assert out[1].shape == ref[1].shape == (64, 64, 3)
    assert np.abs(out[1].astype(int) - ref[1].astype(int)).max() <= 1
    base = port_pipe.process(image, prompt, **dict(kw, long_prompt=False,
                                                  prompt_emphasis=False))
    assert not np.array_equal(base[1], out[1])  # the front end changed the contexts


def test_encode_prompt_windowed_matches_jax(pipes, toks):
    jax_rt, port_rt = pipes[0].runtime, pipes[1].runtime
    texts = [LONG, "lowres"]
    for windows in (3, "auto", 2):
        ref = np.asarray(jax_rt.encode_prompt_windowed(toks[0], texts, windows=windows))
        out = port_rt.encode_prompt_windowed(toks[1], texts, windows=windows)
        assert out.shape == ref.shape
        assert_close_scaled(out.numpy(), ref, tol=1e-5)
    assert ref.shape[1] == 2 * CFG.clip.max_length


def test_emphasis_with_long_prompt_raises(pipes):
    with pytest.raises(ValueError, match="pick one encoder path"):
        pipes[1].process(np.zeros((64, 64, 3), np.uint8), "a", image_resolution=64,
                         ddim_steps=1, long_prompt=True, prompt_emphasis=True)

