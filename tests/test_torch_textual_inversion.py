"""Textual inversion in the port (checkpoint/textual_inversion.py) against
the JAX package's, fp32 on the CPU at tiny size: the grown embedding table
and the encoded context equal the JAX package's for an HF CLIP and an
OpenCLIP tower, a concept made of a word's own rows encodes as the word, the
width check, the three file layouts, and a live runtime whose CLIP engines
alone are evicted."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from stablediffusioneo_tpu.checkpoint import textual_inversion as jti
from stablediffusioneo_tpu.config import sd21_pipeline as jax_sd21
from stablediffusioneo_tpu.models import init_clip_text
from stablediffusioneo_tpu.models.clip import clip_text_apply as jax_clip_apply
from stablediffusioneo_tpu.models.tokenizer import toy_tokenizer as jax_toy_tokenizer
from stablediffusioneo_tpu_torch import config as port_config
from stablediffusioneo_tpu_torch.checkpoint import accounting
from stablediffusioneo_tpu_torch.checkpoint import textual_inversion as pti
from stablediffusioneo_tpu_torch.checkpoint.convert import clip_state_dict, openclip_state_dict
from stablediffusioneo_tpu_torch.models.clip import (
    CLIPTextModel,
    OpenCLIPTextModel,
    clip_text_apply,
)
from stablediffusioneo_tpu_torch.models.tokenizer import toy_tokenizer
from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline

from torch_port_util import CFG, PORT_CFG, numpy_params, port_model, tiny_params

CTX_TOL = 1e-5  # max |port - JAX| of the encoded context, fp32, x max |JAX|


def _towers():
    """{layout: (JAX cfg, JAX params, port tower)} of seeded weights."""
    oc_jax = dataclasses.replace(jax_sd21().clip, vocab_size=1000, hidden_size=32,
                                 intermediate_size=64, num_layers=2, num_heads=2,
                                 max_length=16)
    oc_port = dataclasses.replace(port_config.sd21_pipeline().clip, vocab_size=1000,
                                  hidden_size=32, intermediate_size=64, num_layers=2,
                                  num_heads=2, max_length=16)
    out = {}
    for name, jcfg, pcfg, put, cls in (
            ("clip", CFG.clip, PORT_CFG.clip, clip_state_dict, CLIPTextModel),
            ("openclip", oc_jax, oc_port, openclip_state_dict, OpenCLIPTextModel)):
        p = numpy_params(init_clip_text, jcfg, 3)
        sd = {}
        put(sd, p, prefix="")
        tower = cls(pcfg)
        accounting.account_checkpoint(tower, sd).assert_complete(name)
        accounting.copy_checkpoint_(tower, sd)
        out[name] = (jcfg, p, tower.eval().requires_grad_(False))
    return out


@pytest.fixture(scope="module")
def towers():
    return _towers()


def _concepts(d, seed=0):
    rng = np.random.default_rng(seed)
    return {"<thing>": (rng.standard_normal((2, d)) * 0.02).astype(np.float32),
            "<one>": (rng.standard_normal((1, d)) * 0.02).astype(np.float32)}


@pytest.mark.parametrize("name", ["clip", "openclip"])
def test_add_concepts_matches_jax(towers, name):
    jcfg, params, tower = towers[name]
    vocab = jcfg.vocab_size
    jtok = jax_toy_tokenizer(vocab_size=vocab, max_length=jcfg.max_length)
    ptok = toy_tokenizer(vocab_size=vocab, max_length=jcfg.max_length)
    concepts = _concepts(jcfg.hidden_size)
    new = jti.add_concepts(params, jtok, concepts)
    assert pti.add_concepts(tower, ptok, concepts) is tower
    table = pti.token_embedding(tower).weight
    assert table.shape == (vocab + 3, jcfg.hidden_size)
    np.testing.assert_array_equal(table.numpy(), np.asarray(new["token_embedding"]))
    assert ptok.added_tokens == jtok.added_tokens
    texts = ["a photo of <thing> here", "<one> and <thing>", "no concept"]
    ids = ptok(texts)
    np.testing.assert_array_equal(ids, np.asarray(jtok(texts)))
    assert (ids >= vocab).sum() == 5
    want = np.asarray(jax_clip_apply(new, jcfg, jnp.asarray(ids)))
    with torch.no_grad():
        got = clip_text_apply(tower, torch.from_numpy(np.asarray(ids)).long()).numpy()
    assert np.abs(got - want).max() <= CTX_TOL * np.abs(want).max()


def test_concept_of_word_rows_encodes_as_the_word():
    """A concept whose vectors are the rows of a two-token word encodes to
    the same context, to the bit, as that word."""
    _, _, tower = _towers()["clip"]
    tok = toy_tokenizer(vocab_size=PORT_CFG.clip.vocab_size,
                        max_length=PORT_CFG.clip.max_length)
    word = next(w for w in ("ab", "on", "forest")
                if len(tok.encode(w)) == 2)
    rows = pti.token_embedding(tower).weight[tok.encode(word)].numpy().copy()
    pti.add_concepts(tower, tok, {"<clone>": rows})
    ids = torch.from_numpy(np.asarray(tok([f"a {word} at dusk", "a <clone> at dusk"])))
    with torch.no_grad():
        out = clip_text_apply(tower, ids.long())
    assert not torch.equal(ids[0], ids[1])
    assert torch.equal(out[0], out[1])


def test_width_mismatch_raises(towers):
    _, _, tower = _towers()["clip"]
    tok = toy_tokenizer(vocab_size=PORT_CFG.clip.vocab_size,
                        max_length=PORT_CFG.clip.max_length)
    with pytest.raises(ValueError, match="hidden size"):
        pti.add_concepts(tower, tok, {"<bad>": np.zeros((1, 9999), np.float32)})


def test_file_layouts(tmp_path):
    """The .npz layout and both .pt layouts (A1111 string_to_param,
    diffusers token -> tensor) give what the JAX loader gives; a file with
    no embedding raises in both."""
    d = CFG.clip.hidden_size
    vec = np.random.default_rng(0).standard_normal((2, d)).astype(np.float32)
    paths = {"c.npz": None, "a1111.pt": {"string_to_param": {"*": torch.from_numpy(vec)},
                                         "name": "<sd-concept>", "step": 3000},
             "diff.bin": {"<diff-concept>": torch.from_numpy(vec[0])}}
    for fname, obj in paths.items():
        p = str(tmp_path / fname)
        if obj is None:
            np.savez(p, **{"<npz-concept>": vec})
        else:
            torch.save(obj, p)
        got, want = pti.load_concept(p), jti.load_concept(p)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == np.float32 and got[k].ndim == 2
            np.testing.assert_array_equal(got[k], want[k])
    assert pti.load_concept(str(tmp_path / "diff.bin"))["<diff-concept>"].shape == (1, d)
    p_bad = str(tmp_path / "bad.pt")
    torch.save({"not_an_embedding": 3}, p_bad)
    for load in (pti.load_concept, jti.load_concept):
        with pytest.raises(ValueError, match="no embedding"):
            load(p_bad)


def test_live_runtime_evicts_only_clip_engines():
    """apply_textual_inversion on a live CPU runtime: the CLIP engines go and
    every other engine stays; the placeholder prompt changes the image; the
    count is the new rows."""
    tok = toy_tokenizer(vocab_size=PORT_CFG.clip.vocab_size,
                        max_length=PORT_CFG.clip.max_length)
    pipe = Canny2ImagePipeline(port_model(tiny_params()), tok, PORT_CFG, device="cpu")
    rng = np.random.default_rng(1)
    img = (rng.random((64, 64, 3)) * 255).astype(np.uint8)
    kw = dict(num_samples=1, image_resolution=64, ddim_steps=2, seed=1)
    pipe.process(img, "a bird", **kw)
    rt = pipe.runtime
    before = set(rt._engines)
    assert any(k[0] == "clip" for k in before) and any(k[0] != "clip" for k in before)
    d = PORT_CFG.clip.hidden_size
    n = pti.apply_textual_inversion(rt, tok, {"<thing>": rng.standard_normal((2, d)) * 0.02})
    assert n == 2
    assert set(rt._engines) == {k for k in before if k[0] != "clip"}
    out_a = pipe.process(img, "a photo of <thing>", **kw)[1]
    out_b = pipe.process(img, "a photo of", **kw)[1]
    assert np.any(out_a != out_b), "concept had no effect on the prompt"
    assert {k for k in rt._engines if k[0] != "clip"} == {k for k in before if k[0] != "clip"}
