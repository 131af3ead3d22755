"""The port's T5 v1.1 encoder (stablediffusioneo_tpu_torch/models/t5.py)
against the JAX package's (models/t5.py), fp32 on the CPU at tiny_t5()'s
widths, on the same seeded weights (checkpoint/convert.py:
t5_state_dict_from_jax): t5_encode with and without a padding mask and
clip_t5_encode within 1e-5 x max |ref| (measured ~3e-7), the relative
position buckets exactly, in bf16 within 2 bf16 ulps of max |ref|; and the
port against HF's T5EncoderModel (the JAX test's executor and bound, 2e-4)
where transformers is installed."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stablediffusioneo_tpu.models import t5 as jax_t5
from stablediffusioneo_tpu.models.clip import clip_text_apply as jax_clip_apply
from stablediffusioneo_tpu_torch.checkpoint import accounting
from stablediffusioneo_tpu.models import init_clip_text
from stablediffusioneo_tpu_torch.checkpoint.convert import clip_state_dict, t5_state_dict_from_jax
from stablediffusioneo_tpu_torch.models import t5
from stablediffusioneo_tpu_torch.models.clip import CLIPTextModel

from torch_port_util import CFG, PORT_CFG, assert_close_scaled

TOL = 1e-5
JCFG, PCFG = jax_t5.tiny_t5(), t5.tiny_t5()


@pytest.fixture(scope="module")
def params():
    return jax_t5.init_t5(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def model(params):
    return t5.convert_t5(t5_state_dict_from_jax(params), PCFG, device="cpu")


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, JCFG.vocab_size, (2, JCFG.max_length)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[0, 10:] = 0
    ids[0, 10:] = 0  # pad token
    return ids, mask


@pytest.mark.parametrize("name", ["T5Config", "tiny_t5"])
def test_configs_equal_the_jax_packages(name):
    port, ref = getattr(t5, name)(), getattr(jax_t5, name)()
    assert [(f.name, f.type) for f in dataclasses.fields(port)] == \
        [(f.name, f.type) for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


@pytest.mark.parametrize("masked", [False, True], ids=["no mask", "padding mask"])
def test_t5_encode_matches_jax(params, model, masked):
    ids, mask = _inputs()
    ref = jax_t5.t5_encode(params, JCFG, jnp.asarray(ids),
                           mask=jnp.asarray(mask) if masked else None)
    with torch.no_grad():
        out = t5.t5_encode(model, torch.from_numpy(ids.astype(np.int64)),
                           mask=torch.from_numpy(mask) if masked else None)
    assert out.dtype == torch.float32
    assert_close_scaled(out.numpy(), np.asarray(ref), TOL)


def test_t5_encode_bf16_matches_jax(params, model):
    """Compute dtype bf16 on fp32 weights, as the JAX dtype= argument: the
    norms normalise in fp32, logits and softmax in fp32, the rest in bf16."""
    ids, mask = _inputs(1)
    ref = np.asarray(jax_t5.t5_encode(params, JCFG, jnp.asarray(ids), mask=jnp.asarray(mask),
                                      dtype=jnp.bfloat16).astype(jnp.float32))
    with torch.no_grad():
        out = t5.t5_encode(model, torch.from_numpy(ids.astype(np.int64)),
                           mask=torch.from_numpy(mask), dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert_close_scaled(out.float().numpy(), ref, 2 * 2.0 ** -8)


@pytest.mark.parametrize("q,k,buckets,dist", [(77, 77, 32, 128), (16, 16, 32, 128),
                                               (5, 300, 32, 128), (200, 9, 16, 64)])
def test_rel_pos_buckets_are_exact(q, k, buckets, dist):
    got = t5._rel_pos_buckets(q, k, buckets, dist)
    want = jax_t5._rel_pos_buckets(q, k, buckets, dist)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_clip_t5_encode_matches_jax(params, model):
    jp = {"clip": init_clip_text(jax.random.PRNGKey(3), CFG.clip)}
    clip = CLIPTextModel(PORT_CFG.clip)
    sd = {}
    clip_state_dict(sd, jp["clip"], prefix="")
    accounting.load_strict(clip, sd, "clip")
    rng = np.random.default_rng(2)
    clip_ids = rng.integers(0, CFG.clip.vocab_size, (2, CFG.clip.max_length)).astype(np.int32)
    ids, mask = _inputs(3)
    ref = jax_t5.clip_t5_encode(jp["clip"], CFG.clip, params, JCFG, jnp.asarray(clip_ids),
                                jnp.asarray(ids), t5_mask=jnp.asarray(mask))
    with torch.no_grad():
        out = t5.clip_t5_encode(clip.eval(), model, torch.from_numpy(clip_ids.astype(np.int64)),
                                torch.from_numpy(ids.astype(np.int64)),
                                t5_mask=torch.from_numpy(mask))
    assert len(out) == 2
    for o, r in zip(out, ref):
        assert_close_scaled(o.numpy(), np.asarray(r), TOL)
    assert_close_scaled(out[0].numpy(), np.asarray(jax_clip_apply(jp["clip"], CFG.clip,
                                                                   jnp.asarray(clip_ids))), TOL)


def test_module_names_are_hf_t5_encoder_model(params, model):
    """The port's parameters are exactly the carried HF names: one
    relative-bias table (block 0's), no bias on any linear."""
    names = set(model.state_dict())
    assert names == set(t5_state_dict_from_jax(params))
    assert [n for n in names if "relative_attention_bias" in n] == \
        ["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"]
    assert not [n for n in names if n.endswith(".bias")]


def test_convert_t5_takes_prefix_and_the_embedding_alias(params, model):
    sd = t5_state_dict_from_jax(params)
    ids, _ = _inputs(4)
    want = t5.t5_encode(model, torch.from_numpy(ids.astype(np.int64)))
    # HF's tied copy under encoder.embed_tokens beside shared, under a prefix
    both = {"cond_stage_model.transformer." + k: v for k, v in sd.items()}
    both["cond_stage_model.transformer.encoder.embed_tokens.weight"] = sd["shared.weight"]
    # only encoder.embed_tokens (no shared)
    alias = {("encoder.embed_tokens.weight" if k == "shared.weight" else k): v
             for k, v in sd.items()}
    for sd_, prefix in ((both, "cond_stage_model.transformer."), (alias, "")):
        m = t5.convert_t5(sd_, PCFG, prefix=prefix, device="cpu")
        with torch.no_grad():
            assert torch.equal(t5.t5_encode(m, torch.from_numpy(ids.astype(np.int64))), want)
    bad = dict(sd)
    bad["encoder.block.0.layer.0.SelfAttention.mystery.weight"] = torch.zeros(2)
    with pytest.raises(accounting.ConversionAccountingError, match="mystery"):
        t5.convert_t5(bad, PCFG, device="cpu")
    half = t5.convert_t5(sd, PCFG, dtype=torch.bfloat16, device="cpu")
    assert half.shared.weight.dtype == torch.bfloat16


def test_init_t5_follows_the_jax_init_distributions():
    cfg = dataclasses.replace(PCFG, d_model=64, d_ff=128, vocab_size=512)
    m = t5.init_t5(torch.Generator().manual_seed(0), cfg, device="cpu")
    blk = m.encoder.block[0].layer
    a, ff = blk[0].SelfAttention, blk[1].DenseReluDense
    inner = cfg.num_heads * cfg.d_kv
    for w, std in ((m.shared.weight, 1.0), (m.rel_bias, 0.05),
                   (a.q.weight, (cfg.d_model * cfg.d_kv) ** -0.5), (a.k.weight, cfg.d_model ** -0.5),
                   (a.o.weight, inner ** -0.5), (ff.wo.weight, cfg.d_ff ** -0.5)):
        assert abs(w.std().item() / std - 1) < 0.15, (w.shape, w.std().item(), std)
    assert torch.equal(blk[0].layer_norm.weight, torch.ones(cfg.d_model))
    again = t5.init_t5(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(m.state_dict().values(),
                                                 again.state_dict().values()))


@pytest.mark.parametrize("name", ["init_t5", "init_unet", "init_controlnet", "init_vae",
                                  "init_clip_text"])
def test_seeded_constructors_default_to_the_card(name, monkeypatch):
    """models.init_* put the network on the card unless the caller names
    another device (here the move is recorded and redirected to the CPU),
    and draw on the generator's device: a CPU generator gives the same
    weights on either device."""
    from stablediffusioneo_tpu_torch.annotators._dtype import default_device
    from stablediffusioneo_tpu_torch.models import cldm

    module = t5 if name == "init_t5" else cldm
    cfg = {"init_t5": dataclasses.replace(PCFG, vocab_size=512), "init_unet": PORT_CFG.unet,
           "init_controlnet": PORT_CFG.controlnet, "init_vae": PORT_CFG.vae,
           "init_clip_text": PORT_CFG.clip}[name]
    seen = []

    def spy(device=None):
        seen.append(default_device(device))
        return torch.device("cpu")

    monkeypatch.setattr(module, "default_device", spy)
    make = getattr(module, name)
    default = make(torch.Generator().manual_seed(0), cfg)
    assert seen == [torch.device("cuda")]
    monkeypatch.undo()
    named = make(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert {p.device.type for p in named.parameters()} == {"cpu"}
    assert default.state_dict().keys() == named.state_dict().keys()
    assert all(torch.equal(v, named.state_dict()[k]) for k, v in default.state_dict().items())


def test_matches_hf_t5_encoder_model():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.T5Config(
        vocab_size=PCFG.vocab_size, d_model=PCFG.d_model, d_kv=PCFG.d_kv, d_ff=PCFG.d_ff,
        num_layers=PCFG.num_layers, num_heads=PCFG.num_heads,
        relative_attention_num_buckets=PCFG.relative_attention_num_buckets,
        relative_attention_max_distance=PCFG.relative_attention_max_distance,
        feed_forward_proj="gated-gelu", dropout_rate=0.0, is_encoder_decoder=False,
        use_cache=False, tie_word_embeddings=False)
    torch.manual_seed(0)
    hf = transformers.T5EncoderModel(hf_cfg).eval()
    m = t5.convert_t5(hf.state_dict(), PCFG, device="cpu")
    ids, mask = _inputs(5)
    with torch.no_grad():
        ref = hf(input_ids=torch.from_numpy(ids.astype(np.int64)),
                 attention_mask=torch.from_numpy(mask.astype(np.int64))).last_hidden_state
        out = t5.t5_encode(m, torch.from_numpy(ids.astype(np.int64)),
                           mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-4, atol=2e-4)
