"""The port's diffusers-layout maps (stablediffusioneo_tpu_torch/checkpoint/
diffusers.py) against the JAX package's (checkpoint/diffusers.py): the
sgm <-> diffusers key maps equal for the tiny UNet, VAE and SDXL UNet; sgm ->
diffusers -> sgm exact; a port network loaded from the diffusers layout
equal to the one loaded from the sgm layout (exact) and, in fp32 on the
CPU, to the JAX network of the JAX convert_*_diffusers tree within 1e-5 x
max |ref|; SDXL text_encoder_2's pooled output against the JAX clip_g tree
(1e-5) and HF's CLIPTextModelWithProjection (2e-4, the JAX test's bound);
orphan keys raise naming themselves. Measured with one torch thread: the
UNet and the VAE decode at most ~1e-6 x max |ref|."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stablediffusioneo_tpu.checkpoint import diffusers as jax_diff
from stablediffusioneo_tpu.models import sdxl as jax_sdxl
from stablediffusioneo_tpu.models.clip import clip_text_pooled as jax_pooled
from stablediffusioneo_tpu.models.unet import unet_apply as jax_unet_apply
from stablediffusioneo_tpu.models.vae import vae_decode as jax_vae_decode
from stablediffusioneo_tpu_torch.checkpoint import accounting, convert_unet, convert_vae
from stablediffusioneo_tpu_torch.checkpoint import diffusers as diff
from stablediffusioneo_tpu_torch.config import CLIPTextConfig
from stablediffusioneo_tpu_torch.models import sdxl, unet_apply, vae_decode
from stablediffusioneo_tpu_torch.models.cldm import init_unet, init_vae
from stablediffusioneo_tpu_torch.models.clip import OpenCLIPTextModel, clip_text_pooled

from torch_port_util import CFG, PORT_CFG, assert_close_scaled

TOL = 1e-5


def _seeded(net):
    """Every tensor of `net`'s state dict replaced by a seeded draw (no
    zero-initialised leaf), fp32."""
    rng = np.random.default_rng(3)
    return {k: torch.from_numpy((0.1 * rng.standard_normal(tuple(v.shape))).astype(np.float32))
            for k, v in net.state_dict().items()}


@pytest.fixture(scope="module")
def unet_sd():
    return _seeded(init_unet(torch.Generator().manual_seed(0), PORT_CFG.unet, device="cpu"))


@pytest.fixture(scope="module")
def vae_sd():
    return _seeded(init_vae(torch.Generator().manual_seed(1), PORT_CFG.vae, device="cpu"))


@pytest.fixture(scope="module")
def sdxl_unet_sd():
    return _seeded(init_unet(torch.Generator().manual_seed(2), sdxl.tiny_sdxl().unet,
                             device="cpu"))


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


CASES = {"unet": ("unet", lambda: PORT_CFG.unet, lambda: CFG.unet),
         "vae": ("vae", lambda: PORT_CFG.vae, lambda: CFG.vae),
         "sdxl unet": ("unet", lambda: sdxl.tiny_sdxl().unet, lambda: jax_sdxl.tiny_sdxl().unet)}


def _sd(request, case):
    return request.getfixturevalue({"unet": "unet_sd", "vae": "vae_sd",
                                    "sdxl unet": "sdxl_unet_sd"}[case])


@pytest.mark.parametrize("case", list(CASES))
def test_key_maps_equal_the_jax_packages(request, case):
    component, pcfg, jcfg = CASES[case]
    sd = _sd(request, case)
    pairs = diff._unet_pairs if component == "unet" else diff._vae_pairs
    jpairs = jax_diff._unet_pairs if component == "unet" else jax_diff._vae_pairs
    assert pairs(pcfg()) == jpairs(jcfg())
    km = diff._expand(sd, pairs(pcfg()), reverse=True)
    assert km == jax_diff._expand(sd, jpairs(jcfg()), reverse=True)
    assert set(km) == set(sd)
    renamed = diff.rename_sgm_to_diffusers(sd, pcfg(), component)
    ref = jax_diff.rename_sgm_to_diffusers(_np(sd), jcfg(), component)
    assert renamed.keys() == ref.keys()
    for k, v in renamed.items():
        assert tuple(v.shape) == ref[k].shape and np.array_equal(v.numpy(), ref[k]), k
    forward = diff._expand(renamed, pairs(pcfg()))
    assert forward == jax_diff._expand(ref, jpairs(jcfg())) == km


@pytest.mark.parametrize("case", list(CASES))
def test_sgm_diffusers_sgm_round_trip_is_exact(request, case):
    component, pcfg, _ = CASES[case]
    sd = _sd(request, case)
    renamed = diff.rename_sgm_to_diffusers(sd, pcfg(), component)
    assert len(renamed) == len(sd)
    convert = diff.convert_unet_diffusers if component == "unet" else diff.convert_vae_diffusers
    back = convert(renamed, pcfg())
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    half = convert(renamed, pcfg(), dtype=torch.bfloat16)
    assert all(half[k].dtype == torch.bfloat16 for k in half)


def test_layout_landmarks(unet_sd, vae_sd, sdxl_unet_sd):
    u = diff.rename_sgm_to_diffusers(unet_sd, PORT_CFG.unet, "unet")
    assert any(k.startswith("down_blocks.0.resnets.0.norm1") for k in u)
    assert "time_embedding.linear_1.weight" in u and "conv_norm_out.weight" in u
    v = diff.rename_sgm_to_diffusers(vae_sd, PORT_CFG.vae, "vae")
    assert v["encoder.mid_block.attentions.0.to_q.weight"].dim() == 2
    n = len(PORT_CFG.vae.ch_mult)
    assert f"decoder.up_blocks.{n - 1}.resnets.0.conv1.weight" in v
    x = diff.rename_sgm_to_diffusers(sdxl_unet_sd, sdxl.tiny_sdxl().unet, "unet")
    assert "add_embedding.linear_1.weight" in x and "add_embedding.linear_2.weight" in x


def test_unet_from_diffusers_equals_sgm_and_the_jax_tree(unet_sd):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, CFG.clip.max_length, CFG.unet.context_dim)).astype(np.float32)
    t = np.array([501.0], np.float32)
    renamed = diff.rename_sgm_to_diffusers(unet_sd, PORT_CFG.unet, "unet")
    from_diff = convert_unet(diff.convert_unet_diffusers(renamed, PORT_CFG.unet),
                             PORT_CFG.unet, prefix="", device="cpu")
    from_sgm = convert_unet(unet_sd, PORT_CFG.unet, prefix="", device="cpu")
    with torch.no_grad():
        a = unet_apply(from_diff, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
        b = unet_apply(from_sgm, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    assert torch.equal(a, b)
    tree = jax_diff.convert_unet_diffusers(_np(renamed), CFG.unet)
    ref = jax_unet_apply(tree, CFG.unet, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    assert_close_scaled(a.numpy(), np.asarray(ref), TOL)


def test_vae_from_diffusers_equals_sgm_and_the_jax_tree(vae_sd):
    z = np.random.default_rng(5).standard_normal((1, 8, 8, 4)).astype(np.float32)
    renamed = diff.rename_sgm_to_diffusers(vae_sd, PORT_CFG.vae, "vae")
    from_diff = convert_vae(diff.convert_vae_diffusers(renamed, PORT_CFG.vae), PORT_CFG.vae,
                            prefix="", device="cpu")
    from_sgm = convert_vae(vae_sd, PORT_CFG.vae, prefix="", device="cpu")
    with torch.no_grad():
        a = vae_decode(from_diff, torch.from_numpy(z), scaled=False)
        b = vae_decode(from_sgm, torch.from_numpy(z), scaled=False)
    assert torch.equal(a, b)
    tree = jax_diff.convert_vae_diffusers(_np(renamed), CFG.vae)
    ref = jax_vae_decode(tree, CFG.vae, jnp.asarray(z), scaled=False)
    assert_close_scaled(a.numpy(), np.asarray(ref), TOL)


def test_sdxl_unet_from_diffusers_equals_the_jax_tree(sdxl_unet_sd):
    pcfg, jcfg = sdxl.tiny_sdxl().unet, jax_sdxl.tiny_sdxl().unet
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 16, jcfg.context_dim)).astype(np.float32)
    y = rng.standard_normal((1, jcfg.adm_in_channels)).astype(np.float32)
    t = np.array([301.0], np.float32)
    renamed = diff.rename_sgm_to_diffusers(sdxl_unet_sd, pcfg, "unet")
    net = convert_unet(diff.convert_unet_diffusers(renamed, pcfg), pcfg, prefix="",
                       device="cpu")
    with torch.no_grad():
        out = unet_apply(net, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                         y=torch.from_numpy(y))
    tree = jax_diff.convert_unet_diffusers(_np(renamed), jcfg)
    ref = jax_unet_apply(tree, jcfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                         y=jnp.asarray(y))
    assert_close_scaled(out.numpy(), np.asarray(ref), TOL)


@pytest.mark.parametrize("component", ["unet", "vae"])
def test_orphan_key_raises_naming_itself(unet_sd, vae_sd, component):
    sd, cfg = (unet_sd, PORT_CFG.unet) if component == "unet" else (vae_sd, PORT_CFG.vae)
    bad = dict(diff.rename_sgm_to_diffusers(sd, cfg, component))
    bad["down_blocks.0.mystery.weight"] = torch.zeros(3)
    convert = diff.convert_unet_diffusers if component == "unet" else diff.convert_vae_diffusers
    with pytest.raises(accounting.ConversionAccountingError, match="mystery"):
        convert(bad, cfg)


def _hf_clip_g_sd(cfg, seed=7):
    """An HF CLIPTextModelWithProjection state dict of `cfg`, drawn by name
    with numpy (position_ids included, as older HF files carry it)."""
    rng = np.random.default_rng(seed)
    d, inner = cfg.hidden_size, cfg.intermediate_size

    def draw(*shape):
        return (rng.standard_normal(shape) * (0.02 if len(shape) == 2 and shape[0] > 64
                                              else 0.2)).astype(np.float32)

    sd = {"text_model.embeddings.token_embedding.weight": draw(cfg.vocab_size, d),
          "text_model.embeddings.position_embedding.weight": draw(cfg.max_length, d),
          "text_model.embeddings.position_ids": np.arange(cfg.max_length)[None],
          "text_model.final_layer_norm.weight": 1 + draw(d),
          "text_model.final_layer_norm.bias": draw(d),
          "text_projection.weight": draw(cfg.projection_dim, d)}
    for i in range(cfg.num_layers):
        b = f"text_model.encoder.layers.{i}"
        for ln in ("layer_norm1", "layer_norm2"):
            sd[f"{b}.{ln}.weight"], sd[f"{b}.{ln}.bias"] = 1 + draw(d), draw(d)
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{b}.self_attn.{p}.weight"], sd[f"{b}.self_attn.{p}.bias"] = draw(d, d), draw(d)
        sd[f"{b}.mlp.fc1.weight"], sd[f"{b}.mlp.fc1.bias"] = draw(inner, d), draw(inner)
        sd[f"{b}.mlp.fc2.weight"], sd[f"{b}.mlp.fc2.bias"] = draw(d, inner), draw(d)
    return sd


def _clip_g(sd, cfg):
    net = OpenCLIPTextModel(cfg)
    accounting.load_strict(net, diff.convert_clip_g_diffusers(
        {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, cfg), "clip_g")
    return net.eval()


def test_clip_g_pooled_matches_the_jax_tree():
    cfg, jcfg = sdxl.tiny_sdxl().clip_g, jax_sdxl.tiny_sdxl().clip_g
    sd = _hf_clip_g_sd(cfg)
    net = _clip_g(sd, cfg)
    assert tuple(net.text_projection.shape) == (cfg.hidden_size, cfg.projection_dim)
    ids = np.random.default_rng(8).integers(5, cfg.vocab_size - 5,
                                            (2, cfg.max_length)).astype(np.int64)
    ids[:, 5] = cfg.vocab_size - 1
    with torch.no_grad():
        got = clip_text_pooled(net, torch.from_numpy(ids), eot_id=cfg.vocab_size - 1)
    tree = jax_diff.convert_clip_g_diffusers({k: v for k, v in sd.items()
                                              if not k.endswith("position_ids")}, jcfg)
    want = jax_pooled(tree, jcfg, jnp.asarray(ids.astype(np.int32)), eot_id=cfg.vocab_size - 1)
    assert_close_scaled(got.numpy(), np.asarray(want), TOL)


def test_clip_g_pooled_matches_hf():
    """The JAX test's check (tests/test_diffusers_layout.py), on the port:
    the projected pooled output of the converted tower against HF's
    text_embeds, quick_gelu as the JAX test's configuration."""
    transformers = pytest.importorskip("transformers")
    cfg = CLIPTextConfig(vocab_size=1000, hidden_size=32, intermediate_size=64, num_layers=2,
                         num_heads=2, max_length=16, act="quick_gelu", projection_dim=16)
    torch.manual_seed(3)
    hf = transformers.CLIPTextModelWithProjection(transformers.CLIPTextConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads, max_position_embeddings=cfg.max_length,
        hidden_act="quick_gelu", projection_dim=cfg.projection_dim,
        eos_token_id=cfg.vocab_size - 1)).eval()
    net = _clip_g({k: v.numpy() for k, v in hf.state_dict().items()}, cfg)
    ids = np.random.default_rng(9).integers(5, cfg.vocab_size - 5,
                                            (2, cfg.max_length)).astype(np.int64)
    ids[:, 5] = cfg.vocab_size - 1
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids)).text_embeds
        got = clip_text_pooled(net, torch.from_numpy(ids), eot_id=cfg.vocab_size - 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)


def test_clip_g_orphan_raises_naming_itself():
    cfg = sdxl.tiny_sdxl().clip_g
    sd = {k: torch.from_numpy(np.array(v)) for k, v in _hf_clip_g_sd(cfg).items()}
    sd["text_model.encoder.layers.0.self_attn.mystery.weight"] = torch.zeros(2)
    with pytest.raises(accounting.ConversionAccountingError, match="mystery"):
        diff.convert_clip_g_diffusers(sd, cfg)
    # a layer past the configuration's is an orphan too, its q / k / v named
    sd = {k: torch.from_numpy(np.array(v)) for k, v in _hf_clip_g_sd(cfg).items()}
    short = CLIPTextConfig(**{**cfg.__dict__, "num_layers": cfg.num_layers - 1})
    with pytest.raises(accounting.ConversionAccountingError, match="q_proj"):
        diff.convert_clip_g_diffusers(sd, short)


def test_clip_diffusers_is_the_hf_layout():
    """text_encoder (HF CLIPTextModel) loads as it is into the port's
    CLIPTextModel, its position_ids named by HF_CLIP_IGNORES."""
    from stablediffusioneo_tpu_torch.checkpoint import convert_clip
    from stablediffusioneo_tpu_torch.models.cldm import init_clip_text

    net = init_clip_text(torch.Generator().manual_seed(4), PORT_CFG.clip, device="cpu")
    sd = dict(net.state_dict())
    sd["text_model.embeddings.position_ids"] = torch.arange(PORT_CFG.clip.max_length)[None]
    out = diff.convert_clip_diffusers(sd, PORT_CFG.clip)
    assert out.keys() == sd.keys()
    loaded = convert_clip(out, PORT_CFG.clip, prefix="", device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(loaded.state_dict().values(),
                                                 net.state_dict().values()))
    assert loaded.load_report.ignored == {"text_model.embeddings.position_ids"}
