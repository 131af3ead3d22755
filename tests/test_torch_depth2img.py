"""The port's SD-2.0 depth2img family (config.sd2_depth_pipeline,
pipeline/concat_cond.py:depth_to_concat, models/cldm.py:Depth2ImgModel,
checkpoint.load_depth2img_pipeline, the depth channel through
runtime/engine.py:concat_sample_decode_engine) against the JAX package's,
fp32 on the CPU, on the same seeded weights (state_dict_from_jax): a tiny
5-channel UNet, VAE and OpenCLIP tower, and the MiDaS DPT-hybrid tower at the
shapes of the repository's dpt_hybrid universe (a 4x4 position grid,
fusion width 32) at a 64x64 image.

Tolerances, relative to max |reference|: depth_to_concat 1e-5; the tower's
depth channel 1e-4 (the DPT-hybrid's raw depth tolerance of
tests/test_torch_annotators.py); 3 loop steps 1e-3, as the other loops'."""

import dataclasses
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stablediffusioneo_tpu import config as jax_config
from stablediffusioneo_tpu.annotators import midas_hybrid as jhybrid
from stablediffusioneo_tpu.models import init_clip_text, init_unet, init_vae
from stablediffusioneo_tpu.ops.schedule import DiffusionSchedule as JaxSchedule
from stablediffusioneo_tpu.pipeline import concat_cond as jcc
from stablediffusioneo_tpu_torch import checkpoint as port_checkpoint
from stablediffusioneo_tpu_torch import config as port_config
from stablediffusioneo_tpu_torch.annotators import midas as pmidas
from stablediffusioneo_tpu_torch.checkpoint import accounting
from stablediffusioneo_tpu_torch.checkpoint.convert import jax_trees, state_dict_from_jax
from stablediffusioneo_tpu_torch.models.cldm import Depth2ImgModel, depth_conditioned
from stablediffusioneo_tpu_torch.ops.kernels.attention import (
    WS_S_MIN,
    attention_variant,
    views_aligned,
)
from stablediffusioneo_tpu_torch.ops.schedule import DiffusionSchedule
from stablediffusioneo_tpu_torch.pipeline import concat_cond as pcc
from stablediffusioneo_tpu_torch.runtime.engine import concat_sample_decode_engine, decode_u8

from torch_port_util import assert_close_scaled, numpy_params, universe_sd

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402  (the smoke's kernel rows; imports no JAX)

CONCAT_TOL, DEPTH_TOL, LOOP_TOL = 1e-5, 1e-4, 1e-3
SCALE = 9.0
DEPTH_SHAPE = dict(grid=4, features=32, head=8, n_blocks=12)  # the universe's


def tiny_depth(pkg):
    """tiny_pipeline() with the 5-channel UNet (16-channel heads) and an
    OpenCLIP penultimate tower, in either package."""
    base = pkg.tiny_pipeline()
    unet = dataclasses.replace(base.unet, in_channels=5, num_head_channels=16)
    return dataclasses.replace(
        base, unet=unet, controlnet=pkg.ControlNetConfig(unet=unet),
        clip=dataclasses.replace(base.clip, layer="penultimate", act="gelu"))


JCFG, CFG = tiny_depth(jax_config), tiny_depth(port_config)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def params():
    return {"unet": numpy_params(init_unet, JCFG.unet, 1),
            "vae": numpy_params(init_vae, JCFG.vae, 2),
            "clip": numpy_params(init_clip_text, JCFG.clip, 3),
            "depth": jhybrid.convert_dpt_hybrid(universe_sd("dpt_hybrid", 4))}


@pytest.fixture(scope="module")
def state(params):
    return state_dict_from_jax(params, CFG)


@pytest.fixture(scope="module")
def model(state):
    m = Depth2ImgModel(CFG, **DEPTH_SHAPE)
    m.load_checkpoint(state)
    return m.eval().requires_grad_(False)


def _image(seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)


# ------------------------------------------------------------ configuration


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_sd2_depth_pipeline_equals_the_jax_packages(dtype):
    port = port_config.sd2_depth_pipeline(dtype)
    assert dataclasses.asdict(port) == dataclasses.asdict(jax_config.sd2_depth_pipeline(dtype))
    assert dataclasses.asdict(port_config.sd2_depth_pipeline(use_pallas=False)) == \
        dataclasses.asdict(jax_config.sd2_depth_pipeline(use_pallas=False))
    assert (port.unet.in_channels, port.unet.num_head_channels, port.unet.context_dim,
            port.clip.layer) == (5, 64, 1024, "penultimate")
    assert depth_conditioned(port) and not depth_conditioned(port_config.sd21_pipeline())


# ------------------------------------------------------------ depth_to_concat


@pytest.mark.parametrize("side,latent", [(384, 64), (512, 64), (48, 64), (64, 64)])
def test_depth_to_concat_matches_jax(side, latent):
    """384 -> 64 and 512 -> 64 shrink (jax.image.resize antialiases), 48 ->
    64 grows, 64 -> 64 keeps; per sample min / max to [-1, 1]."""
    rng = np.random.default_rng(side)
    d = rng.random((2, side, side), dtype=np.float32) * 1000 + 50
    want = np.asarray(jcc.depth_to_concat(jnp.asarray(d), (latent, latent)))
    got = pcc.depth_to_concat(torch.from_numpy(d), (latent, latent)).numpy()
    assert got.shape == want.shape == (2, latent, latent, 1)
    assert_close_scaled(got, want, CONCAT_TOL)
    assert np.allclose(got.min(axis=(1, 2, 3)), -1) and np.allclose(got.max(axis=(1, 2, 3)), 1)
    d[0] *= 7.0  # one sample's scale leaves the other alone
    again = pcc.depth_to_concat(torch.from_numpy(d[..., None]), (latent, latent)).numpy()
    np.testing.assert_allclose(again[1], got[1], rtol=1e-6)
    if side > latent:  # the plain bicubic (no antialias) is another function
        plain = torch.nn.functional.interpolate(torch.from_numpy(d[:1, None]),
                                                size=(latent, latent), mode="bicubic")
        assert plain.shape == (1, 1, latent, latent)
        assert np.abs(pcc.depth_to_concat(plain[:, 0], (latent, latent)).numpy()
                      - again[:1]).max() > 1e-3


# ------------------------------------------------------------ model and trees


def test_jax_trees_take_the_depth_tower(state):
    trees = jax_trees(CFG, {"unet": 0, "vae": 0, "clip": 0, "depth": 0})
    assert [t[0] for t in trees] == ["unet", "vae", "clip", "depth"]
    assert trees[-1] == ("depth", "dpt_hybrid", "depth_model.model.")
    with torch.device("meta"):
        keys = set(Depth2ImgModel(CFG, **DEPTH_SHAPE).state_dict())
    assert set(state) == keys
    assert sum(k.startswith("depth_model.model.") for k in keys) == 358


def test_full_width_depth_model_tree():
    """512-depth-ema at full width on the meta device: a 5-channel conv_in,
    the OpenCLIP tower and the real tower's shapes (577 positions, fusion
    width 256)."""
    with torch.device("meta"):
        m = Depth2ImgModel(port_config.sd2_depth_pipeline())
    keys = m.state_dict()
    assert keys["model.diffusion_model.input_blocks.0.0.weight"].shape == (320, 5, 3, 3)
    assert keys["depth_model.model.pretrained.model.pos_embed"].shape == (1, 577, 768)
    assert keys["depth_model.model.scratch.layer1_rn.weight"].shape == (256, 256, 3, 3)
    assert "cond_stage_model.model.token_embedding.weight" in keys
    assert not any(k.startswith("control_model.") for k in keys)


# ------------------------------------------------------------ the depth channel


def test_depth_channel_of_an_image_matches_jax(params, model):
    """The tower on a [-1, 1] image, then depth_to_concat, in both packages
    (at a 64x64 tower input the resize keeps the image)."""
    img = _image(1)
    raw = jhybrid.dpt_hybrid_apply(params["depth"], jnp.asarray(img))
    want = np.asarray(jcc.depth_to_concat(raw, (8, 8)))
    with torch.no_grad():
        got = pcc.image_to_depth_concat(model.depth, _t(img), (8, 8), size=64).numpy()
        depth = model.depth(_t(img).permute(0, 3, 1, 2)).numpy()
    assert_close_scaled(depth, np.asarray(raw), DEPTH_TOL)
    assert got.shape == (1, 8, 8, 1)
    assert_close_scaled(got, want, DEPTH_TOL)


def _loop_inputs(seed=12):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, 8, 8, 4)).astype(np.float32),
            rng.standard_normal((2, 16, CFG.unet.context_dim)).astype(np.float32))


@pytest.fixture(scope="module")
def depth_channel(params):
    raw = jhybrid.dpt_hybrid_apply(params["depth"], jnp.asarray(_image(2)))
    return np.asarray(jcc.depth_to_concat(raw, (8, 8)))


def test_depth2img_loop_matches_jax(params, model, depth_channel):
    """3 DDIM steps of the 5-channel UNet against sd_concat_sample_scan."""
    x_T, ctx = _loop_inputs()
    sched = JaxSchedule().ddim(3)
    ref = jcc.sd_concat_sample_scan(
        params["unet"], JCFG.unet, {k: jnp.asarray(v) for k, v in sched.items()},
        jnp.asarray(x_T), jnp.asarray(depth_channel), jnp.asarray(ctx[:1]),
        jnp.asarray(ctx[1:]), jnp.float32(SCALE), jax.random.PRNGKey(0))
    with torch.no_grad():
        out = pcc.sd_concat_sample(model.unet, DiffusionSchedule().ddim(3), _t(x_T),
                                   _t(depth_channel), _t(ctx[:1]), _t(ctx[1:]), SCALE)
        flat = pcc.sd_concat_sample(model.unet, DiffusionSchedule().ddim(3), _t(x_T),
                                    _t(depth_channel) * 0.0, _t(ctx[:1]), _t(ctx[1:]),
                                    SCALE)
    assert_close_scaled(out.numpy(), ref, LOOP_TOL)
    assert np.abs(flat.numpy() - out.numpy()).max() > 1e-3  # the depth takes part
    with pytest.raises(ValueError, match=r"c_concat has 5 channels; this UNet "
                                         r"\(in_channels=5\) expects 1"):
        pcc.sd_concat_sample(model.unet, DiffusionSchedule().ddim(2), _t(x_T),
                             torch.zeros((1, 8, 8, 5)), _t(ctx[:1]), _t(ctx[1:]), SCALE)


def test_engine_equals_the_functions(model, depth_channel):
    """concat_sample_decode_engine (eager on the CPU) takes the 1-channel
    depth concat as it takes the inpainting's 5: the loop's latents and
    their uint8 decode, no other capture path."""
    x_T, ctx = _loop_inputs(14)
    eng = concat_sample_decode_engine(model, 3, 1, 64, 64)
    with torch.no_grad():
        img, z = eng(_t(x_T), _t(depth_channel), _t(ctx[:1]), _t(ctx[1:]),
                     torch.full((1,), SCALE))
        want = pcc.sd_concat_sample(model.unet, DiffusionSchedule().ddim(3), _t(x_T),
                                    _t(depth_channel), _t(ctx[:1]), _t(ctx[1:]), SCALE)
    assert torch.equal(z, want)
    assert torch.equal(img, decode_u8(model.first_stage_model, want, torch.float32))
    assert img.shape == (1, 64, 64, 3) and eng.name == "concat+decode_3x1x64x64"


# ------------------------------------------------------------------ loaders


def _write(path, state, **extra):
    leftovers = {"betas": torch.linspace(0, 1, 10),
                 "cond_stage_model.model.attn_mask": torch.zeros(16, 16),
                 "cond_stage_model.model.logit_scale": torch.tensor(4.6)}
    torch.save({"state_dict": {**state, **leftovers, **extra}}, path)
    return leftovers


def test_load_depth2img_pipeline_strict(state, tmp_path):
    """A tiny file in the 512-depth-ema layout with its documented
    leftovers: every key consumed or named, the tower's widths read off
    the file, the weights as written."""
    path = tmp_path / "512-depth-ema.ckpt"
    leftovers = _write(path, state)
    loaded = port_checkpoint.load_depth2img_pipeline(str(path), CFG, device="cpu")
    rep = loaded.load_report
    assert rep.complete and rep.consumed == set(state) and rep.ignored == set(leftovers)
    assert loaded.unet.input_blocks[0][0].weight.shape[1] == 5
    assert loaded.depth.pretrained.model.pos_embed.shape == (1, 17, 768)
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, state[k]), k


@pytest.mark.parametrize("fault", ["foreign", "missing"])
def test_load_depth2img_pipeline_refuses(state, tmp_path, fault):
    path = tmp_path / "512-depth-ema.ckpt"
    if fault == "foreign":
        _write(path, state, **{"lora_unet.alpha": torch.zeros(1)})
        match = "never consumed"
    else:
        _write(path, {k: v for k, v in state.items()
                      if k != "depth_model.model.scratch.refinenet2.out_conv.bias"})
        match = "missing"
    with pytest.raises(accounting.ConversionAccountingError, match=match):
        port_checkpoint.load_depth2img_pipeline(str(path), CFG, device="cpu")


def test_depth_tower_loads_into_the_detector(state, model):
    """convert_depth_tower: the file's tower as MidasDetector("dpt_hybrid")
    weights, the same function as the model's tower."""
    tower = port_checkpoint.convert_depth_tower(state)
    assert len(tower) == 358
    det = pmidas.MidasDetector(params=tower, model_type="dpt_hybrid", device="cpu")
    x = _t(_image(3)).permute(0, 3, 1, 2)
    with torch.no_grad():
        assert torch.equal(det.net(x), model.depth(x))


# ------------------------------------------------- the smoke's kernel rows

NEW_ROWS = chip_smoke.family_attention_rows(port_config.sd15_pipeline())


def test_smoke_takes_the_new_paths_rows():
    """depth2img's four packed sites (heads of 64 channels: 5 at 4096 tokens,
    10 at 1024), the MiDaS ViTs' split sites at a 512x512 input and
    UniFormer's stage 3 at a 512x512 detection (5 heads at 1,024 tokens)."""
    rows = {(r[0], r[1], r[2], r[3]): paths for r, paths in NEW_ROWS.items()}
    assert rows == {
        ("fused_attention_packed", (2, 4096, 320), 4096, 5): ["depth2img 512"],
        ("fused_attention_packed", (2, 4096, 320), 77, 5): ["depth2img 512"],
        ("fused_attention_packed", (2, 1024, 640), 1024, 10): ["depth2img 512"],
        ("fused_attention_packed", (2, 1024, 640), 77, 10): ["depth2img 512"],
        ("fused_attention", (1, 16, 1025, 64), 1025, 16): ["annotators:midas"],
        ("fused_attention", (1, 12, 1025, 64), 1025, 12): ["midas dpt_hybrid 512"],
        ("fused_attention", (1, 5, 1024, 64), 1024, 5): ["annotators:uniformer"]}
    assert not set(NEW_ROWS) & set(chip_smoke.attention_rows(port_config.sd15_pipeline()))


@pytest.mark.parametrize("row", list(NEW_ROWS), ids=[f"{r[0]}-{r[1]}x{r[2]}" for r in NEW_ROWS])
def test_new_rows_take_the_tensor_core_variant(row):
    """Head dim 64 in bf16 on aligned views: the warp-specialised variant at
    WS_S_MIN keys or more (the 1,024- and 4,096-token self-attention, the
    ViTs' 1,025 tokens), the wgmma one at S = 77; fp32 the CUDA cores (the
    ViT rows' q / k / v are views of one projection, token stride 3C:
    aligned)."""
    entry, q_shape, s, heads = row
    tq, d = (q_shape[2], q_shape[3]) if entry == "fused_attention" else \
        (q_shape[1], q_shape[2] // heads)
    assert d == 64
    want = "wgmma_ws" if s >= WS_S_MIN else "wgmma"
    assert attention_variant(torch.bfloat16, d, tq, s, True) == want
    assert attention_variant(torch.float32, d, tq, s, True) == "cuda_core"


def test_vit_views_are_aligned():
    """The (B, H, T, d) views of a (B, T, 3, H, d) bf16 projection meet the
    tensor-core variant's alignment (the kernel phase and the nets build
    them so)."""
    for heads in (16, 12):
        qkv = torch.zeros((1, 1025, 3, heads, 64), dtype=torch.bfloat16)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        out = torch.empty((1, heads, 1025, 64), dtype=torch.bfloat16)
        strides = [(t.stride(0), t.stride(1), t.stride(2)) for t in (q, k, v, out)]
        assert strides[0] == (1025 * 3 * heads * 64, 64, 3 * heads * 64)
        assert views_aligned(q, k, v, out, strides)
