"""The port's 9-channel inpainting family (pipeline/concat_cond.py,
checkpoint.load_inpaint_pipeline, runtime/engine.py:concat_sample_decode_engine)
against the JAX package's, fp32 on the CPU at tiny widths, on the same seeded
weights (state_dict_from_jax): inpaint_to_concat with a mask whose edges are
not multiples of 8 (which tells jax.image.resize's "nearest", source 8i + 4,
from F.interpolate's "nearest", 8i), sd_concat_sample and sd_concat_img2img
with the JAX draws handed in, the channel-count check, the strict loaders of
the SD-1.5 and SD-2.x layouts, and the engines run eagerly.

Tolerances, relative to max |reference|: inpaint_to_concat 1e-5 (one VAE
encode; the mask channel exactly); 3 loop steps 1e-3, as the other loops'
(tests/test_torch_sd2x.py)."""

import dataclasses
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from stablediffusioneo_tpu import config as jax_config
from stablediffusioneo_tpu.models import init_clip_text, init_unet, init_vae
from stablediffusioneo_tpu.ops.schedule import DiffusionSchedule as JaxSchedule
from stablediffusioneo_tpu.pipeline import concat_cond as jcc
from stablediffusioneo_tpu_torch import checkpoint as port_checkpoint
from stablediffusioneo_tpu_torch import config as port_config
from stablediffusioneo_tpu_torch.checkpoint import accounting
from stablediffusioneo_tpu_torch.checkpoint.convert import state_dict_from_jax
from stablediffusioneo_tpu_torch.models.cldm import LatentDiffusion
from stablediffusioneo_tpu_torch.models.clip import OpenCLIPTextModel
from stablediffusioneo_tpu_torch.ops.layers import nchw, nhwc
from stablediffusioneo_tpu_torch.ops.schedule import DiffusionSchedule
from stablediffusioneo_tpu_torch.pipeline import concat_cond as pcc
from stablediffusioneo_tpu_torch.runtime.engine import (
    concat_sample_decode_engine,
    decode_u8,
    encoder_engine,
)

from torch_port_util import assert_close_scaled, numpy_params

CONCAT_TOL, LOOP_TOL = 1e-5, 1e-3
SCALE = 7.5


def tiny_inpaint(pkg, sd2=False):
    """tiny_pipeline() with the 9-channel UNet (in either package); sd2: the
    SD-2.x variant (16-channel heads, an OpenCLIP penultimate tower)."""
    base = pkg.tiny_pipeline()
    unet = dataclasses.replace(base.unet, in_channels=9,
                               num_head_channels=16 if sd2 else None)
    cfg = dataclasses.replace(base, unet=unet, controlnet=pkg.ControlNetConfig(unet=unet))
    if sd2:
        cfg = dataclasses.replace(cfg, clip=dataclasses.replace(
            base.clip, layer="penultimate", act="gelu"))
    return cfg


JCFG, CFG = tiny_inpaint(jax_config), tiny_inpaint(port_config)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _params(cfg, seed=1):
    return {"unet": numpy_params(init_unet, cfg.unet, seed),
            "vae": numpy_params(init_vae, cfg.vae, seed + 1),
            "clip": numpy_params(init_clip_text, cfg.clip, seed + 2)}


@pytest.fixture(scope="module")
def params():
    return _params(JCFG)


@pytest.fixture(scope="module")
def model(params):
    m = LatentDiffusion(CFG)
    m.load_checkpoint(state_dict_from_jax(params, CFG))
    return m.eval().requires_grad_(False)


def _image_and_mask(seed=0, res=64):
    """An image in [-1, 1] and a rectangular mask whose edges (rows 13-45,
    columns 21-50) fall on no multiple of 8."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(-1, 1, (1, res, res, 3)).astype(np.float32)
    mask = np.zeros((1, res, res), np.float32)
    mask[:, 13:46, 21:51] = 1.0
    return img, mask


def test_configs_equal_the_jax_packages():
    for name in ("sd15_inpaint_pipeline", "sd2_inpaint_pipeline"):
        for dtype in ("bfloat16", "float32"):
            assert dataclasses.asdict(getattr(port_config, name)(dtype)) == \
                dataclasses.asdict(getattr(jax_config, name)(dtype))
    assert port_config.sd15_inpaint_pipeline().unet.in_channels == 9


@pytest.mark.parametrize("sample", [False, True])
def test_inpaint_to_concat_matches_jax(params, model, sample):
    img, mask = _image_and_mask()
    key = jax.random.PRNGKey(3) if sample else None
    want = np.asarray(jcc.inpaint_to_concat(params["vae"], JCFG.vae, jnp.asarray(img),
                                            jnp.asarray(mask), key))
    eps = None
    if sample:  # the JAX DiagonalGaussian.sample draw, handed in
        eps = _t(jax.random.normal(key, (1, 8, 8, 4), jnp.float32))
    with torch.no_grad():
        got = pcc.inpaint_to_concat(model.first_stage_model, _t(img), _t(mask), eps).numpy()
    assert got.shape == want.shape == (1, 8, 8, 5)
    np.testing.assert_array_equal(got[..., :1], want[..., :1])
    assert_close_scaled(got[..., 1:], want[..., 1:], CONCAT_TOL)
    # the mask's edges tell the two nearest rules apart
    plain = nhwc(F.interpolate(nchw(_t(mask)[..., None]), size=(8, 8), mode="nearest"))
    assert not np.array_equal(plain.numpy(), want[..., :1])
    # an encode handed in (an engine) gives the same channels
    enc = encoder_engine(model, 1, 64, 64, deterministic=True)
    if not sample:
        with torch.no_grad():
            via = pcc.inpaint_to_concat(model.first_stage_model, _t(img), _t(mask),
                                        encode=enc).numpy()
        assert_close_scaled(via, want, CONCAT_TOL)


def _loop_inputs(seed=12):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, 8, 8, 4)).astype(np.float32),
            rng.standard_normal((1, 8, 8, 5)).astype(np.float32),
            rng.standard_normal((2, 16, CFG.unet.context_dim)).astype(np.float32))


def test_sd_concat_sample_matches_jax(params, model):
    x_T, cc, ctx = _loop_inputs()
    sched = JaxSchedule().ddim(3)
    ref = jcc.sd_concat_sample_scan(
        params["unet"], JCFG.unet, {k: jnp.asarray(v) for k, v in sched.items()},
        jnp.asarray(x_T), jnp.asarray(cc), jnp.asarray(ctx[:1]), jnp.asarray(ctx[1:]),
        jnp.float32(SCALE), jax.random.PRNGKey(0))
    with torch.no_grad():
        out = pcc.sd_concat_sample(model.unet, DiffusionSchedule().ddim(3), _t(x_T),
                                   _t(cc), _t(ctx[:1]), _t(ctx[1:]), SCALE)
    assert_close_scaled(out.numpy(), ref, LOOP_TOL)
    with torch.no_grad():  # the conditioning channels take part
        other = pcc.sd_concat_sample(model.unet, DiffusionSchedule().ddim(3), _t(x_T),
                                     _t(cc) * 0.0, _t(ctx[:1]), _t(ctx[1:]), SCALE)
    assert np.abs(other.numpy() - out.numpy()).max() > 1e-3


def test_sd_concat_img2img_matches_jax(params, model):
    """The tail loop with the JAX stochastic_tail_entry's noise
    (normal(split(key)[1])) handed in."""
    z0, cc, ctx = _loop_inputs(13)
    sched = JaxSchedule().ddim(5)
    key = jax.random.PRNGKey(4)
    ref = jcc.sd_concat_img2img(
        params["unet"], JCFG.unet, {k: jnp.asarray(v) for k, v in sched.items()},
        jnp.asarray(z0), 3, jnp.asarray(cc), jnp.asarray(ctx[:1]), jnp.asarray(ctx[1:]),
        jnp.float32(SCALE), key)
    renoise = _t(jax.random.normal(jax.random.split(key)[1], z0.shape, jnp.float32))
    with torch.no_grad():
        out = pcc.sd_concat_img2img(model.unet, DiffusionSchedule().ddim(5), _t(z0), 3,
                                    _t(cc), _t(ctx[:1]), _t(ctx[1:]), SCALE,
                                    renoise=renoise)
    assert_close_scaled(out.numpy(), ref, LOOP_TOL)
    with pytest.raises(ValueError, match="t_enc"):
        pcc.sd_concat_img2img(model.unet, DiffusionSchedule().ddim(5), _t(z0), 6, _t(cc),
                              _t(ctx[:1]), _t(ctx[1:]), SCALE, renoise=renoise)


def test_channel_count_validated(model):
    x_T, cc, ctx = _loop_inputs()
    with pytest.raises(ValueError, match=r"c_concat has 4 channels; this UNet "
                                         r"\(in_channels=9\) expects 5"):
        pcc.sd_concat_sample(model.unet, DiffusionSchedule().ddim(2), _t(x_T),
                             _t(cc[..., :4]), _t(ctx[:1]), _t(ctx[1:]), SCALE)


@pytest.mark.parametrize("t_enc", [None, 2])
def test_engine_equals_the_functions(model, t_enc):
    """concat_sample_decode_engine (eager on the CPU) gives the loop's latents
    and their uint8 decode, for txt2img and the img2img tail."""
    x_T, cc, ctx = _loop_inputs(14)
    eng = concat_sample_decode_engine(model, 3, 1, 64, 64, t_enc=t_enc)
    sched = DiffusionSchedule().ddim(3)
    with torch.no_grad():
        if t_enc is None:
            img, z = eng(_t(x_T), _t(cc), _t(ctx[:1]), _t(ctx[1:]), torch.full((1,), SCALE))
            want = pcc.sd_concat_sample(model.unet, sched, _t(x_T), _t(cc), _t(ctx[:1]),
                                        _t(ctx[1:]), SCALE)
        else:
            noise = torch.randn((1, 8, 8, 4), generator=torch.Generator().manual_seed(0))
            img, z = eng(_t(x_T), noise, _t(cc), _t(ctx[:1]), _t(ctx[1:]),
                         torch.full((1,), SCALE))
            want = pcc.sd_concat_img2img(model.unet, sched, _t(x_T), t_enc, _t(cc),
                                         _t(ctx[:1]), _t(ctx[1:]), SCALE, renoise=noise)
        assert torch.equal(z, want)
        assert torch.equal(img, decode_u8(model.first_stage_model, want, torch.float32))
    assert img.shape == (1, 64, 64, 3) and img.dtype == torch.uint8
    assert eng.name == ("concat+decode_3x1x64x64" if t_enc is None
                        else "concat+decode_2x1x64x64_genxT-img2img_of3")


# ------------------------------------------------------------------ loaders

@pytest.mark.parametrize("sd2", [False, True])
def test_load_inpaint_pipeline_strict(sd2, tmp_path):
    """A seeded file in the sd-v1-5-inpainting (HF CLIP) or 512-inpainting-ema
    (OpenCLIP, Linear-stored projections) layout, with its documented
    leftovers: every key consumed or named, the weights as written; a
    foreign key fails."""
    jcfg, cfg = tiny_inpaint(jax_config, sd2), tiny_inpaint(port_config, sd2)
    sd = state_dict_from_jax(_params(jcfg, 5), cfg)
    extra = {"betas": torch.linspace(0, 1, 10), "model_ema.decay": torch.tensor(0.999)}
    if sd2:
        sd = {k: (v[:, :, 0, 0].clone() if re.search(r"\.1\.proj_(in|out)\.weight$", k)
                  and v.dim() == 4 else v) for k, v in sd.items()}
        extra.update({"cond_stage_model.model.attn_mask": torch.zeros(16, 16),
                      "cond_stage_model.model.logit_scale": torch.tensor(4.6)})
    else:
        extra["cond_stage_model.transformer.text_model.embeddings.position_ids"] = \
            torch.arange(16)[None]
    path = tmp_path / "inpaint.ckpt"
    torch.save({**sd, **extra}, path)
    loaded = port_checkpoint.load_inpaint_pipeline(str(path), cfg, device="cpu")
    rep = loaded.load_report
    assert rep.complete and rep.consumed == set(sd) and rep.ignored == set(extra)
    assert isinstance(loaded.clip, OpenCLIPTextModel) == sd2
    assert loaded.unet.input_blocks[0][0].weight.shape[1] == 9
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, sd[k].reshape(v.shape)), k
    torch.save({**sd, **extra, "control_model.zero_convs.0.0.weight": torch.zeros(1)}, path)
    with pytest.raises(accounting.ConversionAccountingError, match="never consumed"):
        port_checkpoint.load_inpaint_pipeline(str(path), cfg, device="cpu")


def test_full_width_inpaint_model_tree():
    """sd-v1-5-inpainting at full width on the meta device: a 9-channel
    conv_in, the SD-1.5 tree otherwise (no control_model)."""
    with torch.device("meta"):
        m = LatentDiffusion(port_config.sd15_inpaint_pipeline())
        sd15 = LatentDiffusion(port_config.sd15_pipeline()).state_dict()
    keys = m.state_dict()
    assert keys["model.diffusion_model.input_blocks.0.0.weight"].shape == (320, 9, 3, 3)
    assert not any(k.startswith("control_model.") for k in keys)
    assert {k: v.shape for k, v in keys.items()
            if k != "model.diffusion_model.input_blocks.0.0.weight"} == \
        {k: v.shape for k, v in sd15.items()
         if k != "model.diffusion_model.input_blocks.0.0.weight"}
