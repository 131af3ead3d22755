"""The port's SDXL refiner (models/sdxl.py: configs, SDXLRefiner,
refiner_add_time_ids, sdxl_refiner_conditioning, sdxl_refine_latents;
checkpoint.load_sdxl_refiner_pipeline; runtime/engine.py:
sdxl_refine_decode_engine) against the JAX package's, fp32 on the CPU at
tiny_sdxl_refiner() widths, on the same seeded weights (state_dict_from_jax,
bigG at conditioner.embedders.0.model.).

Tolerances, relative to max |reference|: the time ids 1e-6; the
conditioning 1e-4, as the towers' (tests/test_torch_sd2x.py); the 3-step
refine 1e-3, as the other loops'."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stablediffusioneo_tpu.models import init_clip_text, init_unet, init_vae
from stablediffusioneo_tpu.models import sdxl as jsdxl
from stablediffusioneo_tpu.ops.schedule import DiffusionSchedule as JaxSchedule
from stablediffusioneo_tpu_torch import checkpoint as port_checkpoint
from stablediffusioneo_tpu_torch.checkpoint import accounting
from stablediffusioneo_tpu_torch.checkpoint.convert import state_dict_from_jax
from stablediffusioneo_tpu_torch.models import sdxl as psdxl
from stablediffusioneo_tpu_torch.models.unet import encoder_plan
from stablediffusioneo_tpu_torch.ops.schedule import DiffusionSchedule
from stablediffusioneo_tpu_torch.pipeline.ddim import schedule_tail, stochastic_tail_entry
from stablediffusioneo_tpu_torch.runtime.engine import decode_u8, sdxl_refine_decode_engine

from torch_port_util import assert_close_scaled, numpy_params

IDS_TOL, COND_TOL, LOOP_TOL = 1e-6, 1e-4, 1e-3
JCFG, CFG = jsdxl.tiny_sdxl_refiner(), psdxl.tiny_sdxl_refiner()


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def params():
    return {"unet": numpy_params(init_unet, JCFG.unet, 1),
            "clip_g": numpy_params(init_clip_text, JCFG.clip_g, 2),
            "vae": numpy_params(init_vae, JCFG.vae, 3)}


@pytest.fixture(scope="module")
def sd(params):
    return state_dict_from_jax(params, CFG)


@pytest.fixture(scope="module")
def model(sd):
    m = psdxl.SDXLRefiner(CFG)
    m.load_checkpoint(sd)
    return m.eval().requires_grad_(False)


def test_configs_equal_the_jax_packages():
    for name in ("sdxl_refiner_unet", "SDXLRefinerConfig", "tiny_sdxl_refiner"):
        assert dataclasses.asdict(getattr(psdxl, name)()) == \
            dataclasses.asdict(getattr(jsdxl, name)())


def test_real_config_topology():
    """The refiner's ladder (0, 4, 4, 4): level 3 (ds 8) holds no attention,
    the middle block a depth-4 transformer; the full-width model tree on the
    meta device has no transformer in those blocks and bigG alone at
    conditioner.embedders.0.model."""
    u = psdxl.sdxl_refiner_unet()
    assert (u.adm_in_channels, u.context_dim) == (2560, 1280)
    ds8 = [d for d in encoder_plan(u) if d["ds"] == 8]
    assert ds8 and not any(d["attn"] for d in ds8)
    assert u.depth_for(len(u.channel_mult) - 1) == 4
    with torch.device("meta"):
        m = psdxl.SDXLRefiner(psdxl.SDXLRefinerConfig())
    for d, blk in zip(encoder_plan(u), m.unet.input_blocks):
        st = blk.transformer()
        assert (st is not None) == d["attn"]
        assert st is None or len(st.transformer_blocks) == 4
    assert len(m.unet.middle_block.transformer().transformer_blocks) == 4
    keys = m.state_dict()
    assert keys["conditioner.embedders.0.model.text_projection"].shape == (1280, 1280)
    assert not any(k.startswith("conditioner.embedders.1") for k in keys)
    assert keys["model.diffusion_model.label_emb.0.0.weight"].shape == (1536, 2560)


def test_state_dict_from_jax_takes_the_refiner(sd):
    with torch.device("meta"):
        want = set(psdxl.SDXLRefiner(CFG).state_dict())
    assert set(sd) == want


@pytest.mark.parametrize("score,crop", [(6.0, (0, 0)), (2.5, (16, 8))])
def test_add_time_ids_match_jax(score, crop):
    want = jsdxl.refiner_add_time_ids((64, 48), crop, score, batch=3, fourier_dim=8)
    got = psdxl.refiner_add_time_ids((64, 48), crop, score, 3, fourier_dim=8,
                                     device="cpu").numpy()
    assert got.shape == want.shape == (3, 40)
    assert_close_scaled(got, want, IDS_TOL)


def test_conditioning_matches_jax(params, model):
    """(ctx, y) of one branch against the JAX sdxl_refiner_conditioning; the
    aesthetic score moves y's fourier tail and nothing else."""
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 999, (2, CFG.clip_g.max_length)).astype(np.int64)
    ids[:, -4:] = 0
    out = {}
    for score in (6.0, 2.5):
        ctx_ref, y_ref = jsdxl.sdxl_refiner_conditioning(
            params, JCFG, jnp.asarray(ids, jnp.int32), (64, 64), aesthetic_score=score)
        with torch.no_grad():
            ctx, y = psdxl.sdxl_refiner_conditioning(model, torch.from_numpy(ids), (64, 64),
                                                     aesthetic_score=score)
        assert ctx.shape == (2, CFG.clip_g.max_length, CFG.clip_g.hidden_size)
        assert y.shape == (2, CFG.unet.adm_in_channels) and y.dtype == torch.float32
        assert_close_scaled(ctx.numpy(), np.asarray(ctx_ref), COND_TOL)
        assert_close_scaled(y.numpy(), np.asarray(y_ref), COND_TOL)
        out[score] = (ctx, y)
    (c1, y1), (c2, y2) = out[6.0], out[2.5]
    proj = CFG.clip_g.projection_dim
    assert torch.equal(c1, c2) and torch.equal(y1[:, :proj], y2[:, :proj])
    assert (y1 - y2).abs().max() > 1e-3


def test_refine_matches_jax(params, model):
    """sdxl_refine_latents against the JAX one, 3 of 6 steps, with the JAX
    entry noise (normal(split(key)[1])) handed in."""
    rng = np.random.default_rng(1)
    z0 = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 16, CFG.unet.context_dim)).astype(np.float32)
    y = rng.standard_normal((2, CFG.unet.adm_in_channels)).astype(np.float32)
    sched = JaxSchedule().ddim(6)
    key = jax.random.PRNGKey(3)
    ref = jsdxl.sdxl_refine_latents(
        params["unet"], JCFG, {k: jnp.asarray(v) for k, v in sched.items()},
        jnp.asarray(z0), 3, jnp.asarray(ctx[:1]), jnp.asarray(ctx[1:]), jnp.asarray(y[:1]),
        jnp.asarray(y[1:]), jnp.float32(5.0), key)
    renoise = _t(jax.random.normal(jax.random.split(key)[1], z0.shape, jnp.float32))
    with torch.no_grad():
        out = psdxl.sdxl_refine_latents(model.unet, DiffusionSchedule().ddim(6), _t(z0), 3,
                                        _t(ctx[:1]), _t(ctx[1:]), _t(y[:1]), _t(y[1:]), 5.0,
                                        renoise=renoise)
    assert_close_scaled(out.numpy(), np.asarray(ref), LOOP_TOL)


def test_t_enc_validation_matches_jax(params, model):
    sched = JaxSchedule().ddim(4)
    z0 = np.zeros((1, 8, 8, 4), np.float32)
    ctx = np.zeros((1, 16, CFG.unet.context_dim), np.float32)
    y = np.zeros((1, CFG.unet.adm_in_channels), np.float32)
    for t_enc in (5, 0):
        with pytest.raises(ValueError) as ref:
            jsdxl.sdxl_refine_latents(params["unet"], JCFG, sched, jnp.asarray(z0), t_enc,
                                      ctx, ctx, y, y, jnp.float32(5.0),
                                      jax.random.PRNGKey(0))
        with pytest.raises(ValueError) as got:
            psdxl.sdxl_refine_latents(model.unet, DiffusionSchedule().ddim(4), _t(z0), t_enc,
                                      _t(ctx), _t(ctx), _t(y), _t(y), 5.0,
                                      renoise=torch.zeros(1, 8, 8, 4))
        assert str(got.value) == str(ref.value)
    with pytest.raises(ValueError, match="t_enc"):
        sdxl_refine_decode_engine(model, 4, 5, 1, 64, 64)


def test_refine_decode_engine_equals_the_functions(model):
    """The engine (eager on the CPU) on the entry latent made outside it
    gives sdxl_refine_latents' latents and their uint8 decode."""
    rng = np.random.default_rng(2)
    z0 = _t(rng.standard_normal((1, 8, 8, 4)))
    ctx = _t(rng.standard_normal((2, 16, CFG.unet.context_dim)))
    y = _t(rng.standard_normal((2, CFG.unet.adm_in_channels)))
    noise = torch.randn((1, 8, 8, 4), generator=torch.Generator().manual_seed(0))
    sched = DiffusionSchedule().ddim(5)
    eng = sdxl_refine_decode_engine(model, 5, 2, 1, 64, 64)
    assert eng.name == "sdxl_refine+decode_2x1x64x64_of5"
    _, x = stochastic_tail_entry(sched, 2, z0, noise)
    with torch.no_grad():
        img, z = eng(x, ctx[:1], ctx[1:], y[:1], y[1:], torch.full((1,), 5.0))
        want = psdxl.sdxl_refine_latents(model.unet, sched, z0, 2, ctx[:1], ctx[1:], y[:1],
                                         y[1:], 5.0, renoise=noise)
        assert torch.equal(z, want)
        assert torch.equal(img, decode_u8(model.vae, want, torch.float32))
    assert len(schedule_tail(sched, 2)["timesteps"]) == 2


def test_load_sdxl_refiner_pipeline_strict(sd, model, tmp_path):
    """A seeded sgm-layout refiner file with OpenCLIP's leftovers: every key
    consumed or named, the weights as written; a foreign key fails."""
    extra = {"conditioner.embedders.0.model.attn_mask": torch.zeros(16, 16),
             "conditioner.embedders.0.model.logit_scale": torch.tensor(4.6),
             "betas": torch.linspace(0, 1, 10)}
    path = tmp_path / "refiner.pth"
    torch.save({**sd, **extra}, path)
    loaded = port_checkpoint.load_sdxl_refiner_pipeline(str(path), CFG, device="cpu")
    rep = loaded.load_report
    assert isinstance(loaded, psdxl.SDXLRefiner)
    assert rep.complete and rep.consumed == set(sd) and rep.ignored == set(extra)
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    torch.save({**sd, **extra, "conditioner.embedders.3.model.w": torch.zeros(2)}, path)
    with pytest.raises(accounting.ConversionAccountingError, match="never consumed"):
        port_checkpoint.load_sdxl_refiner_pipeline(str(path), CFG, device="cpu")
    # a base-model layout (bigG at embedders.1) is not a refiner file
    moved = {k.replace("conditioner.embedders.0.", "conditioner.embedders.1."): v
             for k, v in sd.items()}
    torch.save(moved, path)
    with pytest.raises(accounting.ConversionAccountingError, match="missing"):
        port_checkpoint.load_sdxl_refiner_pipeline(str(path), CFG, device="cpu")
