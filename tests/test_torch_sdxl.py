"""The port's SDXL base (models/sdxl.py) against the JAX package's, fp32 on
the CPU at tiny_sdxl()'s widths, on the same seeded weights
(state_dict_from_jax into the sgm layout): the configurations, the ADM UNet
and ControlNet, the conditioning, 3 steps of the txt2img loop (plain, with
cfg_rescale, with the inpaint blend, its draws handed in), img2img, the
engine; the full-width module tree against the sdxl_base key universe; and
load_sdxl_pipeline on tiny files.

Tolerances, relative to max |reference|: a network evaluation and the
conditioning 1e-4; 3 sampler steps 1e-3 (each step feeds the last one's
rounding back through the UNet). Measured max |d| / max |ref| with one
torch thread: the networks and the conditioning at most 2.0e-6, the loops
at most 2.9e-6."""

import dataclasses
import inspect
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stablediffusioneo_tpu.checkpoint.manifest import load_universe
from stablediffusioneo_tpu.config import ControlNetConfig as JaxControlNetConfig
from stablediffusioneo_tpu.models import init_clip_text, init_controlnet, init_unet, init_vae
from stablediffusioneo_tpu.models import sdxl as jax_sdxl
from stablediffusioneo_tpu.models.controlnet import controlled_unet_apply as jax_controlled
from stablediffusioneo_tpu.models.unet import unet_apply as jax_unet_apply
from stablediffusioneo_tpu.models.vae import vae_decode as jax_vae_decode
from stablediffusioneo_tpu.ops.schedule import DiffusionSchedule as JaxSchedule
from stablediffusioneo_tpu.pipeline.ddim import _step_noise
from stablediffusioneo_tpu_torch import checkpoint as port_checkpoint
from stablediffusioneo_tpu_torch.checkpoint import accounting
from stablediffusioneo_tpu_torch.checkpoint.convert import state_dict_from_jax
from stablediffusioneo_tpu_torch.config import ControlNetConfig
from stablediffusioneo_tpu_torch.models import sdxl
from stablediffusioneo_tpu_torch.models.controlnet import ControlNet, controlled_unet_apply
from stablediffusioneo_tpu_torch.models.unet import UNetModel, unet_forward
from stablediffusioneo_tpu_torch.ops.layers import nchw, nhwc
from stablediffusioneo_tpu_torch.models.vae import vae_decode
from stablediffusioneo_tpu_torch.ops.schedule import DiffusionSchedule
from stablediffusioneo_tpu_torch.runtime.engine import sdxl_sample_decode_engine

from torch_port_util import assert_close_scaled, numpy_params

JCFG, CFG = jax_sdxl.tiny_sdxl(), sdxl.tiny_sdxl()
STEPS, SCALE, SEED = 3, 5.0, 11
NET_TOL, LOOP_TOL = 1e-4, 1e-3


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def params():
    return {"unet": numpy_params(init_unet, JCFG.unet, 1),
            "clip_l": numpy_params(init_clip_text, JCFG.clip_l, 2),
            "clip_g": numpy_params(init_clip_text, JCFG.clip_g, 3),
            "vae": numpy_params(init_vae, JCFG.vae, 4)}


@pytest.fixture(scope="module")
def sd(params):
    return state_dict_from_jax(params, CFG)


@pytest.fixture(scope="module")
def model(sd):
    m = sdxl.SDXL(CFG)
    m.load_checkpoint(sd)
    return m.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def cond(params):
    """Conditioning of a prompt and of the empty one, from the JAX package."""
    rng = np.random.default_rng(SEED)
    ids = rng.integers(5, 900, (1, 16)).astype(np.int32)
    out = {}
    for name, i in (("c", ids), ("u", np.zeros_like(ids))):
        ctx, y = jax_sdxl.sdxl_conditioning(params, JCFG, jnp.asarray(i), jnp.asarray(i),
                                            size_hw=(64, 64))
        out["ctx_" + name], out["y_" + name] = np.asarray(ctx), np.asarray(y)
    out["x_T"] = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    return out


# ----------------------------------------------------------- configuration

@pytest.mark.parametrize("name", ["sdxl_unet", "clip_l_sdxl", "clip_bigg_sdxl",
                                  "sdxl_vae", "SDXLConfig", "tiny_sdxl"])
def test_config_equals_the_jax_packages(name):
    port, ref = getattr(sdxl, name)(), getattr(jax_sdxl, name)()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_sdxl_config_has_the_jax_fields():
    assert [(f.name, f.type) for f in dataclasses.fields(sdxl.SDXLConfig)] == \
        [(f.name, f.type) for f in dataclasses.fields(jax_sdxl.SDXLConfig)]


def test_plans_leave_level_zero_without_transformers():
    from stablediffusioneo_tpu_torch.models.unet import decoder_plan, encoder_plan

    u = sdxl.sdxl_unet()
    res = [d for d in encoder_plan(u) if d["kind"] == "res"]
    assert [d["attn"] for d in res] == [False, False, True, True, True, True]
    assert [d["depth"] for d in res if d["attn"]] == [2, 2, 10, 10]
    assert [d["depth"] for d in decoder_plan(u) if d["attn"]] == [10] * 3 + [2] * 3
    with torch.device("meta"):
        unet = UNetModel(u)
    assert unet.input_blocks[1].transformer() is None
    assert len(unet.middle_block.transformer().transformer_blocks) == 10
    sites = sum(len(b.transformer().transformer_blocks)
                for b in list(unet.input_blocks) + [unet.middle_block] + list(unet.output_blocks)
                if b.transformer() is not None)
    assert sites == 70


# ------------------------------------------------------------ the networks

@pytest.mark.parametrize("variant", ["direct", "hoisted_kv"])
def test_adm_unet(params, model, rng, variant):
    x = rng.standard_normal((2, 8, 8, 4), dtype=np.float32)
    ctx = rng.standard_normal((2, 5, CFG.unet.context_dim), dtype=np.float32)
    y = rng.standard_normal((2, CFG.unet.adm_in_channels), dtype=np.float32)
    t = np.asarray([801.0, 33.0], np.float32)
    ref = jax.jit(lambda p, *a: jax_unet_apply(p, JCFG.unet, *a[:3], y=a[3]))(
        params["unet"], *map(jnp.asarray, (x, t, ctx, y)))
    kv = None
    if variant == "hoisted_kv":
        from stablediffusioneo_tpu_torch.models.unet import precompute_context_kv

        kv = precompute_context_kv(model.unet, _t(ctx))
    out = nhwc(unet_forward(model.unet, nchw(_t(x)), _t(t), _t(ctx), ctx_kv=kv, y=_t(y)))
    assert_close_scaled(out.numpy(), ref, NET_TOL)


def test_adm_unet_refuses_a_missing_y(model):
    with pytest.raises(ValueError, match="pass y"):
        unet_forward(model.unet, torch.zeros(1, 4, 8, 8), torch.zeros(1),
                     torch.zeros(1, 5, CFG.unet.context_dim))


def test_adm_controlnet(params, sd, rng):
    """An ADM-conditioned ControlNet (its own label_emb): y through both
    branches, against the JAX controlled_unet_apply(y=)."""
    jccfg = JaxControlNetConfig(unet=JCFG.unet)
    ctrl_p = numpy_params(init_controlnet, jccfg, 9)
    from stablediffusioneo_tpu_torch.checkpoint.convert import controlnet_state_dict

    csd = {}
    controlnet_state_dict(csd, ControlNetConfig(unet=CFG.unet), ctrl_p, prefix="")
    control = ControlNet(ControlNetConfig(unet=CFG.unet))
    accounting.account_checkpoint(control, csd).assert_complete("adm controlnet")
    accounting.copy_checkpoint_(control, csd)
    assert "label_emb.0.2.weight" in csd
    unet = UNetModel(CFG.unet)
    unet.load_state_dict({k[len("model.diffusion_model."):]: v for k, v in sd.items()
                          if k.startswith("model.diffusion_model.")})
    x = rng.standard_normal((1, 8, 8, 4), dtype=np.float32)
    hint = rng.random((1, 64, 64, 3), dtype=np.float32)
    ctx = rng.standard_normal((1, 5, CFG.unet.context_dim), dtype=np.float32)
    y = rng.standard_normal((1, CFG.unet.adm_in_channels), dtype=np.float32)
    t = np.asarray([123.0], np.float32)
    scales = [0.9] * 10
    ref = jax.jit(lambda u, c, *a: jax_controlled(u, c, jccfg, *a[:4], control_scales=scales,
                                                  y=a[4]))(
        params["unet"], ctrl_p, *map(jnp.asarray, (x, hint, t, ctx, y)))
    with torch.no_grad():
        out = controlled_unet_apply(unet, control, _t(x), _t(hint), _t(t), _t(ctx),
                                    control_scales=scales, y=_t(y))
    assert_close_scaled(out.numpy(), ref, NET_TOL)


def test_vae_decode_scale(params, model, rng):
    z = rng.standard_normal((1, 8, 8, 4), dtype=np.float32)
    ref = jax_vae_decode(params["vae"], JCFG.vae, jnp.asarray(z), scaled=True)
    assert_close_scaled(vae_decode(model.vae, _t(z)).numpy(), ref, NET_TOL)


# ------------------------------------------------------------ conditioning

def test_add_time_ids(rng):
    for orig, crop, target, fourier in (((1024, 1024), (0, 0), (1024, 1024), 256),
                                        ((768, 1344), (16, 32), (1024, 1024), 8)):
        ref = jax_sdxl.add_time_ids(orig, crop, target, 2, fourier_dim=fourier)
        out = sdxl.add_time_ids(orig, crop, target, 2, fourier_dim=fourier)
        assert out.dtype == torch.float32 and out.shape == (2, 6 * fourier)
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)


def test_sdxl_tokenize_is_the_jax_packages():
    """The port keeps its own copy (numpy only), line for line, and it pads
    tower 2 with zeros after the first EOT."""
    assert inspect.getsource(sdxl.sdxl_tokenize) == inspect.getsource(jax_sdxl.sdxl_tokenize)

    class Tok:
        eot = 999

        def __call__(self, texts):
            rows = [[998] + [7 + len(w) for w in t.split()] + [999] for t in texts]
            return np.array([(r + [999] * 16)[:16] for r in rows], np.int32)

    texts = ["a red house", "a cat on a mat by the door"]
    for got, want in zip(sdxl.sdxl_tokenize(Tok(), texts),
                         jax_sdxl.sdxl_tokenize(Tok(), texts)):
        np.testing.assert_array_equal(got, want)
    ids_l, ids_g = sdxl.sdxl_tokenize(Tok(), texts)
    assert (ids_l[0, 5:] == 999).all() and ids_g[0, 4] == 999 and (ids_g[0, 5:] == 0).all()


def test_sdxl_conditioning(params, model, rng):
    ids = rng.integers(5, 900, (2, 16)).astype(np.int32)
    ids_g = ids.copy()
    ids_g[:, 9] = 999  # an EOT-like maximum inside the row, zeros after it
    ids_g[:, 10:] = 0
    ref_ctx, ref_y = jax_sdxl.sdxl_conditioning(
        params, JCFG, jnp.asarray(ids), jnp.asarray(ids_g), size_hw=(64, 96),
        original_size=(80, 120), crop_coords=(8, 4))
    ctx, y = sdxl.sdxl_conditioning(model, torch.from_numpy(ids).long(),
                                    torch.from_numpy(ids_g).long(), (64, 96),
                                    original_size=(80, 120), crop_coords=(8, 4))
    assert ctx.shape == (2, 16, CFG.unet.context_dim)
    assert y.shape == (2, CFG.unet.adm_in_channels) and y.dtype == torch.float32
    assert_close_scaled(ctx.numpy(), ref_ctx, NET_TOL)
    assert_close_scaled(y.numpy(), ref_y, NET_TOL)


def test_clip_l_tower_penultimate_raw(params, model, rng):
    from stablediffusioneo_tpu.models.clip import clip_text_apply as jax_clip
    from stablediffusioneo_tpu_torch.models.clip import clip_text_apply

    ids = rng.integers(0, 1000, (2, 16))
    for layer in ("penultimate_raw", "penultimate", "last"):
        ref = jax_clip(params["clip_l"], JCFG.clip_l, jnp.asarray(ids), layer=layer)
        out = clip_text_apply(model.clip_l, torch.from_numpy(ids), layer=layer)
        assert_close_scaled(out.numpy(), ref, NET_TOL)


# ------------------------------------------------------------------- loops

def _jax_schedule():
    return {k: jnp.asarray(v) for k, v in JaxSchedule().ddim(STEPS).items()}


def _inpaint_inputs():
    rng = np.random.default_rng(4)
    mask = np.zeros((1, 8, 8, 1), np.float32)
    mask[:, 2:6, 1:7] = 1.0
    return rng.standard_normal((1, 8, 8, 4)).astype(np.float32), mask


@pytest.mark.parametrize("variant", ["plain", "cfg_rescale", "inpaint"])
def test_sdxl_txt2img(params, model, cond, variant):
    rescale = 0.7 if variant == "cfg_rescale" else 0.0
    key = jax.random.PRNGKey(SEED)
    jkw, kw = {}, {}
    if variant == "inpaint":
        lat, mask = _inpaint_inputs()
        jkw = dict(inpaint_latent=jnp.asarray(lat), inpaint_mask=jnp.asarray(mask))
        ikey = jax.random.fold_in(key, 0x1B9A1)
        kw = dict(inpaint_latent=_t(lat), inpaint_mask=_t(mask), inpaint_noise=[
            torch.from_numpy(np.array(_step_noise(ikey, jnp.int32(i), lat.shape)))
            for i in range(STEPS)])
    ref = jax.jit(lambda u, s, *a: jax_sdxl.sdxl_txt2img_scan(
        u, JCFG, s, *a, jnp.float32(SCALE), key, cfg_rescale=rescale, **jkw))(
        params["unet"], _jax_schedule(), *(jnp.asarray(cond[k]) for k in (
            "x_T", "ctx_c", "ctx_u", "y_c", "y_u")))
    sched = DiffusionSchedule().ddim(STEPS)
    with torch.no_grad():
        out = sdxl.sdxl_txt2img(model.unet, sched, *(_t(cond[k]) for k in (
            "x_T", "ctx_c", "ctx_u", "y_c", "y_u")), SCALE, cfg_rescale=rescale, **kw)
    assert torch.isfinite(out).all()
    assert_close_scaled(out.numpy(), ref, LOOP_TOL)


def test_sdxl_img2img_latents(params, model, cond):
    """The JAX entry draws its re-noise from split(key)[1]; handed in here."""
    z0 = np.random.default_rng(6).standard_normal((1, 8, 8, 4)).astype(np.float32)
    key = jax.random.PRNGKey(SEED)
    renoise = np.array(jax.random.normal(jax.random.split(key)[1], z0.shape, jnp.float32))
    names = ("ctx_c", "ctx_u", "y_c", "y_u")
    ref = jax_sdxl.sdxl_img2img_latents(
        params["unet"], JCFG, JaxSchedule().ddim(5), jnp.asarray(z0), 2,
        *(jnp.asarray(cond[k]) for k in names), jnp.float32(SCALE), key)
    with torch.no_grad():
        out = sdxl.sdxl_img2img_latents(model.unet, DiffusionSchedule().ddim(5), _t(z0), 2,
                                        *(_t(cond[k]) for k in names), SCALE,
                                        renoise=_t(renoise))
    assert_close_scaled(out.numpy(), ref, LOOP_TOL)


def test_engine_is_the_loop_and_decode(model, cond):
    """sdxl_sample_decode_engine on the CPU runs eagerly: its latents are
    sdxl_txt2img's and its image their uint8 decode."""
    eng = sdxl_sample_decode_engine(model, STEPS, 1, 64, 64)
    assert not eng.compiled
    args = [_t(cond[k]) for k in ("x_T", "ctx_c", "ctx_u", "y_c", "y_u")]
    img, z = eng(*args, torch.tensor([SCALE]))
    with torch.no_grad():
        want = sdxl.sdxl_txt2img(model.unet, DiffusionSchedule().ddim(STEPS), *args, SCALE)
        pix = vae_decode(model.vae, want)
    assert torch.equal(z, want)
    assert img.dtype == torch.uint8 and img.shape == (1, 64, 64, 3)
    assert torch.equal(img, torch.clamp(pix * 127.5 + 127.5, 0, 255).to(torch.uint8))


# ------------------------------------------------------------- checkpoints

def test_full_width_sdxl_has_the_sdxl_base_key_universe():
    """SDXL base at full width on the meta device: exactly the names and
    shapes of the sdxl_base universe (2,515 keys; its proj_in / proj_out as
    1x1 convs), less the two OpenCLIP leftovers its tree names."""
    universe = load_universe("sdxl_base")
    ignore = [re.compile(p) for p in accounting.tree_ignores(sdxl.SDXL_TREES)]
    left = {k for k in universe if any(p.fullmatch(k) for p in ignore)}
    assert left == {"conditioner.embedders.1.model.attn_mask",
                    "conditioner.embedders.1.model.logit_scale"}
    with torch.device("meta"):
        model = sdxl.SDXL(sdxl.SDXLConfig())
    have = {k: "x".join(map(str, v.shape)) for k, v in model.state_dict().items()}
    assert have == {k: s for k, s in universe.items() if k not in left}
    assert len(universe) == 2515
    counts = {p: sum(k.startswith(p) for k in universe)
              for p in ("model.", "conditioner.", "first_stage_model.")}
    assert counts == {"model.": 1680, "conditioner.": 587, "first_stage_model.": 248}
    unet = sum(p.numel() for p in model.unet.parameters())
    assert 2.56e9 < unet < 2.58e9


def _linear_proj(sd):
    """proj_in / proj_out as the Linear weights SDXL files store."""
    return {k: (v[:, :, 0, 0].clone() if re.search(r"\.1\.proj_(in|out)\.weight$", k)
                and v.dim() == 4 else v) for k, v in sd.items()}


def test_load_sdxl_pipeline(sd, model, tmp_path):
    """A tiny sgm-layout file, its projections Linear-stored and its leftovers
    (position_ids, attn_mask, logit_scale, a schedule buffer) present:
    strict load, every key consumed, the weights exact; an orphan raises."""
    extra = {"conditioner.embedders.0.transformer.text_model.embeddings.position_ids":
             torch.arange(16)[None],
             "conditioner.embedders.1.model.attn_mask": torch.zeros(16, 16),
             "conditioner.embedders.1.model.logit_scale": torch.tensor(4.6),
             "alphas_cumprod": torch.linspace(1, 0, 10)}
    path = tmp_path / "sdxl.pth"
    torch.save({**_linear_proj(sd), **extra}, path)
    loaded = port_checkpoint.load_sdxl_pipeline(str(path), CFG, device="cpu")
    rep = loaded.load_report
    assert rep.complete and rep.consumed == set(sd) and rep.ignored == set(extra)
    assert any(v.dim() == 2 for k, v in _linear_proj(sd).items() if k.endswith("proj_in.weight"))
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    torch.save({**sd, "conditioner.embedders.2.model.foo": torch.zeros(1)}, path)
    with pytest.raises(accounting.ConversionAccountingError, match="never consumed"):
        port_checkpoint.load_sdxl_pipeline(str(path), CFG, device="cpu")
    assert port_checkpoint.load_sdxl_pipeline(str(path), CFG, device="cpu",
                                              strict=False).load_report.orphans == {
        "conditioner.embedders.2.model.foo"}
    bf16 = port_checkpoint.load_sdxl_pipeline(str(path), CFG, device="cpu", strict=False,
                                              dtype=torch.bfloat16)
    assert {p.dtype for p in bf16.parameters()} == {torch.bfloat16}


def test_projection_rule_is_for_transformer_projections_only(sd):
    k = "model.diffusion_model.input_blocks.4.1.proj_in.weight"
    assert accounting.proj_weight_fits(k, (640, 640), (640, 640, 1, 1))
    assert not accounting.proj_weight_fits(k, (640, 320), (640, 640, 1, 1))
    assert not accounting.proj_weight_fits(
        "first_stage_model.decoder.mid.attn_1.proj_out.weight", (512, 512), (512, 512, 1, 1))
    assert not accounting.proj_weight_fits(
        "model.diffusion_model.input_blocks.4.0.skip_connection.weight", (640, 320),
        (640, 320, 1, 1))
