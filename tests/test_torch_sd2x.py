"""The port's SD-2.x family against the JAX package's, fp32 on the CPU at
tiny widths, on the same seeded weights (state_dict_from_jax, the text
tower under OpenCLIP's names): the OpenCLIP tower ("last", "penultimate",
"penultimate_raw", the pooled and projected output), the ControlNet-free
txt2img loop (v-prediction), process() on an SD-2.x ControlNet
configuration (OpenCLIP penultimate, 16-channel heads, v), and the loaders
on SD-2.x-layout files.

Tolerances, relative to max |reference|: the tower 1e-4; 3 loop steps
1e-3; process() the JAX bound of test_torch_pipeline: max |d| <= 1 of 255
on the image and 1e-3 on the latents. Measured max |d| / max |ref| with
one torch thread: the tower and the contexts at most 1.2e-6, the loop
3.8e-6."""

import dataclasses
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stablediffusioneo_tpu import config as jax_config
from stablediffusioneo_tpu.models import init_clip_text, init_controlnet, init_unet, init_vae
from stablediffusioneo_tpu.models.clip import (
    clip_text_apply as jax_clip,
    clip_text_apply_with_pooled as jax_clip_pooled,
    clip_text_pooled as jax_clip_text_pooled,
)
from stablediffusioneo_tpu.models.tokenizer import toy_tokenizer
from stablediffusioneo_tpu.ops.schedule import DiffusionSchedule as JaxSchedule
from stablediffusioneo_tpu.pipeline.canny2image import Canny2ImagePipeline as JaxPipeline
from stablediffusioneo_tpu.pipeline.concat_cond import sd_txt2img_scan
from stablediffusioneo_tpu_torch import checkpoint as port_checkpoint
from stablediffusioneo_tpu_torch import config as port_config
from stablediffusioneo_tpu_torch.checkpoint import accounting
from stablediffusioneo_tpu_torch.checkpoint.convert import (
    openclip_state_dict,
    state_dict_from_jax,
)
from stablediffusioneo_tpu_torch.models.cldm import ControlLDM, LatentDiffusion
from stablediffusioneo_tpu_torch.models.clip import (
    OpenCLIPTextModel,
    clip_text_apply,
    clip_text_apply_with_pooled,
    clip_text_pooled,
)
from stablediffusioneo_tpu_torch.ops.schedule import DiffusionSchedule
from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline
from stablediffusioneo_tpu_torch.pipeline.concat_cond import sd_txt2img

from torch_port_util import assert_close_scaled, numpy_params

TOWER_TOL, LOOP_TOL = 1e-4, 1e-3


def tiny_sd2x(pkg):
    """tiny_pipeline() made SD-2.x: 16-channel heads, an OpenCLIP-style
    penultimate tower with exact gelu, v-prediction (in either package)."""
    base = pkg.tiny_pipeline()
    unet = dataclasses.replace(base.unet, num_head_channels=16)
    return dataclasses.replace(
        base, unet=unet, controlnet=pkg.ControlNetConfig(unet=unet),
        clip=dataclasses.replace(base.clip, layer="penultimate", act="gelu"),
        diffusion=dataclasses.replace(base.diffusion, parameterization="v"))


JCFG, CFG = tiny_sd2x(jax_config), tiny_sd2x(port_config)
TOWER = port_config.CLIPTextConfig(vocab_size=1000, hidden_size=32, intermediate_size=64,
                                   num_layers=3, num_heads=2, max_length=16,
                                   layer="penultimate", act="gelu", projection_dim=24)
JTOWER = jax_config.CLIPTextConfig(**dataclasses.asdict(TOWER))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def params():
    return {"unet": numpy_params(init_unet, JCFG.unet, 1),
            "controlnet": numpy_params(init_controlnet, JCFG.controlnet, 2),
            "vae": numpy_params(init_vae, JCFG.vae, 3),
            "clip": numpy_params(init_clip_text, JCFG.clip, 4)}


@pytest.fixture(scope="module")
def model(params):
    m = ControlLDM(CFG)
    m.load_checkpoint(state_dict_from_jax(params, CFG))
    return m.eval().requires_grad_(False)


def test_sd21_configs_equal_the_jax_packages():
    for name in ("sd21_unet", "openclip_vit_h_text", "sd21_pipeline"):
        assert dataclasses.asdict(getattr(port_config, name)()) == \
            dataclasses.asdict(getattr(jax_config, name)())
    assert dataclasses.asdict(port_config.sd21_pipeline("float32", v_prediction=False)) == \
        dataclasses.asdict(jax_config.sd21_pipeline("float32", v_prediction=False))


def test_full_width_sd21_model_tree():
    """SD-2.1 + ControlNet at full width on the meta device: OpenCLIP ViT-H
    (24 blocks, packed q/k/v) at cond_stage_model.model., no HF tower, heads
    of 64 channels, SD-2.x's 1024-wide context."""
    with torch.device("meta"):
        model = ControlLDM(port_config.sd21_pipeline())
    keys = model.state_dict()
    tower = {k for k in keys if k.startswith("cond_stage_model.")}
    assert all(k.startswith("cond_stage_model.model.") for k in tower)
    assert len(tower) == 24 * 12 + 4
    assert keys["cond_stage_model.model.transformer.resblocks.23.attn.in_proj_weight"].shape \
        == (3072, 1024)
    assert keys["model.diffusion_model.input_blocks.1.1.transformer_blocks.0.attn2.to_k.weight"] \
        .shape == (320, 1024)
    heads = [m.heads for m in model.unet.modules() if hasattr(m, "to_q")]
    assert sorted(set(heads)) == [5, 10, 20]


# ------------------------------------------------------------ OpenCLIP tower

@pytest.fixture(scope="module")
def tower():
    p = numpy_params(init_clip_text, JTOWER, 7)
    sd = {}
    openclip_state_dict(sd, p, prefix="")
    m = OpenCLIPTextModel(TOWER)
    accounting.account_checkpoint(m, sd).assert_complete("openclip")
    accounting.copy_checkpoint_(m, sd)
    return p, m.eval().requires_grad_(False)


def _padded_ids():
    """Two rows as open_clip.tokenize makes them: SOT, words, EOT (the
    largest id), then zeros."""
    rng = np.random.default_rng(8)
    ids = np.zeros((2, 16), np.int64)
    for row, n in zip(ids, (5, 11)):
        row[0], row[1:n + 1], row[n + 1] = 998, rng.integers(1, 990, n), 999
    return ids


@pytest.mark.parametrize("layer", ["last", "penultimate", "penultimate_raw"])
def test_openclip_tower(tower, layer):
    p, m = tower
    ids = _padded_ids()
    ref = jax_clip(p, JTOWER, jnp.asarray(ids), layer=layer)
    with torch.no_grad():
        out = clip_text_apply(m, torch.from_numpy(ids), layer=layer)
    assert_close_scaled(out.numpy(), ref, TOWER_TOL)


@pytest.mark.parametrize("layer", ["penultimate", "penultimate_raw", "last"])
@pytest.mark.parametrize("eot_id", [None, 999])
def test_openclip_tower_with_pooled(tower, layer, eot_id):
    """One forward -> (hidden, pooled through text_projection (d, proj))."""
    p, m = tower
    jcfg = dataclasses.replace(JTOWER, layer=layer)
    m.cfg = dataclasses.replace(TOWER, layer=layer)
    ids = _padded_ids()
    try:
        ref_h, ref_p = jax_clip_pooled(p, jcfg, jnp.asarray(ids), eot_id=eot_id)
        with torch.no_grad():
            h, pooled = clip_text_apply_with_pooled(m, torch.from_numpy(ids), eot_id=eot_id)
            alone = clip_text_pooled(m, torch.from_numpy(ids), eot_id=eot_id)
    finally:
        m.cfg = TOWER
    assert pooled.shape == (2, TOWER.projection_dim)
    assert_close_scaled(h.numpy(), ref_h, TOWER_TOL)
    assert_close_scaled(pooled.numpy(), ref_p, TOWER_TOL)
    assert_close_scaled(alone.numpy(),
                        jax_clip_text_pooled(p, jcfg, jnp.asarray(ids), eot_id=eot_id),
                        TOWER_TOL)


def test_a_projected_tower_is_openclips():
    """A projected tower in OpenCLIP's layout stores `text_projection`
    (d, proj); in HF's (CLIPTextModelWithProjection: SD3's CLIP-L and bigG)
    a bias-free Linear, stored (proj, d). Both hand the pooled output the
    (d, proj) matrix."""
    from stablediffusioneo_tpu_torch.models.clip import CLIPTextModel

    hf, oc = CLIPTextModel(TOWER), OpenCLIPTextModel(TOWER)
    assert hf.text_projection.weight.shape == (24, 32) and hf.text_projection.bias is None
    assert torch.equal(hf.projection(), hf.text_projection.weight.t())
    assert oc.text_projection.shape == (32, 24)
    assert oc.projection() is oc.text_projection
    assert hf.projection().shape == oc.projection().shape


def test_openclip_packs_q_k_v_in_order(tower):
    p, m = tower
    w = m.transformer.resblocks[1].attn.in_proj_weight
    for i, n in enumerate(("q", "k", "v")):
        np.testing.assert_array_equal(w[32 * i:32 * (i + 1)].numpy(),
                                      np.asarray(p["layers"][1][n]["w"]).T)
    np.testing.assert_array_equal(m.text_projection.numpy(), p["text_projection"]["w"])


# ---------------------------------------------------------------- the loops

def test_sd_txt2img_v(params, model):
    """sd_txt2img against sd_txt2img_scan, v-prediction, 3 steps at scale
    9 (the tiny nets take the contexts as given)."""
    rng = np.random.default_rng(12)
    x_T = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 16, CFG.unet.context_dim)).astype(np.float32)
    sched = JaxSchedule().ddim(3)
    ref = sd_txt2img_scan(params["unet"], JCFG.unet,
                          {k: jnp.asarray(v) for k, v in sched.items()},
                          jnp.asarray(x_T), jnp.asarray(ctx[:1]), jnp.asarray(ctx[1:]),
                          jnp.float32(9.0), jax.random.PRNGKey(0), parameterization="v")
    with torch.no_grad():
        out = sd_txt2img(model.unet, DiffusionSchedule().ddim(3), _t(x_T), _t(ctx[:1]),
                         _t(ctx[1:]), 9.0, parameterization="v")
    assert_close_scaled(out.numpy(), ref, LOOP_TOL)


def test_process_on_an_sd2x_controlnet(params, model):
    """process() through the port's runtime and the JAX Canny2ImagePipeline:
    the OpenCLIP penultimate contexts, 16-channel heads, the v update."""
    rng = np.random.default_rng(0)
    image = (rng.random((70, 60, 3)) * 255).astype(np.uint8)
    x_T = rng.standard_normal((1, 8, 8, 4), dtype=np.float32)
    tok = toy_tokenizer(max_length=CFG.clip.max_length)
    jax_pipe = JaxPipeline(params, tok, JCFG, persistent_cache=False)
    port_pipe = Canny2ImagePipeline(model, tok, CFG, device="cpu")
    kw = dict(a_prompt="best quality", n_prompt="lowres", num_samples=1,
              image_resolution=64, ddim_steps=2, seed=42, eta=0.0, x_T=x_T)
    ref = jax_pipe.process(image, "a bird", **kw)
    out = port_pipe.process(image, "a bird", **kw)
    assert np.array_equal(out[0], ref[0])
    assert out[1].shape == ref[1].shape == (64, 64, 3)
    assert np.abs(out[1].astype(int) - ref[1].astype(int)).max() <= 1
    rt = jax_pipe.runtime
    ids = tok(["a bird, best quality", "lowres"])
    ctx = rt.encode_prompt(ids)
    with torch.no_grad():
        port_ctx = port_pipe.runtime.encode_prompt(ids)
    assert_close_scaled(port_ctx.numpy(), ctx, TOWER_TOL)
    z_ref = np.asarray(rt.sample(2, jnp.asarray(x_T), jnp.asarray(out[0][None]),
                                 ctx[0:1], ctx[1:2], jnp.asarray([0, 0], jnp.uint32)))
    assert np.abs(port_pipe.last_latents.numpy() - z_ref).max() <= 1e-3


# ------------------------------------------------------------------ loaders

def _sd2x_file(sd, path):
    """An SD-2.x-layout file: Linear-stored proj_in / proj_out and OpenCLIP's
    leftovers (attn_mask, logit_scale, an unused text_projection)."""
    out = {k: (v[:, :, 0, 0].clone() if re.search(r"\.1\.proj_(in|out)\.weight$", k)
               and v.dim() == 4 else v) for k, v in sd.items()}
    out.update({"cond_stage_model.model.attn_mask": torch.zeros(16, 16),
                "cond_stage_model.model.logit_scale": torch.tensor(4.6),
                "cond_stage_model.model.text_projection": torch.zeros(64, 32),
                "betas": torch.linspace(0, 1, 10)})
    torch.save(out, path)
    return out


def test_load_sd_pipeline_sd2x(params, tmp_path):
    sd = state_dict_from_jax({k: v for k, v in params.items() if k != "controlnet"}, CFG)
    with torch.device("meta"):
        want = set(LatentDiffusion(CFG).state_dict())
    assert set(sd) == want and not any(k.startswith("control_model.") for k in sd)
    path = tmp_path / "v2-tiny.ckpt"
    written = _sd2x_file(sd, path)
    assert written["model.diffusion_model.input_blocks.1.1.proj_in.weight"].dim() == 2
    loaded = port_checkpoint.load_sd_pipeline(str(path), CFG, device="cpu")
    rep = loaded.load_report
    assert rep.complete and rep.consumed == set(sd)
    assert rep.ignored == set(written) - set(sd)
    assert isinstance(loaded.clip, OpenCLIPTextModel)
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, sd[k].reshape(v.shape)), k
    torch.save({**written, "control_model.input_blocks.0.0.weight": torch.zeros(1)}, path)
    with pytest.raises(accounting.ConversionAccountingError, match="never consumed"):
        port_checkpoint.load_sd_pipeline(str(path), CFG, device="cpu")


def test_load_controlnet_pipeline_sd2x(params, model, tmp_path):
    path = tmp_path / "control_v21.pth"
    _sd2x_file(state_dict_from_jax(params, CFG), path)
    loaded = port_checkpoint.load_controlnet_pipeline(str(path), CFG, device="cpu")
    assert loaded.load_report.complete
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, 1000, (1, 16)))
    with torch.no_grad():
        assert torch.equal(clip_text_apply(loaded.clip, ids), clip_text_apply(model.clip, ids))
