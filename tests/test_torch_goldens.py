"""The committed goldens (tests/goldens/goldens_v1.npz, XLA-CPU uint8
images of the JAX package's tiny pipeline, stablediffusioneo_tpu/testing/
goldens.py) replayed through the port on the CPU: the ten SD-1.5 records
through process(), sd21v_ddim with a v-parameterised port configuration, and
sdxl_txt2img through the port's SDXL (models/sdxl.py: the conditioning of
both towers, then sdxl_sample_decode_engine, which runs eagerly on the CPU).
No JAX program is compiled: the weights
are goldens.py's seeded JAX parameters, converted, and the JAX package's
random draws are made eagerly and handed in, as its engine makes them from
PRNGKey(7): x_T = normal(split(key)[1]); the loop's key split(key)[0] gives
the eta and Euler-a step noise (`_step_noise(loop key, i)`) and the inpaint
noise (`_step_noise(fold_in(loop key, 0x1B9A1), i)`); the img2img re-noise is
normal(split(key)[1]), and img2img takes no x_T.

Tolerance, of 255: the DDIM records (sdxl_txt2img among them) max |d| <= 1; the other samplers' records
at most 2, in at most 1% of the values. Measured with one torch thread, as
the suite runs (max |d|, values that differ of 12,288): sd15_ddim 1, 2;
sd15_ddim_eta05 1, 2; sd15_guess_mode 0; sd15_img2img 1, 6; sd15_inpaint 1,
6; sd21v_ddim 1, 5; sd15_plms 1, 3; sd15_unipc 1, 3; sd15_dpmpp 1, 2;
sd15_euler_a 1, 1; sdxl_txt2img 1, 2. With a thread a core the summation order moves a few
values (sd15_dpmpp 0, sd15_img2img 1, 2), none past 1."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablediffusioneo_tpu.models.tokenizer import toy_tokenizer
from stablediffusioneo_tpu.pipeline.ddim import _step_noise
from stablediffusioneo_tpu.testing import goldens
from stablediffusioneo_tpu.testing.fixtures import make_scene
from stablediffusioneo_tpu_torch.checkpoint.convert import state_dict_from_jax
from stablediffusioneo_tpu_torch.models.cldm import ControlLDM
from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline

from torch_port_util import PORT_CFG

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                    goldens.GOLDEN_FILE)
RECORDS = ["sd15_ddim", "sd15_ddim_eta05", "sd15_guess_mode", "sd15_img2img",
           "sd15_inpaint", "sd21v_ddim", "sd15_plms", "sd15_unipc", "sd15_dpmpp",
           "sd15_euler_a"]
DDIM = {"sd15_ddim", "sd15_ddim_eta05", "sd15_guess_mode", "sd15_img2img",
        "sd15_inpaint", "sd21v_ddim"}
RES, STEPS, SEED = goldens._RES, goldens._STEPS, goldens._SEED


@pytest.fixture(scope="module")
def committed():
    with np.load(PATH) as z:
        return {k: z[k] for k in z.files}


def _params():
    """goldens.build_sd15_pipe's seeded parameters, without a pipeline."""
    from stablediffusioneo_tpu.config import tiny_pipeline
    from stablediffusioneo_tpu.models import (
        init_clip_text,
        init_controlnet,
        init_unet,
        init_vae,
    )

    cfg = tiny_pipeline()
    ks = jax.random.split(jax.random.PRNGKey(20260819), 6)
    return {
        "unet": goldens._perturb_zero_leaves(init_unet(ks[0], cfg.unet), ks[4]),
        "controlnet": goldens._perturb_zero_leaves(
            init_controlnet(ks[1], cfg.controlnet), ks[5]),
        "vae": init_vae(ks[2], cfg.vae),
        "clip": init_clip_text(ks[3], cfg.clip),
    }


@pytest.fixture(scope="module")
def pipes():
    """The port's pipeline on the goldens' weights, eps and v."""
    params = _params()
    out = {}
    for par in ("eps", "v"):
        cfg = dataclasses.replace(PORT_CFG, diffusion=dataclasses.replace(
            PORT_CFG.diffusion, parameterization=par))
        model = ControlLDM(cfg)
        model.load_checkpoint(state_dict_from_jax(params, cfg))
        tok = toy_tokenizer(vocab_size=cfg.clip.vocab_size, max_length=cfg.clip.max_length)
        out[par] = Canny2ImagePipeline(model.eval(), tok, cfg, device="cpu")
    return out


def _jax_draws(kw):
    """The JAX engine's draws for one record, as process() arguments."""
    shape = (1, RES // 8, RES // 8, 4)
    loop_key, sub = jax.random.split(jax.random.PRNGKey(SEED))

    def steps(key):
        return np.stack([np.array(_step_noise(key, jnp.int32(i), shape))
                         for i in range(STEPS)])

    if "init_image" in kw:
        return {"img2img_noise": np.array(jax.random.normal(sub, shape, jnp.float32))}
    draws = {"x_T": np.array(jax.random.normal(sub, shape, jnp.float32))}
    if kw.get("eta") or kw.get("sampler") == "euler-a":
        draws["step_noise"] = steps(loop_key)
    if "inpaint_image" in kw:
        draws["inpaint_noise"] = steps(jax.random.fold_in(loop_key, 0x1B9A1))
    return draws


def _record_kwargs(name):
    if name == "sd21v_ddim":
        return {}
    return dict(goldens._sd15_record_specs())[name]


@pytest.mark.parametrize("name", RECORDS)
def test_golden_replays_through_the_port(committed, pipes, name):
    kw = _record_kwargs(name)
    pipe = pipes["v" if name == "sd21v_ddim" else "eps"]
    out = pipe.process(make_scene(1001, RES), "a bird", num_samples=1,
                       image_resolution=RES, ddim_steps=STEPS, seed=SEED,
                       **kw, **_jax_draws(kw))[-1]
    want = committed[name]
    assert out.shape == want.shape and out.dtype == want.dtype == np.uint8
    diff = np.abs(out.astype(np.int16) - want.astype(np.int16))
    if name in DDIM:
        assert diff.max() <= 1, (name, diff.max())
    else:
        assert diff.max() <= 2 and (diff > 0).mean() <= 0.01, \
            (name, diff.max(), (diff > 0).mean())


def test_sdxl_golden_replays_through_the_port(committed):
    """goldens._sdxl_record's seeded SDXL, its prompt ids (both towers) and
    empty uncond ids, x_T and DDIM at scale 5, eta 0 (no draws besides)."""
    from stablediffusioneo_tpu.models import init_clip_text, init_unet, init_vae
    from stablediffusioneo_tpu.models.sdxl import tiny_sdxl as jax_tiny_sdxl
    from stablediffusioneo_tpu_torch.models.sdxl import SDXL, sdxl_conditioning, tiny_sdxl
    from stablediffusioneo_tpu_torch.runtime.engine import sdxl_sample_decode_engine

    jcfg, cfg = jax_tiny_sdxl(), tiny_sdxl()
    ks = jax.random.split(jax.random.PRNGKey(20260819), 5)
    params = {"unet": goldens._perturb_zero_leaves(init_unet(ks[0], jcfg.unet), ks[4]),
              "clip_l": init_clip_text(ks[1], jcfg.clip_l),
              "clip_g": init_clip_text(ks[2], jcfg.clip_g),
              "vae": init_vae(ks[3], jcfg.vae)}
    model = SDXL(cfg)
    model.load_checkpoint(state_dict_from_jax(params, cfg))
    model.eval().requires_grad_(False)
    rng = np.random.default_rng(SEED)
    ids = torch.from_numpy(rng.integers(5, 900, (1, 16)).astype(np.int32)).long()
    uncond = torch.zeros_like(ids)
    with torch.no_grad():
        ctx_c, y_c = sdxl_conditioning(model, ids, ids, size_hw=(RES, RES))
        ctx_u, y_u = sdxl_conditioning(model, uncond, uncond, size_hw=(RES, RES))
    x_T = torch.from_numpy(rng.standard_normal((1, RES // 8, RES // 8, 4)).astype(np.float32))
    eng = sdxl_sample_decode_engine(model, STEPS, 1, RES, RES)
    out = eng(x_T, ctx_c, ctx_u, y_c, y_u, torch.tensor([5.0]))[0][0].numpy()
    want = committed["sdxl_txt2img"]
    assert out.shape == want.shape and out.dtype == want.dtype == np.uint8
    diff = np.abs(out.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, diff.max()


def test_the_replayed_records_are_the_committed_sd15_set(committed):
    """The whole committed set: the SD-1.5 records and sdxl_txt2img."""
    assert set(RECORDS) | {"sdxl_txt2img"} == set(committed)
    assert len(committed) == 11
    assert torch.get_default_dtype() == torch.float32
