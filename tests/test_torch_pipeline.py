"""The PyTorch port's canny2image slice against the JAX package's, fp32 on
the CPU at tiny_pipeline() size: both run process() on the same weights,
image and x_T, 2 DDIM steps, eta 0. The bf16 cases at the end hold the
loop's carry: the latents are rounded to bf16 on entry and once per step."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from stablediffusioneo_tpu.models.tokenizer import toy_tokenizer
from stablediffusioneo_tpu.pipeline.canny2image import (
    Canny2ImagePipeline as JaxPipeline,
)
from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline

from torch_port_util import CFG, PORT_CFG, port_model, tiny_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
A_PROMPT = "best quality"
N_PROMPT = "lowres, bad anatomy"


@pytest.fixture(scope="module")
def slice_inputs():
    rng = np.random.default_rng(0)
    return {
        "image": (rng.random((70, 60, 3)) * 255).astype(np.uint8),
        "x_T": rng.standard_normal((1, 8, 8, 4), dtype=np.float32),
    }


@pytest.fixture(scope="module")
def pipes():
    params = tiny_params()
    tok = toy_tokenizer(max_length=CFG.clip.max_length)
    jax_pipe = JaxPipeline(params, tok, CFG, persistent_cache=False)
    port_pipe = Canny2ImagePipeline(port_model(params), tok, PORT_CFG, device="cpu")
    return jax_pipe, port_pipe


def test_process_matches_jax(pipes, slice_inputs):
    jax_pipe, port_pipe = pipes
    kw = dict(a_prompt=A_PROMPT, n_prompt=N_PROMPT, num_samples=1,
              image_resolution=64, ddim_steps=2, seed=42, eta=0.0,
              x_T=slice_inputs["x_T"])
    ref = jax_pipe.process(slice_inputs["image"], "a bird", **kw)
    out = port_pipe.process(slice_inputs["image"], "a bird", **kw)
    assert np.array_equal(out[0], ref[0])  # the same Canny hint
    assert out[1].shape == ref[1].shape == (64, 64, 3)
    assert out[1].dtype == np.uint8
    assert np.abs(out[1].astype(int) - ref[1].astype(int)).max() <= 1

    # latents: the JAX runtime's DDIM on the same contexts and hint
    rt = jax_pipe.runtime
    ids = toy_tokenizer(max_length=CFG.clip.max_length)(
        ["a bird, " + A_PROMPT, N_PROMPT])
    ctx = rt.encode_prompt(ids)
    hint = jnp.asarray(out[0][None])
    z_ref = np.asarray(rt.sample(2, jnp.asarray(slice_inputs["x_T"]), hint,
                                 ctx[0:1], ctx[1:2], jnp.asarray([0, 0], jnp.uint32)))
    z = port_pipe.last_latents.numpy()
    assert np.abs(z - z_ref).max() <= 1e-3


def test_ddim_eta_noise_matches_jax(pipes, slice_inputs):
    """eta > 0: the port's DDIM given the JAX sampler's own per-step noise
    (_step_noise of the same key) reproduces its latents."""
    import jax

    from stablediffusioneo_tpu.pipeline.ddim import _step_noise

    jax_pipe, port_pipe = pipes
    rng = np.random.default_rng(5)
    ctx = rng.standard_normal((2, CFG.clip.max_length, CFG.unet.context_dim),
                              dtype=np.float32)
    hint = (rng.random((1, 64, 64, 3)) > 0.7).astype(np.uint8) * 255
    x_T = slice_inputs["x_T"]
    key = jax.random.PRNGKey(7)
    z_ref = np.asarray(jax_pipe.runtime.sample(
        3, jnp.asarray(x_T), jnp.asarray(hint), jnp.asarray(ctx[:1]),
        jnp.asarray(ctx[1:]), key, eta=0.5))
    noise = [torch.from_numpy(np.asarray(_step_noise(key, jnp.int32(i), x_T.shape)))
             for i in range(3)]
    z = port_pipe.runtime.sample(
        3, torch.from_numpy(x_T), torch.from_numpy(hint), torch.from_numpy(ctx[:1]),
        torch.from_numpy(ctx[1:]), eta=0.5, noise=noise).numpy()
    assert np.abs(z - z_ref).max() <= 1e-3


def test_guess_mode_matches_jax(pipes, slice_inputs):
    jax_pipe, port_pipe = pipes
    kw = dict(num_samples=1, image_resolution=64, ddim_steps=2, seed=1,
              eta=0.0, x_T=slice_inputs["x_T"], guess_mode=True, strength=0.7)
    ref = jax_pipe.process(slice_inputs["image"], "a cat", **kw)
    out = port_pipe.process(slice_inputs["image"], "a cat", **kw)
    assert np.abs(out[1].astype(int) - ref[1].astype(int)).max() <= 1


@pytest.mark.parametrize("kwargs", [
    {"sampler": "dpmpp", "inpaint_mask": np.full((64, 64), 255, np.uint8)},
    {"sampler": "plms", "eta": 0.5}])
def test_features_outside_the_slice_raise(pipes, slice_inputs, kwargs):
    """The JAX package's guards on the samplers, in its error type and words:
    inpainting is a DDIM-path feature, and PLMS takes eta 0 only. process()
    refuses both before any work: no engine is built."""
    match = {"dpmpp": "inpainting is a DDIM-path feature",
             "plms": "PLMS requires eta == 0"}[kwargs["sampler"]]
    if "inpaint_mask" in kwargs:
        kwargs = dict(kwargs, inpaint_image=slice_inputs["image"])
    rt = pipes[1].runtime
    engines = dict(rt._engines)
    with pytest.raises(ValueError, match=match):
        pipes[1].process(slice_inputs["image"], "a bird", image_resolution=64,
                         ddim_steps=1, **kwargs)
    assert rt._engines == engines


@pytest.mark.parametrize("kwargs,match", [
    ({"hires_upscale": 2.0}, "img2img .* is a DDIM-path feature"),
    ({"init_image": np.zeros((64, 64, 3), np.uint8)}, "img2img .* is a DDIM-path feature"),
    ({"encoder_cache_interval": 2}, "encoder_cache_interval is a DDIM-path feature"),
    ({"sampler": "lms"}, "unknown sampler 'lms'"),
], ids=["hires", "img2img", "encoder_cache", "unknown"])
def test_ddim_path_features_refuse_other_samplers(pipes, slice_inputs, kwargs, match):
    """The JAX package's refusals of what only its DDIM path does, raised by
    process() before any work (the JAX package raises the same words when it
    reaches the engine)."""
    kwargs = {"sampler": "euler", **kwargs}
    rt = pipes[1].runtime
    engines = dict(rt._engines)
    with pytest.raises(ValueError, match=match):
        pipes[1].process(slice_inputs["image"], "a bird", image_resolution=64,
                         ddim_steps=2, **kwargs)
    assert rt._engines == engines


def test_reference_defaults_are_accepted_by_name(pipes, slice_inputs):
    """Four arguments of the reference's process() beyond the first slice, at
    the reference's defaults, change nothing; the map is kept as the
    reference keeps it."""
    import inspect

    ref = inspect.signature(JaxPipeline.process).parameters
    port = inspect.signature(Canny2ImagePipeline.process).parameters
    for name in ("encoder_cache_interval", "granular_timings",
                 "denoise_strength", "cfg_rescale"):
        assert port[name].default == ref[name].default
    kw = dict(image_resolution=64, ddim_steps=1, seed=3, x_T=slice_inputs["x_T"])
    base = pipes[1].process(slice_inputs["image"], "a bird", **kw)
    out = pipes[1].process(slice_inputs["image"], "a bird", encoder_cache_interval=1,
                           granular_timings=False, denoise_strength=0.75,
                           cfg_rescale=0.0, **kw)
    assert np.array_equal(out[1], base[1])


# ------------------------------------------------- the rest of the loop
# Tolerances are those of the fp32 loop tests above: latents within 1e-3,
# uint8 images within 1, both packages in fp32 on the CPU; the update-level
# cases (no network in between) within 1e-6.


def _loop_inputs(steps, seed=5):
    rng = np.random.default_rng(seed)
    ctx = rng.standard_normal((2, CFG.clip.max_length, CFG.unet.context_dim),
                              dtype=np.float32)
    hint = (rng.random((1, 64, 64, 3)) > 0.7).astype(np.uint8) * 255
    x_T = rng.standard_normal((1, 8, 8, 4), dtype=np.float32)
    return ctx, hint, x_T


@pytest.mark.parametrize("scale", [7.5, [9.0, 3.0]])
def test_cfg_combine_rescale_matches_jax(scale):
    from stablediffusioneo_tpu.pipeline.ddim import _cfg_combine as jax_combine
    from stablediffusioneo_tpu_torch.pipeline.ddim import _cfg_combine

    rng = np.random.default_rng(2)
    e_c, e_u = (rng.standard_normal((2, 8, 8, 4), dtype=np.float32) for _ in range(2))
    s = np.asarray(scale, np.float32)
    ref = np.asarray(jax_combine(jnp.asarray(e_c), jnp.asarray(e_u), jnp.asarray(s),
                                 jnp.asarray(e_c), 0.7))
    out = _cfg_combine(torch.from_numpy(e_c), torch.from_numpy(e_u),
                       torch.from_numpy(s) if s.ndim else float(s), 0.7).numpy()
    assert np.abs(out - ref).max() <= 1e-5
    plain = _cfg_combine(torch.from_numpy(e_c), torch.from_numpy(e_u),
                         torch.from_numpy(s) if s.ndim else float(s), 0.0).numpy()
    assert np.abs(plain - out).max() > 1e-2  # the rescale does something
    assert np.abs(plain - np.asarray(jax_combine(
        jnp.asarray(e_c), jnp.asarray(e_u), jnp.asarray(s), jnp.asarray(e_c),
        0.0))).max() <= 1e-6


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_v_update_matches_jax(eta):
    """ddim_update(parameterization="v") against the JAX `_ddim_update` on the
    same x, v-prediction and step noise, three chained fp32 steps."""
    import jax

    from stablediffusioneo_tpu.pipeline.ddim import _ddim_update, _step_noise
    from stablediffusioneo_tpu_torch.ops.schedule import DiffusionSchedule
    from stablediffusioneo_tpu_torch.pipeline.ddim import ddim_update

    d = CFG.diffusion
    sched = DiffusionSchedule(d.timesteps, d.linear_start, d.linear_end,
                              d.schedule).ddim(3, eta=eta)
    rng = np.random.default_rng(13)
    shape = (2, 8, 8, 4)
    x = rng.standard_normal(shape, dtype=np.float32)
    key = jax.random.PRNGKey(3)
    apart = 0.0
    for i in range(3):
        v = rng.standard_normal(shape, dtype=np.float32)
        noise = np.asarray(_step_noise(key, jnp.int32(i), shape)).copy()
        per_step = tuple(jnp.float32(sched[k][i]) for k in (
            "timesteps", "alphas", "alphas_prev", "sigmas",
            "sqrt_one_minus_alphas")) + (jnp.int32(i),)
        ref = np.asarray(_ddim_update(jnp.asarray(x), jnp.asarray(v), per_step,
                                      key, 1.0, "v"))
        out = ddim_update(torch.from_numpy(x), torch.from_numpy(v), sched, i,
                          torch.from_numpy(noise), parameterization="v").numpy()
        eps = ddim_update(torch.from_numpy(x), torch.from_numpy(v), sched, i,
                          torch.from_numpy(noise)).numpy()
        assert np.abs(out - ref).max() <= 1e-6
        apart = max(apart, float(np.abs(out - eps).max()))
        x = ref
    assert apart > 1e-1  # not the eps update (the two meet as a_t nears 0 or 1)


@pytest.mark.parametrize("interval,steps", [(2, 5), (3, 6)])
def test_encoder_cached_loop_matches_jax(pipes, interval, steps):
    """The encoder-cached loop against ddim_sample_scan(encoder_cache_interval=):
    at (2, 5) step 1 runs on the cache, at (3, 6) steps 1 and 2."""
    import jax

    jax_pipe, port_pipe = pipes
    ctx, hint, x_T = _loop_inputs(steps)
    z_ref = np.asarray(jax_pipe.runtime.sample(
        steps, jnp.asarray(x_T), jnp.asarray(hint), jnp.asarray(ctx[:1]),
        jnp.asarray(ctx[1:]), jax.random.PRNGKey(0),
        encoder_cache_interval=interval))
    args = (steps, torch.from_numpy(x_T), torch.from_numpy(hint),
            torch.from_numpy(ctx[:1]), torch.from_numpy(ctx[1:]))
    z = port_pipe.runtime.sample(*args, encoder_cache_interval=interval).numpy()
    assert np.abs(z - z_ref).max() <= 1e-3
    full = port_pipe.runtime.sample(*args).numpy()
    assert np.abs(z - full).max() > 1e-3  # the cache changes the result


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_inpaint_blend_matches_jax(pipes, eta):
    """Blended-latent inpainting against ddim_sample_scan(inpaint_latent=,
    inpaint_mask=): the kept region's per-step noise is the JAX loop's own
    (_step_noise of fold_in(key, 0x1B9A1)), computed here and injected."""
    import jax

    from stablediffusioneo_tpu.pipeline.ddim import _step_noise, ddim_sample_scan

    jax_pipe, port_pipe = pipes
    steps = 3
    ctx, hint, x_T = _loop_inputs(steps, seed=9)
    rng = np.random.default_rng(4)
    ilat = rng.standard_normal(x_T.shape, dtype=np.float32)
    mask = (rng.random((1, 8, 8, 1)) > 0.5).astype(np.float32)
    key = jax.random.PRNGKey(11)
    rt = jax_pipe.runtime
    sched = rt.schedule.ddim(steps, eta=eta)
    z_ref = np.asarray(jax.jit(lambda: ddim_sample_scan(
        rt.params["unet"], rt.params["controlnet"], CFG.controlnet, sched,
        jnp.asarray(x_T), jnp.asarray(hint, jnp.float32) / 255.0,
        jnp.asarray(ctx[:1]), jnp.asarray(ctx[1:]), jnp.asarray([9.0], jnp.float32),
        jnp.ones((1, 13), jnp.float32), key, inpaint_latent=jnp.asarray(ilat),
        inpaint_mask=jnp.asarray(mask)))())
    ikey = jax.random.fold_in(key, 0x1B9A1)
    draws = lambda k: [torch.from_numpy(np.asarray(
        _step_noise(k, jnp.int32(i), x_T.shape)).copy()) for i in range(steps)]
    z = port_pipe.runtime.sample(
        steps, torch.from_numpy(x_T), torch.from_numpy(hint),
        torch.from_numpy(ctx[:1]), torch.from_numpy(ctx[1:]), eta=eta,
        noise=draws(key), inpaint_latent=torch.from_numpy(ilat),
        inpaint_mask=torch.from_numpy(mask), inpaint_noise=draws(ikey)).numpy()
    assert np.abs(z - z_ref).max() <= 1e-3
    kept = np.broadcast_to(mask == 0, z.shape)
    assert np.array_equal(z[kept], ilat[kept])  # the clean original, blended back
    # mask of ones: plain sampling, to the bit
    ones = port_pipe.runtime.sample(
        steps, torch.from_numpy(x_T), torch.from_numpy(hint),
        torch.from_numpy(ctx[:1]), torch.from_numpy(ctx[1:]), eta=eta,
        noise=draws(key), inpaint_latent=torch.from_numpy(ilat),
        inpaint_mask=torch.ones((1, 8, 8, 1)), inpaint_noise=draws(ikey))
    plain = port_pipe.runtime.sample(
        steps, torch.from_numpy(x_T), torch.from_numpy(hint),
        torch.from_numpy(ctx[:1]), torch.from_numpy(ctx[1:]), eta=eta,
        noise=draws(key))
    assert torch.equal(ones, plain)


def test_inpaint_with_encoder_caching_raises(pipes):
    ctx, hint, x_T = _loop_inputs(2)
    with pytest.raises(ValueError, match="inpainting \\+ encoder caching"):
        pipes[1].runtime.sample(
            2, torch.from_numpy(x_T), torch.from_numpy(hint),
            torch.from_numpy(ctx[:1]), torch.from_numpy(ctx[1:]),
            inpaint_latent=torch.zeros(x_T.shape),
            inpaint_mask=torch.ones((1, 8, 8, 1)), encoder_cache_interval=2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stochastic_encode_matches_jax(dtype):
    import jax

    from stablediffusioneo_tpu.pipeline.ddim import stochastic_encode as jax_encode
    from stablediffusioneo_tpu_torch.pipeline.ddim import stochastic_encode

    rng = np.random.default_rng(6)
    x0, noise = (rng.standard_normal((2, 8, 8, 4), dtype=np.float32) for _ in range(2))
    ref = jax_encode(jnp.asarray(x0, dtype), 0.37, jax.random.PRNGKey(0),
                     noise=jnp.asarray(noise, dtype))
    out = stochastic_encode(torch.from_numpy(x0).to(getattr(torch, dtype)), 0.37,
                            torch.from_numpy(noise).to(getattr(torch, dtype)))
    assert out.dtype == getattr(torch, dtype)
    ref = np.asarray(ref.astype(jnp.float32))
    # fp32: the two differ in the last bit of the products; bf16: one ulp
    # where the fp32 results straddle a rounding boundary
    tol = 1e-6 if dtype == "float32" else _bf16_ulp(ref)
    assert np.abs(out.float().numpy() - ref).max() <= tol
    drawn = stochastic_encode(torch.from_numpy(x0), 0.37,
                              generator=torch.Generator().manual_seed(1))
    assert drawn.shape == x0.shape and not torch.equal(drawn, out.float())


def test_ddim_sampler_class_matches_jax(pipes):
    """DDIMSampler.control_scales, .sample on a given x_T and .img2img on a
    given init latent and re-noise against the JAX class."""
    import jax

    from stablediffusioneo_tpu.pipeline.ddim import DDIMSampler as JaxSampler
    from stablediffusioneo_tpu_torch.pipeline.ddim import DDIMSampler

    jax_pipe, port_pipe = pipes
    rt = jax_pipe.runtime
    ref_sampler = JaxSampler(CFG, rt.params["unet"], rt.params["controlnet"])
    model = port_pipe.runtime.model
    sampler = DDIMSampler(PORT_CFG, model.unet, model.control_model)
    for strength, guess in ((1.0, False), (0.7, True)):
        np.testing.assert_allclose(sampler.control_scales(strength, guess),
                                   ref_sampler.control_scales(strength, guess),
                                   rtol=1e-6)
    ctx, hint, x_T = _loop_inputs(2)
    hint_f = hint.astype(np.float32) / 255.0
    key = jax.random.PRNGKey(5)
    z_ref = np.asarray(ref_sampler.sample(
        2, x_T.shape, jnp.asarray(hint_f), jnp.asarray(ctx[:1]), jnp.asarray(ctx[1:]),
        key, guidance_scale=7.0, strength=0.8, x_T=jnp.asarray(x_T)))
    t = torch.from_numpy
    z = sampler.sample(2, x_T.shape, t(hint_f), t(ctx[:1]), t(ctx[1:]),
                       guidance_scale=7.0, strength=0.8, x_T=t(x_T)).numpy()
    assert np.abs(z - z_ref).max() <= 1e-3
    drawn = sampler.sample(2, x_T.shape, t(hint_f), t(ctx[:1]), t(ctx[1:]),
                           generator=torch.Generator().manual_seed(0))
    assert drawn.shape == x_T.shape and torch.isfinite(drawn).all()
    # img2img: the JAX class draws its re-noise from split(key)[1]
    z0 = np.random.default_rng(8).standard_normal(x_T.shape, dtype=np.float32)
    renoise = np.asarray(jax.random.normal(jax.random.split(key)[1], x_T.shape,
                                           jnp.float32)).copy()
    i_ref = np.asarray(ref_sampler.img2img(
        jnp.asarray(z0), 0.5, 4, jnp.asarray(hint_f), jnp.asarray(ctx[:1]),
        jnp.asarray(ctx[1:]), key))
    i_out = sampler.img2img(t(z0), 0.5, 4, t(hint_f), t(ctx[:1]), t(ctx[1:]),
                            renoise=t(renoise)).numpy()
    assert np.abs(i_out - i_ref).max() <= 1e-3


@pytest.mark.parametrize("kwargs", [{"encoder_cache_interval": 2},
                                    {"cfg_rescale": 0.7}],
                         ids=["encoder_cache_interval", "cfg_rescale"])
def test_process_loop_variants_match_jax(pipes, slice_inputs, kwargs):
    jax_pipe, port_pipe = pipes
    kw = dict(a_prompt=A_PROMPT, n_prompt=N_PROMPT, num_samples=1,
              image_resolution=64, ddim_steps=4, seed=42, eta=0.0,
              x_T=slice_inputs["x_T"])
    ref = jax_pipe.process(slice_inputs["image"], "a bird", **kw, **kwargs)
    out = port_pipe.process(slice_inputs["image"], "a bird", **kw, **kwargs)
    assert np.abs(out[1].astype(int) - ref[1].astype(int)).max() <= 1
    base = port_pipe.process(slice_inputs["image"], "a bird", **kw)
    assert not np.array_equal(base[1], out[1])


def test_granular_timings_match_jax_keys(pipes, slice_inputs):
    jax_pipe, port_pipe = pipes
    kw = dict(image_resolution=64, ddim_steps=1, seed=3, x_T=slice_inputs["x_T"])
    jax_pipe.process(slice_inputs["image"], "a bird", granular_timings=True, **kw)
    out = port_pipe.process(slice_inputs["image"], "a bird", granular_timings=True, **kw)
    assert list(port_pipe.last_timings) == list(jax_pipe.last_timings)
    assert {"sample_ms", "decode_ms", "fetch_ms"} <= set(port_pipe.last_timings)
    fused = port_pipe.process(slice_inputs["image"], "a bird", **kw)
    assert np.array_equal(out[1], fused[1])  # two engines or one: equal bytes
    assert "sample_decode_fetch_ms" in port_pipe.last_timings


def test_process_sets_last_detected_maps(slice_inputs):
    params = tiny_params()
    tok = toy_tokenizer(max_length=CFG.clip.max_length)
    pipe = Canny2ImagePipeline(port_model(params), tok, PORT_CFG, device="cpu")
    assert pipe.last_detected_maps == []
    out = pipe.process(slice_inputs["image"], "a bird", image_resolution=64,
                       ddim_steps=1, seed=3)
    assert len(pipe.last_detected_maps) == 1
    assert np.array_equal(pipe.last_detected_maps[0], out[0])
    # the hires branch returns the high-resolution map and, as the
    # reference, leaves the base-resolution one here
    hi = pipe.process(slice_inputs["image"], "a bird", image_resolution=64,
                      ddim_steps=2, seed=3, hires_upscale=2.0)
    assert hi[0].shape == (128, 128, 3)
    assert pipe.last_detected_maps[0].shape == (64, 64, 3)


def test_runtime_warmup_and_release(pipes):
    rt = pipes[1].runtime
    assert rt.warmup(resolution=64, num_steps=1) == (1, 64, 64, 3)
    model = rt.model
    rt.release()
    with pytest.raises(RuntimeError, match="released"):
        rt.encode_prompt(np.zeros((1, CFG.clip.max_length), np.int64))
    rt.model = model  # the module-scoped pipeline stays usable


# ------------------------------------------------------------- bf16 carry


def _bf16_exact(a: np.ndarray) -> bool:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return torch.equal(t.to(torch.bfloat16).float(), t)


def _bf16_ulp(a: np.ndarray) -> float:
    """One bf16 ulp at max |a| (8 significant bits)."""
    return float(2.0 ** (np.floor(np.log2(np.abs(a).max())) - 7))


@pytest.fixture(scope="module")
def bf16_runtimes():
    """Both runtimes in bf16 on the same weights (each casts its own copy)."""
    from stablediffusioneo_tpu.runtime.engine import CNSDRuntime as JaxRuntime
    from stablediffusioneo_tpu_torch.runtime.engine import CNSDRuntime

    params = tiny_params()
    jax_rt = JaxRuntime(params, dataclasses.replace(CFG, dtype="bfloat16"),
                        persistent_cache=False)
    port_rt = CNSDRuntime(port_model(params),
                          dataclasses.replace(PORT_CFG, dtype="bfloat16"),
                          device="cpu")
    return jax_rt, port_rt


def test_ddim_update_rounds_as_the_jax_scan_step():
    """The carry alone, with no network between the packages: three chained
    updates on the same bf16 x, bf16 predictions and step noise. The JAX
    update (`_ddim_update`: fp32 arithmetic, noise added, one rounding to
    x's dtype) and the port's `ddim_update` give equal bf16 values (at most
    one bf16 ulp apart where the two fp32 results, which differ in the last
    bit by the order of the constants' products, straddle a rounding
    boundary), and every value the port carries is a bf16 value."""
    import jax

    from stablediffusioneo_tpu.ops.schedule import DiffusionSchedule as JaxSchedule
    from stablediffusioneo_tpu.pipeline.ddim import _ddim_update, _step_noise
    from stablediffusioneo_tpu_torch.ops.schedule import DiffusionSchedule
    from stablediffusioneo_tpu_torch.pipeline.ddim import ddim_update

    d = CFG.diffusion
    sched = DiffusionSchedule(d.timesteps, d.linear_start, d.linear_end,
                              d.schedule).ddim(3, eta=0.5)
    ref_sched = JaxSchedule(d.timesteps, d.linear_start, d.linear_end,
                            d.schedule).ddim(3, eta=0.5)
    rng = np.random.default_rng(11)
    shape = (2, 8, 8, 4)
    x0 = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(torch.bfloat16)
    eps = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(torch.bfloat16)
           for _ in range(3)]
    key = jax.random.PRNGKey(3)
    x = x0
    x_ref = jnp.asarray(x0.float().numpy()).astype(jnp.bfloat16)
    for i in range(3):
        noise = np.asarray(_step_noise(key, jnp.int32(i), shape))
        x = ddim_update(x, eps[i], sched, i, torch.from_numpy(noise.copy()))
        per_step = tuple(jnp.float32(ref_sched[k][i]) for k in (
            "timesteps", "alphas", "alphas_prev", "sigmas",
            "sqrt_one_minus_alphas")) + (jnp.int32(i),)
        x_ref = _ddim_update(x_ref, jnp.asarray(eps[i].float().numpy()).astype(jnp.bfloat16),
                             per_step, key, 1.0, "eps")
        assert x.dtype == torch.bfloat16 and x_ref.dtype == jnp.bfloat16
        got, want = x.float().numpy(), np.asarray(x_ref.astype(jnp.float32))
        assert np.abs(got - want).max() <= _bf16_ulp(want)
        assert (got != want).mean() <= 0.02
        x_ref = jnp.asarray(got).astype(jnp.bfloat16)  # chain from equal values
    # an fp32 carry of the same chain is not a bf16 value after one step
    xf = ddim_update(x0.float(), eps[0].float(), sched, 0,
                     torch.from_numpy(np.asarray(_step_noise(key, jnp.int32(0), shape)).copy()))
    assert xf.dtype == torch.float32 and not _bf16_exact(xf.numpy())


@pytest.mark.parametrize("eta,scale,ulps", [(0.0, 1.0, 4), (0.5, 1.0, 4), (0.0, 9.0, 24)])
def test_bf16_loop_matches_jax(bf16_runtimes, slice_inputs, eta, scale, ulps):
    """Three bf16 DDIM steps through both packages' networks and loops on
    the same x_T, contexts, hint and (eta > 0) the JAX sampler's step noise.

    Tolerance, in bf16 ulps of max |z|: with guidance scale 1 the runs
    measured 1.5 (eta 0) and 1.25 (eta 0.5) ulps, held to 4; 2 was too
    tight a margin for sums whose order the CPU libraries may change. With
    the default scale 9 the guided prediction multiplies the two packages'
    bf16 disagreement inside the (untrained, tiny) networks ninefold: 9.5
    ulps measured, held to 24. What the networks blur the update-level test
    above holds exactly; what this test adds is that the port's latents are
    bf16 values after the whole loop, which an fp32 carry's are not."""
    import jax

    from stablediffusioneo_tpu.pipeline.ddim import _step_noise

    jax_rt, port_rt = bf16_runtimes
    rng = np.random.default_rng(5)
    ctx = rng.standard_normal((2, CFG.clip.max_length, CFG.unet.context_dim),
                              dtype=np.float32)
    hint = (rng.random((1, 64, 64, 3)) > 0.7).astype(np.uint8) * 255
    x_T = slice_inputs["x_T"]
    key = jax.random.PRNGKey(7)
    z_ref = jax_rt.sample(3, jnp.asarray(x_T), jnp.asarray(hint), jnp.asarray(ctx[:1]),
                          jnp.asarray(ctx[1:]), key, guidance_scale=scale, eta=eta)
    assert z_ref.dtype == jnp.bfloat16  # the reference carries and returns bf16
    z_ref = np.asarray(z_ref.astype(jnp.float32))
    noise = [torch.from_numpy(np.asarray(_step_noise(key, jnp.int32(i), x_T.shape)).copy())
             for i in range(3)]
    z = port_rt.sample(3, torch.from_numpy(x_T), torch.from_numpy(hint),
                       torch.from_numpy(ctx[:1]), torch.from_numpy(ctx[1:]),
                       guidance_scale=scale, eta=eta, noise=noise)
    assert z.dtype == torch.float32  # the bf16 values, widened
    z = z.numpy()
    assert _bf16_exact(z)
    assert np.abs(z - z_ref).max() <= ulps * _bf16_ulp(z_ref)


def test_port_runs_without_jax():
    """With jax made unimportable, the port imports and runs the tiny
    process() end to end on seeded weights."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import numpy as np, torch
        from stablediffusioneo_tpu_torch.config import tiny_pipeline
        from stablediffusioneo_tpu_torch.models.cldm import ControlLDM, init_weights
        from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline
        cfg = tiny_pipeline()
        model = ControlLDM(cfg)
        init_weights(model, torch.Generator().manual_seed(0))
        def tok(texts):
            rows = [[998] + [sum(map(ord, w)) % 990 for w in t.split()][:14]
                    for t in texts]
            return np.array([(r + [999] * 16)[:16] for r in rows])
        pipe = Canny2ImagePipeline(model, tok, cfg, device="cpu")
        img = (np.random.default_rng(0).random((64, 64, 3)) * 255).astype(np.uint8)
        out = pipe.process(img, "a bird", image_resolution=64, ddim_steps=2, seed=3)
        assert out[1].shape == (64, 64, 3) and out[1].dtype == np.uint8
        assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
                       if sys.modules[m] is not None)
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("OK")
