"""Shared set-up of the PyTorch port's parity tests: one set of seeded tiny
JAX parameters, and the port's ControlLDM loaded with the same weights
through checkpoint/convert.py's inverse. Each package gets its own
configuration object, built from the same numbers: CFG goes to the JAX
package, PORT_CFG to the port."""

import jax
import numpy as np
import torch

from stablediffusioneo_tpu.config import tiny_pipeline
from stablediffusioneo_tpu.models import (
    init_clip_text,
    init_controlnet,
    init_unet,
    init_vae,
)
from stablediffusioneo_tpu_torch import config as port_config
from stablediffusioneo_tpu_torch.checkpoint.convert import state_dict_from_jax
from stablediffusioneo_tpu_torch.models.cldm import ControlLDM

CFG = tiny_pipeline()
PORT_CFG = port_config.tiny_pipeline()

# One intra-op thread for torch in the test processes. pytest-xdist runs the
# suite in six workers on eight cores; with torch's default of a thread per
# core the tiny networks' ops spend their time synchronising oversubscribed
# threads: on an eight-core CPU, six port test files in six workers took
# 679 s with the default and 158 s with one thread each (results within the
# tests' tolerances).
torch.set_num_threads(1)


def denonzero(tree, key):
    """Perturb every all-zero leaf (zero-initialised convs), as
    tests/test_pipeline.py does, so the control path is exercised."""
    leaves, treedef = jax.tree.flatten(tree)
    keys = jax.random.split(key, len(leaves))
    out = [l + 0.05 * jax.random.normal(k, l.shape, l.dtype)
           if bool((l == 0).all()) else l for l, k in zip(leaves, keys)]
    return jax.tree.unflatten(treedef, out)


def tiny_params():
    ks = jax.random.split(jax.random.PRNGKey(0), 6)
    return {
        "unet": denonzero(init_unet(ks[0], CFG.unet), ks[4]),
        "controlnet": denonzero(init_controlnet(ks[1], CFG.controlnet), ks[5]),
        "vae": init_vae(ks[2], CFG.vae),
        "clip": init_clip_text(ks[3], CFG.clip),
    }


def port_model(params) -> ControlLDM:
    model = ControlLDM(PORT_CFG)
    model.load_checkpoint(state_dict_from_jax(params, PORT_CFG))
    return model.eval().requires_grad_(False)


def assert_close_scaled(out, ref, tol=1e-4):
    """max |out - ref| <= tol * max |ref|."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-12)
    err = np.abs(out - ref).max()
    assert err <= tol * scale, f"max |d| {err:.3g} > {tol} x {scale:.3g}"


# ------------------------------------------------ sampler loops vs JAX scans


def schedules():
    """The port's and the JAX package's DDPM schedule of CFG."""
    from stablediffusioneo_tpu.ops.schedule import DiffusionSchedule as JaxSchedule
    from stablediffusioneo_tpu_torch.ops.schedule import DiffusionSchedule

    d = CFG.diffusion
    return (DiffusionSchedule(d.timesteps, d.linear_start, d.linear_end, d.schedule),
            JaxSchedule(d.timesteps, d.linear_start, d.linear_end, d.schedule))


def n_taps():
    from stablediffusioneo_tpu.models.unet import encoder_plan

    return len(encoder_plan(CFG.unet)) + 1


def sampler_inputs(seed=5):
    """x_T (1, 8, 8, 4), a {0, 1} hint (1, 64, 64, 3) and the cond and
    uncond contexts, from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    ctx = rng.standard_normal((2, CFG.clip.max_length, CFG.unet.context_dim),
                              dtype=np.float32)
    return {"x_T": rng.standard_normal((1, 8, 8, 4), dtype=np.float32),
            "hint": (rng.random((1, 64, 64, 3)) > 0.7).astype(np.float32),
            "ctx_cond": ctx[:1], "ctx_uncond": ctx[1:]}


SAMPLER_SCALE, SAMPLER_STRENGTH = 7.5, 0.8
_JITTED = {}


def jitted_scan(scan, parameterization, **static):
    """One jax.jit of a JAX sampler scan for each parameterization (and
    further static arguments), shared by a test module: the schedule is an
    argument, so both spacings run through one program. The jitted function
    takes (unet params, controlnet params, schedule, x_T, hint, ctx_cond,
    ctx_uncond, *rest) with rest handed on before the keywords (the
    k-diffusion scan's key)."""
    import jax.numpy as jnp

    key = (scan.__name__, parameterization, tuple(sorted(static.items())))
    if key not in _JITTED:
        scales = [SAMPLER_STRENGTH] * n_taps()

        def run(unet_p, ctrl_p, sched, x_T, hint, ctx_c, ctx_u, *rest):
            return scan(unet_p, ctrl_p, CFG.controlnet, sched, x_T, hint, ctx_c,
                        ctx_u, jnp.float32(SAMPLER_SCALE), scales, *rest,
                        parameterization=parameterization, **static)

        _JITTED[key] = jax.jit(run)
    return _JITTED[key]


def run_sampler_pair(params, model, jitted, port_fn, sched, parameterization,
                     jax_rest=(), **port_kw):
    """(port latents, JAX latents) of the JAX scan (jitted_scan) and the
    port's loop on the same sampler_inputs()."""
    import jax.numpy as jnp
    import torch

    x = sampler_inputs()
    names = ("x_T", "hint", "ctx_cond", "ctx_uncond")
    ref = np.asarray(jitted(params["unet"], params["controlnet"],
                            {k: jnp.asarray(v) for k, v in sched.items()},
                            *(jnp.asarray(x[k]) for k in names), *jax_rest))
    out = port_fn(model.unet, model.control_model, sched,
                  *(torch.from_numpy(x[k]) for k in names), SAMPLER_SCALE,
                  [SAMPLER_STRENGTH] * n_taps(), parameterization=parameterization,
                  **port_kw).numpy()
    assert np.isfinite(out).all() and out.shape == ref.shape
    return out, ref
