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


def numpy_params(init_fn, cfg, seed):
    """A JAX parameter tree of init_fn(key, cfg)'s structure, its leaves drawn
    with numpy (the JAX initialisers, op by op or jitted, take most of a
    minute at the SD-2.x and SDXL test widths): weights ("w") N(0, 1 /
    fan_in) over all but their last axis, biases ("b") N(0, 0.01), norm
    gains ("g") 1 + N(0, 0.01), anything else (embeddings, text
    projections) N(0, 0.0004); no leaf is zero."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: init_fn(k, cfg), jax.random.PRNGKey(0))

    def draw(path, leaf):
        name = getattr(path[-1], "key", None)
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "w":
            return z * float(np.prod(leaf.shape[:-1])) ** -0.5
        if name == "g":
            return 1.0 + 0.1 * z
        return (0.1 if name == "b" else 0.02) * z

    return jax.tree_util.tree_map_with_path(draw, shapes)


# ------------------------------------------------ annotator weights by name

# the universe of each annotator's upstream file (DPT-L has none), and of
# the FID Inception's (YOLOv5 has none)
UNIVERSES = {"hed": "hed", "dpt_hybrid": "dpt_hybrid", "openpose_body": "openpose_body",
             "openpose_hand": "openpose_hand", "mlsd_large": "mlsd_large",
             "uniformer": "uniformer", "inception": "pt_inception"}


def draw_upstream(rng, name, shape):
    """A seeded weight of an upstream-named tensor: conv / linear weights
    N(0, 1 / fan_in), norm gains 1 + N(0, 0.01), the rest 0.1 N(0, 1)."""
    z = rng.standard_normal(shape).astype(np.float32)
    if name.endswith(".weight") and len(shape) >= 2:
        return z * np.float32(np.prod(shape[1:]) ** -0.5)
    if name.endswith(".weight") and "norm" in name:
        return np.float32(1.0) + np.float32(0.1) * z
    return np.float32(0.1) * z


def with_batch_norms(sd, rng):
    """Seeded BatchNorm statistics where `sd` has BatchNorms (a
    `.running_var` key): gains 1 + N(0, 0.01), means 0.1 N(0, 1), variances
    U(0.5, 1.5), counters 0; drawn after the other tensors, so that a state
    dict without BatchNorms keeps its draws."""
    for name in sorted(k[:-len(".running_var")] for k in sd if k.endswith(".running_var")):
        c = sd[f"{name}.running_var"].shape
        sd[f"{name}.weight"] = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
        sd[f"{name}.running_mean"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
        sd[f"{name}.running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        if f"{name}.num_batches_tracked" in sd:
            sd[f"{name}.num_batches_tracked"] = np.zeros((), np.int64)
    return sd


def universe_sd(kind, seed=0):
    """{name: array} with exactly the names and shapes of the universe file
    of `kind` (the port's packaged copy, stablediffusioneo_tpu_torch/
    checkpoint/universes/, held to the JAX package's byte for byte by
    tests/test_torch_imports.py): float32, a BatchNorm's num_batches_tracked
    (a scalar) int64."""
    from stablediffusioneo_tpu_torch.checkpoint.manifest import load_universe

    rng = np.random.default_rng(seed)
    sd = {k: draw_upstream(rng, k, tuple(int(d) for d in s.split("x") if d))
          for k, s in sorted(load_universe(UNIVERSES[kind]).items())}
    return with_batch_norms(sd, rng)


# ------------------------------------------------ training: the two nets


def tiny_control_nets(seed=0):
    """The tiny UNet and ControlNet as JAX trees drawn by numpy_params (no
    leaf zero, so the ControlNet's taps carry a gradient) and as the port's
    networks loaded with the same weights, fp32, frozen:
    {"unet": (tree, net), "controlnet": (tree, net)}."""
    from stablediffusioneo_tpu_torch.checkpoint import accounting
    from stablediffusioneo_tpu_torch.checkpoint.convert import tree_state_dict
    from stablediffusioneo_tpu_torch.models.controlnet import ControlNet
    from stablediffusioneo_tpu_torch.models.unet import UNetModel

    out = {}
    for i, (kind, init_fn, jcfg, make) in enumerate((
            ("unet", init_unet, CFG.unet, lambda: UNetModel(PORT_CFG.unet)),
            ("controlnet", init_controlnet, CFG.controlnet,
             lambda: ControlNet(PORT_CFG.controlnet)))):
        tree = numpy_params(init_fn, jcfg, seed + i)
        sd = {}
        tree_state_dict(sd, kind, PORT_CFG.unet, tree)
        net = make()
        accounting.account_checkpoint(net, sd).assert_complete(kind)
        accounting.copy_checkpoint_(net, sd)
        out[kind] = (tree, net.eval().requires_grad_(False))
    return out


def port_names(kind, jax_tree):
    """{port parameter name: fp32 tensor} of a JAX tree of `kind` (weights,
    or gradients: the map is linear), by checkpoint/convert.py's map."""
    from stablediffusioneo_tpu_torch.checkpoint.convert import tree_state_dict

    sd = {}
    tree_state_dict(sd, kind, PORT_CFG.unet, jax_tree)
    return sd


def assert_trees_close(got, want, tol):
    """Every tensor of `want` ({name: tensor}) against `got`'s tensor of
    that name: max |d| <= tol x max |want| of that tensor."""
    assert set(got) == set(want)
    for name, ref in want.items():
        ref = np.asarray(ref, np.float64)
        out = np.asarray(got[name].detach().float().cpu(), np.float64)
        scale = max(np.abs(ref).max(), 1e-30)
        err = np.abs(out - ref).max()
        assert err <= tol * scale, f"{name}: max |d| {err:.3g} > {tol} x {scale:.3g}"
