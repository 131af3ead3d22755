"""Shared set-up of the PyTorch port's parity tests: one set of seeded tiny
JAX parameters, and the port's ControlLDM loaded with the same weights
through checkpoint/convert.py's inverse. Each package gets its own
configuration object, built from the same numbers: CFG goes to the JAX
package, PORT_CFG to the port."""

import jax
import numpy as np

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
