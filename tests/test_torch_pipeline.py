"""The PyTorch port's canny2image slice against the JAX package's, fp32 on
the CPU at tiny_pipeline() size: both run process() on the same weights,
image and x_T, 2 DDIM steps, eta 0."""

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

from torch_port_util import CFG, port_model, tiny_params

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
    port_pipe = Canny2ImagePipeline(port_model(params), tok, CFG, device="cpu")
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
    {"sampler": "dpmpp"}, {"long_prompt": True}, {"prompt_emphasis": True},
    {"hires_upscale": 2.0}, {"tome_ratio": 0.5},
    {"init_image": np.zeros((64, 64, 3), np.uint8)},
    {"inpaint_image": np.zeros((64, 64, 3), np.uint8),
     "inpaint_mask": np.zeros((64, 64), np.uint8)},
])
def test_features_outside_the_slice_raise(pipes, slice_inputs, kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pipes[1].process(slice_inputs["image"], "a bird", image_resolution=64,
                         ddim_steps=1, **kwargs)


def test_runtime_warmup_and_release(pipes):
    rt = pipes[1].runtime
    assert rt.warmup(resolution=64, num_steps=1) == (1, 64, 64, 3)
    model = rt.model
    rt.release()
    with pytest.raises(RuntimeError, match="released"):
        rt.encode_prompt(np.zeros((1, CFG.clip.max_length), np.int64))
    rt.model = model  # the module-scoped pipeline stays usable


def test_port_runs_without_jax():
    """With jax made unimportable, the port imports and runs the tiny
    process() end to end on seeded weights."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import numpy as np, torch
        from stablediffusioneo_tpu.config import tiny_pipeline
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
