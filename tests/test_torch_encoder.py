"""The port's VAE encoder, img2img and inpainting against the JAX package's,
fp32 on the CPU at tiny_pipeline() size: `Downsample` (the right-and-bottom
pad), `vae_encode`'s posterior, the runtime's `encode_image` in both modes,
and process(init_image=) / process(inpaint_image=, inpaint_mask=) end to end
with the JAX package's draws handed in.

Tolerances: tensors within 1e-4 x max |ref| (`assert_close_scaled`; the two
differ in summation order only); images within 1 uint8 LSB, as
tests/test_torch_pipeline.py holds the default path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablediffusioneo_tpu.models import vae as jax_vae
from stablediffusioneo_tpu.models.tokenizer import toy_tokenizer
from stablediffusioneo_tpu.pipeline.canny2image import (
    Canny2ImagePipeline as JaxPipeline,
)
from stablediffusioneo_tpu.pipeline.ddim import _step_noise
from stablediffusioneo_tpu_torch.models import vae as port_vae
from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline

from torch_port_util import CFG, PORT_CFG, assert_close_scaled, port_model, tiny_params


@pytest.fixture(scope="module")
def params():
    return tiny_params()


@pytest.fixture(scope="module")
def pipes(params):
    tok = toy_tokenizer(max_length=CFG.clip.max_length)
    return (JaxPipeline(params, tok, CFG, persistent_cache=False),
            Canny2ImagePipeline(port_model(params), tok, PORT_CFG, device="cpu"))


@pytest.mark.parametrize("h,w", [(8, 8), (9, 9), (7, 12), (16, 11)])
def test_downsample_matches_jax(rng, h, w):
    """Odd and even sides: the pad is one pixel on the right and bottom only,
    so the output is floor(side / 2) wherever the side is odd."""
    c = 6
    x = rng.standard_normal((2, h, w, c), dtype=np.float32)
    p = {"w": rng.standard_normal((3, 3, c, c), dtype=np.float32) * 0.2,
         "b": rng.standard_normal((c,), dtype=np.float32)}
    ref = np.asarray(jax_vae._downsample(p, jnp.asarray(x)))
    m = port_vae.Downsample(c)
    with torch.no_grad():
        m.conv.weight.copy_(torch.from_numpy(np.transpose(p["w"], (3, 2, 0, 1))))
        m.conv.bias.copy_(torch.from_numpy(p["b"]))
        out = m(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert out.shape == ref.shape == (2, h // 2, w // 2, c)
    assert_close_scaled(out.numpy(), ref)


@pytest.mark.parametrize("shape", [(2, 64, 64, 3), (1, 48, 80, 3)])
def test_vae_encode_matches_jax(params, pipes, rng, shape):
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    ref = jax_vae.vae_encode(params["vae"], CFG.vae, jnp.asarray(x))
    dist = port_vae.vae_encode(pipes[1].runtime.model.first_stage_model,
                               torch.from_numpy(x))
    f = CFG.vae.downsample_factor
    assert dist.mean.shape == (shape[0], shape[1] // f, shape[2] // f, 4)
    for name in ("mean", "logvar", "std"):
        assert_close_scaled(getattr(dist, name).numpy(), np.asarray(getattr(ref, name)))
    assert dist.mode() is dist.mean


def test_diagonal_gaussian_clips_and_samples():
    moments = torch.cat([torch.zeros(1, 2, 2, 4), torch.tensor([-50.0, 0.0, 10.0, 40.0])
                         .expand(1, 2, 2, 4)], dim=-1)
    d = port_vae.DiagonalGaussian(moments)
    assert d.logvar[0, 0, 0].tolist() == [-30.0, 0.0, 10.0, 20.0]
    eps = torch.ones(1, 2, 2, 4)
    assert torch.equal(d.sample(eps), d.std)
    ref = jax_vae.DiagonalGaussian(jnp.asarray(moments.numpy()))
    np.testing.assert_allclose(d.std.numpy(), np.asarray(ref.std), rtol=1e-6)


def test_encode_image_matches_jax(pipes, rng):
    """Deterministic mode (posterior mode x scale factor), and sampled mode
    with the JAX runtime's noise (normal(key, mean shape)) handed in."""
    jax_rt, port_rt = pipes[0].runtime, pipes[1].runtime
    img = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jax_rt.encode_image(jnp.asarray(img), deterministic=True))
    out = port_rt.encode_image(img, deterministic=True)
    assert out.dtype == torch.float32 and out.shape == (2, 8, 8, 4)
    assert_close_scaled(out.numpy(), ref)
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jax_rt.encode_image(jnp.asarray(img), key))
    eps = np.asarray(jax.random.normal(key, (2, 8, 8, 4), jnp.float32))
    assert_close_scaled(port_rt.encode_image(img, eps=eps).numpy(), ref)
    # from the caller's generator: reproducible, and not the mode
    g = lambda: torch.Generator().manual_seed(3)
    a, b = port_rt.encode_image(img, g()), port_rt.encode_image(img, g())
    assert torch.equal(a, b) and not torch.equal(a, out)
    with pytest.raises(ValueError, match="generator= or eps="):
        port_rt.encode_image(img)


# --------------------------------------------------------------- process()


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return {"image": (rng.random((70, 60, 3)) * 255).astype(np.uint8),
            "source": (rng.random((90, 80, 3)) * 255).astype(np.uint8),
            "x_T": rng.standard_normal((1, 8, 8, 4), dtype=np.float32)}


KW = dict(a_prompt="best quality", n_prompt="lowres", num_samples=1,
          image_resolution=64, ddim_steps=4, eta=0.0)


@pytest.mark.parametrize("strength", [0.5, 0.8])
def test_img2img_process_matches_jax(pipes, images, strength):
    """The JAX engine re-noises with normal(split(PRNGKey(seed))[1]); the port
    is given that noise. t_enc = round(strength x 4): 2 and 3 steps."""
    jax_pipe, port_pipe = pipes
    seed = 42
    kn = jax.random.split(jax.random.PRNGKey(seed))[1]
    noise = np.asarray(jax.random.normal(kn, (1, 8, 8, 4), jnp.float32))
    kw = dict(KW, seed=seed, init_image=images["source"], denoise_strength=strength)
    ref = jax_pipe.process(images["image"], "a bird", **kw)
    out = port_pipe.process(images["image"], "a bird", img2img_noise=noise, **kw)
    assert np.array_equal(out[0], ref[0])
    assert out[1].shape == ref[1].shape == (64, 64, 3)
    assert np.abs(out[1].astype(int) - ref[1].astype(int)).max() <= 1
    t_enc = round(strength * 4)
    names = {e.name for e in port_pipe.runtime._engines.values()}
    # the Canny hint rides bit-packed, as in the JAX package (its name too)
    assert {"encoder_b1_64x64_det",
            f"ddim+decode_{t_enc}x1x64x64_bithint_genxT-img2img"} <= names
    # without the noise the port draws its own from the seed: reproducible
    drawn = [port_pipe.process(images["image"], "a bird", **kw)[1] for _ in range(2)]
    assert np.array_equal(*drawn) and not np.array_equal(drawn[0], out[1])


@pytest.mark.parametrize("with_x_T", [True, False])
def test_inpaint_process_matches_jax(pipes, images, with_x_T):
    """The JAX loop's per-step blend noise is _step_noise(fold_in(key,
    0x1B9A1), i) of its scan key: PRNGKey(seed) with x_T given, else
    split(PRNGKey(seed))[0] (then x_T is normal(split(...)[1]))."""
    jax_pipe, port_pipe = pipes
    seed = 9
    root = jax.random.PRNGKey(seed)
    if with_x_T:
        key, x_T = root, images["x_T"]
    else:
        key, sub = jax.random.split(root)
        x_T = np.asarray(jax.random.normal(sub, (1, 8, 8, 4), jnp.float32))
    ikey = jax.random.fold_in(key, 0x1B9A1)
    noise = np.stack([np.asarray(_step_noise(ikey, jnp.int32(i), (1, 8, 8, 4)))
                      for i in range(4)])
    mask = np.zeros((90, 80), np.uint8)
    mask[20:70, 10:50] = 255
    kw = dict(KW, seed=seed, inpaint_image=images["source"], inpaint_mask=mask)
    ref = jax_pipe.process(images["image"], "a bird",
                           **dict(kw, x_T=x_T if with_x_T else None))
    out = port_pipe.process(images["image"], "a bird", x_T=x_T, inpaint_noise=noise, **kw)
    assert np.abs(out[1].astype(int) - ref[1].astype(int)).max() <= 1
    assert "ddim+decode_4x1x64x64_bithint_inpaint" in \
        {e.name for e in port_pipe.runtime._engines.values()}


def test_inpaint_keeps_the_unmasked_region(pipes, images):
    """Outside a hard mask the final latents are the source's encoding (up
    to the encoder's fp32 summation order between the two calls)."""
    port_pipe = pipes[1]
    mask = np.zeros((64, 64), np.uint8)
    mask[:32] = 255
    port_pipe.process(images["image"], "a bird", **dict(
        KW, seed=1, inpaint_image=images["source"], inpaint_mask=mask))
    z = port_pipe.last_latents
    import cv2

    src = cv2.resize(images["source"], (64, 64), interpolation=cv2.INTER_AREA)
    lat = port_pipe.runtime.encode_image(
        (src.astype(np.float32) / 127.5 - 1.0)[None], deterministic=True)
    assert_close_scaled(z[:, 4:].numpy(), lat[:, 4:].numpy(), tol=1e-5)
    assert not torch.allclose(z[:, :4], lat[:, :4])


@pytest.mark.parametrize("kwargs,match", [
    ({"init_image": np.zeros((64, 64, 3), np.uint8), "x_T": np.zeros((1, 8, 8, 4))},
     "mutually exclusive"),
    ({"inpaint_image": np.zeros((64, 64, 3), np.uint8)}, "requires inpaint_mask"),
    ({"init_image": np.zeros((64, 64, 3), np.uint8), "granular_timings": True},
     "img2img is unsupported on the granular"),
    ({"inpaint_image": np.zeros((64, 64, 3), np.uint8),
      "inpaint_mask": np.zeros((64, 64), np.uint8), "granular_timings": True},
     "inpainting is unsupported on the granular"),
], ids=["x_T", "no_mask", "img2img_granular", "inpaint_granular"])
def test_process_refuses_as_jax_does(pipes, images, kwargs, match):
    for pipe in pipes:
        with pytest.raises(ValueError, match=match):
            pipe.process(images["image"], "a bird", image_resolution=64, ddim_steps=1,
                         seed=0, **kwargs)
