"""The PyTorch port's hires-fix path against the JAX package's, fp32 on the
CPU at tiny_pipeline() size: the bilinear latent upscale, the re-noised
schedule-tail entry, the streaming attention entry's plain version against
the Pallas streaming kernel in interpret mode, the stream routing rule over
the SD-1.5 attention sites, and process(hires_upscale=2.0) end to end with
the same x_T and re-noise noise in both packages.

Tolerances: fp32 1e-5 where both sides compute the same fp32 formula in
another summation order; bf16 streaming attention max |d| <= 2e-2, mean
<= 2e-3 (the Pallas kernel rounds the unnormalised p per K block, the plain
version the normalised p); the image within 1 uint8 LSB, as
test_torch_pipeline.py holds the default path.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablediffusioneo_tpu.models.tokenizer import toy_tokenizer
from stablediffusioneo_tpu.ops import schedule as jax_schedule
from stablediffusioneo_tpu.ops.pallas import attention as jax_attn
from stablediffusioneo_tpu.pipeline import ddim as jax_ddim
from stablediffusioneo_tpu.pipeline.canny2image import (
    Canny2ImagePipeline as JaxPipeline,
)
from stablediffusioneo_tpu_torch.config import sd15_pipeline
from stablediffusioneo_tpu_torch.ops import attention as port_attn
from stablediffusioneo_tpu_torch.ops.kernels.attention import (
    fused_attention_packed_stream,
    fused_attention_packed_stream_plain,
)
from stablediffusioneo_tpu_torch.ops.layers import resize_latent_bilinear
from stablediffusioneo_tpu_torch.pipeline import ddim as port_ddim
from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline

from torch_port_util import CFG, PORT_CFG, port_model, tiny_params

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the plan-derived attention sites)

BF16_TOL = (2e-2, 2e-3)


@pytest.mark.parametrize("upscale", [2.0, 1.5])
def test_resize_latent_bilinear_matches_jax(rng, upscale):
    z = rng.standard_normal((2, 8, 12, 4), dtype=np.float32)
    h, w = int(8 * upscale), int(12 * upscale)
    ref = np.asarray(jax.image.resize(jnp.asarray(z), (2, h, w, 4), "bilinear"))
    out = resize_latent_bilinear(torch.from_numpy(z), h, w).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_resize_latent_bilinear_refuses_downscaling():
    with pytest.raises(ValueError, match="upscaling"):
        resize_latent_bilinear(torch.zeros((1, 8, 8, 4)), 4, 8)


def test_stochastic_tail_entry_matches_jax(rng):
    d = CFG.diffusion
    sched = jax_schedule.DiffusionSchedule(
        d.timesteps, d.linear_start, d.linear_end, d.schedule).ddim(10)
    z0 = rng.standard_normal((1, 8, 8, 4), dtype=np.float32)
    key = jax.random.PRNGKey(3)
    tail, x_T, _ = jax_ddim.stochastic_tail_entry(sched, 7, jnp.asarray(z0), key)
    noise = jax.random.normal(jax.random.split(key)[1], z0.shape, jnp.float32)
    port_tail, port_x_T = port_ddim.stochastic_tail_entry(
        sched, 7, torch.from_numpy(z0), noise=torch.from_numpy(np.array(noise)))
    assert port_tail.keys() == tail.keys()
    for k in tail:
        np.testing.assert_array_equal(port_tail[k], tail[k])
    assert port_tail["timesteps"].shape == (7,)
    np.testing.assert_allclose(port_x_T.numpy(), np.asarray(x_T), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="t_enc"):
        port_ddim.stochastic_tail_entry(sched, 11, torch.from_numpy(z0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stream_plain_matches_pallas(rng, dtype):
    """At (2, 384, 320), 8 heads, with (128, 128) blocks on the JAX side and
    128-row chunks on the port's."""
    b, t, c, heads = 2, 384, 320, 8
    q, k, v = (rng.standard_normal((b, t, c), dtype=np.float32) for _ in range(3))
    scale = (c // heads) ** -0.5
    ref = jax_attn._packed_stream_call(
        *(jnp.asarray(a, dtype) for a in (q, k, v)), heads, scale, (128, 128),
        interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    args = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)]
    # 128-row chunks; and the entry itself, which on CPU tensors runs its
    # plain version in default (here: one) chunks
    for out in (fused_attention_packed_stream_plain(*args, heads, scale, rows=128),
                fused_attention_packed_stream(*args, heads, scale)):
        err = np.abs(out.float().numpy() - ref)
        if dtype == "float32":
            assert err.max() <= 1e-5
        else:
            assert err.max() <= BF16_TOL[0] and err.mean() <= BF16_TOL[1]


@pytest.mark.parametrize("res", [512, 768, 1024])
def test_stream_rule_matches_jax_pickers(res):
    """The port's stream_attention against the JAX package's pickers
    (_packed_impl: no full-K/V block and a stream block pair, self-attention
    only) at every SD-1.5 attention site, bf16 and fp32."""
    cfg = sd15_pipeline()
    streamed = 0
    for (b, tq, c), s, _ in chip_smoke.attention_sites(cfg, res):
        for dtype, itemsize in ((torch.bfloat16, 2), (torch.float32, 4)):
            jax_streams = (tq == s
                           and jax_attn._pick_block_q_packed(tq, s, c, b, itemsize) <= 0
                           and jax_attn._pick_blocks_stream(tq, s, c, itemsize) is not None)
            assert port_attn.stream_attention(tq, s, c, dtype) == jax_streams, \
                (res, tq, s, c, dtype)
            streamed += jax_streams
    # only the 1024x1024 level-0 self-attention streams: 5 UNet + 2 ControlNet
    assert streamed == (7 if res == 1024 else 0)


@pytest.mark.parametrize("streams", [True, False])
def test_multi_head_attention_routes_by_the_stream_rule(rng, monkeypatch, streams):
    calls = []
    for name in ("fused_attention_packed", "fused_attention_packed_stream"):
        entry = getattr(port_attn, name)
        monkeypatch.setattr(port_attn, name, lambda *a, _n=name, _e=entry, **k:
                            (calls.append(_n), _e(*a, **k))[1])
    monkeypatch.setattr(port_attn, "stream_attention", lambda *a: streams)
    x = torch.from_numpy(rng.standard_normal((1, 1024, 16), dtype=np.float32))
    w = [torch.from_numpy(rng.standard_normal((16, 16), dtype=np.float32) * 0.2)
         for _ in range(4)]
    port_attn.multi_head_attention(x, None, *w, None, 2)
    assert calls == ["fused_attention_packed_stream" if streams
                     else "fused_attention_packed"]


# ------------------------------------------------------------- the slice


@pytest.fixture(scope="module")
def pipes():
    params = tiny_params()
    tok = toy_tokenizer(max_length=CFG.clip.max_length)
    return (JaxPipeline(params, tok, CFG, persistent_cache=False),
            Canny2ImagePipeline(port_model(params), tok, PORT_CFG, device="cpu"))


def test_hires_process_matches_jax(pipes):
    """64 -> 128, 2 steps, hires_denoise 0.5 (t_enc 1): the JAX package's
    re-noise draws from split(split(PRNGKey(seed))[0])[1]; the port is given
    the same noise."""
    jax_pipe, port_pipe = pipes
    rng = np.random.default_rng(0)
    image = (rng.random((70, 60, 3)) * 255).astype(np.uint8)
    x_T = rng.standard_normal((1, 8, 8, 4), dtype=np.float32)
    seed = 42
    kn = jax.random.split(jax.random.split(jax.random.PRNGKey(seed))[0])[1]
    noise = np.asarray(jax.random.normal(kn, (1, 16, 16, 4), jnp.float32))
    kw = dict(a_prompt="best quality", n_prompt="lowres", num_samples=1,
              image_resolution=64, ddim_steps=2, seed=seed, eta=0.0, x_T=x_T,
              hires_upscale=2.0, hires_denoise=0.5)
    ref = jax_pipe.process(image, "a bird", **kw)
    out = port_pipe.process(image, "a bird", hires_noise=noise, **kw)
    assert np.array_equal(out[0], ref[0])  # the same hi-res Canny hint
    assert out[0].shape == out[1].shape == ref[1].shape == (128, 128, 3)
    assert out[1].dtype == np.uint8
    assert np.abs(out[1].astype(int) - ref[1].astype(int)).max() <= 1
    assert port_pipe.last_latents.shape == (1, 16, 16, 4)
    assert port_pipe.last_timings.keys() == jax_pipe.last_timings.keys()
    # without injected noise the port draws its own: another image
    drawn = port_pipe.process(image, "a bird", **kw)
    assert drawn[1].shape == (128, 128, 3) and not np.array_equal(drawn[1], out[1])


@pytest.mark.parametrize("kwargs", [
    {"init_image": np.zeros((64, 64, 3), np.uint8)},
    {"inpaint_image": np.zeros((64, 64, 3), np.uint8),
     "inpaint_mask": np.zeros((64, 64), np.uint8)},
])
def test_hires_refuses_img2img_and_inpaint(pipes, kwargs):
    with pytest.raises(ValueError, match="plain txt2img"):
        pipes[1].process(np.zeros((64, 64, 3), np.uint8), "a bird",
                         image_resolution=64, ddim_steps=1, hires_upscale=2.0,
                         **kwargs)


def test_sample_init_latent_validation(pipes):
    rt = pipes[1].runtime
    ctx = torch.zeros((1, CFG.clip.max_length, CFG.unet.context_dim))
    hint = torch.zeros((1, 64, 64, 3), dtype=torch.uint8)
    z = torch.zeros((1, 8, 8, 4))
    with pytest.raises(ValueError, match="x_T=None"):
        rt.sample(2, z, hint, ctx, ctx, init_latent=z, t_enc=1)
    for t_enc in (None, 0, 3):
        with pytest.raises(ValueError, match="t_enc"):
            rt.sample(2, None, hint, ctx, ctx, init_latent=z, t_enc=t_enc)
