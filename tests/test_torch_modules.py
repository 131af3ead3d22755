"""Each kernel-bearing module of the PyTorch port against the JAX package,
fp32 on the CPU, on the same seeded tiny weights (converted with
state_dict_from_jax). Tolerance: max |d| <= 1e-4 x max |reference|."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stablediffusioneo_tpu.checkpoint.convert import (
    convert_clip,
    convert_controlnet,
    convert_unet,
    convert_vae,
)
from stablediffusioneo_tpu.models.clip import clip_text_apply as jax_clip
from stablediffusioneo_tpu.models.controlnet import (
    controlled_unet_apply as jax_controlled_unet,
    controlnet_apply as jax_controlnet,
    precompute_controlnet_context_kv as jax_ctrl_kv,
)
from stablediffusioneo_tpu.models.text_encoding import clip_text_apply_skip
from stablediffusioneo_tpu.models.unet import (
    precompute_context_kv as jax_unet_kv,
    resblock_apply,
    spatial_transformer_apply,
)
from stablediffusioneo_tpu.models.vae import vae_decode as jax_vae_decode
from stablediffusioneo_tpu.ops.attention import (
    multi_head_attention as jax_mha,
)
from stablediffusioneo_tpu_torch.checkpoint.convert import state_dict_from_jax
from stablediffusioneo_tpu_torch.models.clip import clip_text_apply
from stablediffusioneo_tpu_torch.models.controlnet import (
    controlled_unet_apply,
    controlnet_apply,
    guess_mode_scales,
    precompute_controlnet_context_kv,
)
from stablediffusioneo_tpu_torch.models.unet import precompute_context_kv
from stablediffusioneo_tpu_torch.models.vae import vae_decode
from stablediffusioneo_tpu_torch.ops.attention import (
    context_kv,
    multi_head_attention,
)

from torch_port_util import (
    CFG,
    PORT_CFG,
    assert_close_scaled,
    port_model,
    tiny_params,
)


@pytest.fixture(scope="module")
def params():
    return tiny_params()


@pytest.fixture(scope="module")
def model(params):
    return port_model(params)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("mode", ["self", "cross", "hoisted_kv"])
def test_multi_head_attention(rng, mode):
    b, t, c, heads, tk, ck = 2, 64, 32, 2, 16, 24
    x = rng.standard_normal((b, t, c), dtype=np.float32)
    ctx = rng.standard_normal((b, tk, ck), dtype=np.float32)
    cin = c if mode == "self" else ck
    wq, wk, wv, wo = (rng.standard_normal(s, dtype=np.float32) * 0.2
                      for s in ((c, c), (cin, c), (cin, c), (c, c)))
    bo = rng.standard_normal(c, dtype=np.float32)
    context = None if mode == "self" else ctx
    ref = jax_mha(jnp.asarray(x), None if context is None else jnp.asarray(context),
                  jnp.asarray(wq), jnp.asarray(wk), jnp.asarray(wv),
                  jnp.asarray(wo), jnp.asarray(bo), heads)
    tw = [_t(w.T) for w in (wq, wk, wv, wo)]
    kv = context_kv(_t(ctx), tw[1], tw[2]) if mode == "hoisted_kv" else None
    out = multi_head_attention(_t(x), None if context is None else _t(context),
                               *tw, _t(bo), heads, kv=kv)
    assert_close_scaled(out.numpy(), ref)


def test_resblock(params, model, rng):
    p = params["unet"]["input_blocks"][3]["res"]  # 32 -> 64 channels: skip conv
    block = model.unet.input_blocks[3][0]
    x = rng.standard_normal((2, 4, 4, 32), dtype=np.float32)
    emb = rng.standard_normal((2, CFG.unet.time_embed_dim), dtype=np.float32)
    ref = resblock_apply(p, CFG.unet, jnp.asarray(x), jnp.asarray(emb))
    out = block(_t(x).permute(0, 3, 1, 2), _t(emb)).permute(0, 2, 3, 1)
    assert_close_scaled(out.numpy(), ref)


def test_spatial_transformer(params, model, rng):
    p = params["unet"]["input_blocks"][1]["attn"]
    st = model.unet.input_blocks[1][1]
    x = rng.standard_normal((2, 8, 8, 32), dtype=np.float32)
    ctx = rng.standard_normal((2, CFG.clip.max_length, CFG.unet.context_dim),
                              dtype=np.float32)
    ref = spatial_transformer_apply(p, CFG.unet, jnp.asarray(x), jnp.asarray(ctx))
    out = st(_t(x).permute(0, 3, 1, 2), _t(ctx)).permute(0, 2, 3, 1)
    assert_close_scaled(out.numpy(), ref)


@pytest.mark.parametrize("variant", ["control", "hoisted_kv", "guess_scales",
                                     "no_control"])
def test_controlled_unet(params, model, rng, variant):
    b = 2
    x = rng.standard_normal((b, 8, 8, 4), dtype=np.float32)
    hint = rng.random((b, 64, 64, 3), dtype=np.float32)
    ctx = rng.standard_normal((b, CFG.clip.max_length, CFG.unet.context_dim),
                              dtype=np.float32)
    t = np.asarray([981.0, 500.0], np.float32)
    scales = (guess_mode_scales(0.8) if variant == "guess_scales"
              else [1.0] * 13)
    jargs = dict(control_scales=scales)
    targs = dict(control_scales=scales)
    h = None if variant == "no_control" else hint
    if variant == "hoisted_kv":
        jargs.update(unet_ctx_kv=jax_unet_kv(params["unet"], CFG.unet, jnp.asarray(ctx)),
                     ctrl_ctx_kv=jax_ctrl_kv(params["controlnet"], CFG.controlnet,
                                             jnp.asarray(ctx)))
        targs.update(unet_ctx_kv=precompute_context_kv(model.unet, _t(ctx)),
                     ctrl_ctx_kv=precompute_controlnet_context_kv(
                         model.control_model, _t(ctx)))
    ref = jax_controlled_unet(
        params["unet"], params["controlnet"], CFG.controlnet, jnp.asarray(x),
        None if h is None else jnp.asarray(h), jnp.asarray(t), jnp.asarray(ctx),
        **jargs)
    out = controlled_unet_apply(model.unet, model.control_model, _t(x),
                                None if h is None else _t(h), _t(t), _t(ctx),
                                **targs)
    assert_close_scaled(out.numpy(), ref)


def test_controlnet_taps(params, model, rng):
    x = rng.standard_normal((1, 8, 8, 4), dtype=np.float32)
    hint = rng.random((1, 64, 64, 3), dtype=np.float32)
    ctx = rng.standard_normal((1, CFG.clip.max_length, CFG.unet.context_dim),
                              dtype=np.float32)
    t = np.asarray([321.0], np.float32)
    ref = jax_controlnet(params["controlnet"], CFG.controlnet, jnp.asarray(x),
                         jnp.asarray(hint), jnp.asarray(t), jnp.asarray(ctx))
    out = controlnet_apply(model.control_model, _t(x), _t(hint), _t(t), _t(ctx))
    assert len(out) == len(ref) == 5  # tiny plan: 4 input blocks + middle
    for o, r in zip(out, ref):
        assert_close_scaled(o.numpy(), r)


def test_vae_decode(params, model, rng):
    z = rng.standard_normal((1, 8, 8, 4), dtype=np.float32)
    ref = jax_vae_decode(params["vae"], CFG.vae, jnp.asarray(z), scaled=True)
    out = vae_decode(model.first_stage_model, _t(z), scaled=True)
    assert_close_scaled(out.numpy(), ref)


@pytest.mark.parametrize("clip_skip", [0, 2])
def test_clip_text(params, model, rng, clip_skip):
    ids = rng.integers(0, CFG.clip.vocab_size, (2, CFG.clip.max_length))
    if clip_skip:
        ref = clip_text_apply_skip(params["clip"], CFG.clip, jnp.asarray(ids),
                                   clip_skip=clip_skip)
    else:
        ref = jax_clip(params["clip"], CFG.clip, jnp.asarray(ids))
    out = clip_text_apply(model.clip, torch.from_numpy(ids), clip_skip=clip_skip)
    assert_close_scaled(out.numpy(), ref)


def test_state_dict_round_trip_is_exact(params):
    """JAX params -> state_dict_from_jax -> checkpoint/convert.py -> JAX
    params reproduces every leaf bit for bit."""
    sd = {k: v.numpy() for k, v in state_dict_from_jax(params, PORT_CFG).items()}
    back = {
        "unet": convert_unet(sd, CFG.unet),
        "controlnet": convert_controlnet(sd, CFG.controlnet),
        "vae": convert_vae(sd, CFG.vae),
        "clip": convert_clip(sd, CFG.clip),
    }
    a, ta = jax.tree.flatten(params)
    b, tb = jax.tree.flatten(back)
    assert ta == tb
    for x, y in zip(a, b):
        assert x.shape == y.shape and np.array_equal(np.asarray(x), np.asarray(y))
