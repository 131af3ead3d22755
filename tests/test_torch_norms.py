"""The port's fused-norm configuration against the JAX package's.

The norm kernel entries' plain versions (what CPU tensors run) against the
JAX package's Pallas GroupNorm and LayerNorm kernels in interpret mode; the
port's dispatch gates against the JAX package's over the SD-1.5 512x512
sites; the flags; and the tiny controlled UNet and VAE decode with
`set_kernels(groupnorm=True, layernorm=True)` in both packages.

Tolerances: fp32 atol 2e-5 (one-pass fp32 sums on both sides, another
summation order); bf16 atol 1e-2 on unit-normal inputs (both round the same
fp32 value once, so they differ only where the sums' last bits move a value
across a bf16 rounding boundary); model level max |d| <= 1e-4 x max |ref|.
The CUDA kernels against these plain versions: tests/test_torch_cuda.py.
"""

import collections
import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from stablediffusioneo_tpu.models.controlnet import (
    controlled_unet_apply as jax_controlled_unet,
)
from stablediffusioneo_tpu.models.vae import vae_decode as jax_vae_decode
from stablediffusioneo_tpu.ops import dispatch as jax_dispatch
from stablediffusioneo_tpu.ops import norms as jax_norms
from stablediffusioneo_tpu.ops.pallas.groupnorm import (
    fused_group_norm as jax_fused_group_norm,
    group_norm_pallas_supported,
)
from stablediffusioneo_tpu.ops.pallas.layernorm import (
    _ln_math,
    fused_layer_norm as jax_fused_layer_norm,
    layer_norm_pallas_supported,
)
from stablediffusioneo_tpu_torch.models import unet as unet_module
from stablediffusioneo_tpu_torch.models.clip import clip_text_apply
from stablediffusioneo_tpu_torch.models.controlnet import controlled_unet_apply
from stablediffusioneo_tpu_torch.models.vae import vae_decode
from stablediffusioneo_tpu_torch.ops import dispatch, norms
from stablediffusioneo_tpu_torch.ops.kernels.groupnorm import (
    _spatial_chunk,
    chunk_rows,
    fused_group_norm,
    fused_group_norm_plain,
    group_norm_apply,
    group_norm_stats,
    group_norm_supported,
)
from stablediffusioneo_tpu_torch.ops.kernels.layernorm import (
    fused_layer_norm,
    fused_layer_norm_plain,
    layer_norm_supported,
)

from torch_port_util import (
    CFG,
    PORT_CFG,
    assert_close_scaled,
    port_model,
    tiny_params,
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the plan-derived site lists)

from stablediffusioneo_tpu_torch.config import sd15_pipeline  # noqa: E402

FP32_ATOL = 2e-5
BF16_ATOL = 1e-2


@pytest.fixture
def fused_norms(monkeypatch):
    """The fused-norm configuration in both packages, restored afterwards.
    The JAX package reaches its Pallas kernels on the CPU only in interpret
    mode (which also admits flash attention, off below 1024 query tokens)."""
    monkeypatch.setenv("SDEO_PALLAS_INTERPRET", "1")
    jax_dispatch.set_kernels(groupnorm=True, layernorm=True)
    dispatch.set_kernels(groupnorm=True, layernorm=True)
    try:
        yield
    finally:
        jax_dispatch.set_kernels(groupnorm=False, layernorm=False)
        dispatch.set_kernels(groupnorm=False, layernorm=False)


def _nchw(x_nhwc):
    """NHWC numpy -> NCHW tensor in channels-last memory, as the port's
    networks hold activations."""
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)


def _affine(rng, c):
    return (1.0 + 0.1 * rng.standard_normal(c, dtype=np.float32),
            0.1 * rng.standard_normal(c, dtype=np.float32))


def _affine_bf16(rng, c):
    """An affine that keeps |y| < 2, where one bf16 ulp (2^-7) lies inside
    BF16_ATOL: above 2 a value that the two sides' sums put on either side of
    a rounding boundary differs by 2^-6."""
    return (0.25 + 0.025 * rng.standard_normal(c, dtype=np.float32),
            0.05 * rng.standard_normal(c, dtype=np.float32))


# ------------------------------------------------------------- GroupNorm


GN_SHAPES = [((2, 8, 8, 64), 8), ((1, 16, 12, 320), 32),
             ((1, 64, 64, 512), 32)]  # the last takes the two-pass kernels


def test_gn_shapes_cover_both_paths():
    one_pass = [_spatial_chunk(h * w, c) == h * w for (_, h, w, c), _ in GN_SHAPES]
    assert one_pass == [True, True, False]


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("swish", [False, True])
@pytest.mark.parametrize("shape,groups", GN_SHAPES)
def test_group_norm_plain_matches_pallas_fp32(rng, shape, groups, swish, eps):
    x = rng.standard_normal(shape, dtype=np.float32)
    g, b = _affine(rng, shape[-1])
    ref = np.asarray(jax_fused_group_norm(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), groups=groups, eps=eps,
        swish=swish, interpret=True))
    out = fused_group_norm(_nchw(x), torch.from_numpy(g), torch.from_numpy(b),
                           groups, eps, swish)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, rtol=0,
                               atol=FP32_ATOL)


@pytest.mark.parametrize("shape,groups", GN_SHAPES)
def test_group_norm_plain_matches_pallas_bf16(rng, shape, groups):
    x = rng.standard_normal(shape, dtype=np.float32)
    g, b = _affine_bf16(rng, shape[-1])
    ref = jax_fused_group_norm(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16),
        jnp.asarray(b, jnp.bfloat16), groups=groups, eps=1e-5, swish=True,
        interpret=True)
    out = fused_group_norm(_nchw(x).to(torch.bfloat16),
                           torch.from_numpy(g).to(torch.bfloat16),
                           torch.from_numpy(b).to(torch.bfloat16), groups, 1e-5,
                           True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref.astype(jnp.float32)), rtol=0,
                               atol=BF16_ATOL)


@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
def test_two_pass_pair_matches_one_pass(rng, layout):
    """stats + apply over spatial chunks (a ragged last one) equal the
    one-pass plain version, in either memory layout."""
    x = _nchw(rng.standard_normal((2, 10, 9, 64), dtype=np.float32))
    if layout == "nchw":
        x = x.contiguous()
    g, b = (torch.from_numpy(a) for a in _affine(rng, 64))
    parts = group_norm_stats(x, 8, 4)  # 90 rows in chunks of 4: 23 chunks
    assert parts.shape == (2, 8, 23, 2)
    out = group_norm_apply(x, parts, g, b, 4, 1e-6, True)
    torch.testing.assert_close(out, fused_group_norm_plain(x, g, b, 8, 1e-6, True),
                               rtol=0, atol=FP32_ATOL)


def test_chunk_rows():
    x = torch.empty((1, 128, 512, 512))
    assert chunk_rows(x, 32) == 4096  # 16384 elements of a group per block
    assert chunk_rows(torch.empty((1, 32, 4, 4)), 32) == 16  # whole slab


# ------------------------------------------------------------- LayerNorm


def test_layer_norm_plain_matches_pallas_bf16(rng):
    x = rng.standard_normal((2, 1024, 320), dtype=np.float32)
    g, b = _affine_bf16(rng, 320)
    ref = jax_fused_layer_norm(jnp.asarray(x, jnp.bfloat16),
                               jnp.asarray(g, jnp.bfloat16),
                               jnp.asarray(b, jnp.bfloat16), eps=1e-5,
                               interpret=True)
    out = fused_layer_norm(torch.from_numpy(x).to(torch.bfloat16),
                           torch.from_numpy(g).to(torch.bfloat16),
                           torch.from_numpy(b).to(torch.bfloat16), 1e-5)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), rtol=0,
                               atol=BF16_ATOL)


@pytest.mark.parametrize("shape", [(2, 1024, 320), (3, 77, 768)])
def test_layer_norm_plain_matches_ln_math_fp32(rng, shape):
    x = rng.standard_normal(shape, dtype=np.float32)
    g, b = _affine(rng, shape[-1])
    ref = np.asarray(_ln_math(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), 1e-5))
    out = fused_layer_norm_plain(torch.from_numpy(x), torch.from_numpy(g),
                                 torch.from_numpy(b), 1e-5)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=FP32_ATOL)


def test_layer_norm_routing_matches_jax(rng, fused_norms):
    """ops/norms.layer_norm with the flag on, both packages, a gated bf16
    site: both take their kernel's math."""
    x = rng.standard_normal((2, 1024, 320), dtype=np.float32)
    g, b = _affine_bf16(rng, 320)
    ref = jax_norms.layer_norm(jnp.asarray(x, jnp.bfloat16),
                               jnp.asarray(g, jnp.bfloat16),
                               jnp.asarray(b, jnp.bfloat16), eps=1e-5)
    out = norms.layer_norm(torch.from_numpy(x).to(torch.bfloat16),
                           torch.from_numpy(g).to(torch.bfloat16),
                           torch.from_numpy(b).to(torch.bfloat16), 1e-5)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), rtol=0,
                               atol=BF16_ATOL)


# ------------------------------------------------------------------ gates


SD15_SITES = chip_smoke.norm_sites(sd15_pipeline(), 512)


@pytest.mark.parametrize("part", ["step", "decode", "prompt"])
def test_gates_match_jax_over_sd15_sites(part):
    sites = SD15_SITES[part]
    seen = set()
    for kind, shape, _, groups in sites:
        if kind == "gn":
            n, c, h, w = shape
            port = group_norm_supported(shape, groups)
            assert port == group_norm_pallas_supported((n, h, w, c), jnp.bfloat16,
                                                       groups), shape
            seen.add(("gn", port))
        else:
            for tdt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
                port = layer_norm_supported(shape, tdt)
                assert port == layer_norm_pallas_supported(shape, jdt), (shape, tdt)
                seen.add(("ln", port))
    want = {"step": {("gn", True), ("gn", False), ("ln", True), ("ln", False)},
            "decode": {("gn", False)},  # 64x64x512 already exceeds the gate
            "prompt": {("ln", False)}}[part]  # CLIP's (2, 77, 768)
    assert seen == want


def test_sd15_gated_site_counts():
    """The counts the smoke run expects per DDIM step at 512x512, counted by
    hand from the plans: UNet 57 GroupNorms (encoder 22, middle 5, decoder
    29 of 33, out 1) + ControlNet 27; LayerNorms 3 per transformer block at
    >= 16x16, UNet 45 + ControlNet 18. The up-block concats at 64x64 (960,
    640, 640 channels) and 32x32 (1920) stay plain, and so do the 8x8
    middle-block LayerNorms (2, 64, 1280)."""
    assert chip_smoke.norm_launches(SD15_SITES["step"], torch.bfloat16) == {
        "fused_group_norm": 84, "fused_layer_norm": 63}
    for kind, shape in (("gn", (2, 960, 64, 64)), ("gn", (2, 640, 64, 64)),
                        ("gn", (2, 1920, 32, 32)), ("ln", (2, 64, 1280))):
        assert any(s[0] == kind and s[1] == shape for s in SD15_SITES["step"])
        assert not chip_smoke.gated((kind, shape, False, 32), torch.bfloat16)


# ------------------------------------------------------------ flags, rule


def test_set_kernels_names_and_defaults():
    assert not dispatch.kernels_enabled("groupnorm")
    assert not dispatch.kernels_enabled("layernorm")
    assert not dispatch.kernels_enabled("no_such_kernel")
    with pytest.raises(KeyError):
        dispatch.set_kernels(flash_attention=True)
    try:
        dispatch.set_kernels(groupnorm=True)
        assert dispatch.kernels_enabled("groupnorm")
        assert not dispatch.kernels_enabled("layernorm")
    finally:
        dispatch.set_kernels(groupnorm=False)
    assert set(dispatch.KERNELS) >= {"fused_group_norm", "group_norm_stats",
                                     "group_norm_apply", "fused_layer_norm"}


def test_flags_on_cpu_tensors_take_plain_versions_and_count_nothing(rng, fused_norms):
    dispatch.reset_launches()
    x = _nchw(rng.standard_normal((2, 16, 16, 64), dtype=np.float32))
    g, b = (torch.from_numpy(a) for a in _affine(rng, 64))
    torch.testing.assert_close(norms.group_norm(x, g, b, 8, 1e-5, swish=True),
                               fused_group_norm_plain(x, g, b, 8, 1e-5, True),
                               rtol=0, atol=0)
    big = _nchw(rng.standard_normal((1, 64, 64, 512), dtype=np.float32))
    gb, bb = (torch.from_numpy(a) for a in _affine(rng, 512))
    assert not group_norm_supported(big.shape, 32)
    ref = torch.nn.functional.group_norm(big.float(), 32, gb, bb, 1e-6)
    torch.testing.assert_close(norms.group_norm(big, gb, bb, 32, 1e-6), ref)
    t = torch.from_numpy(rng.standard_normal((2, 512, 320), dtype=np.float32))
    t = t.to(torch.bfloat16)
    gt, bt = (torch.from_numpy(a).to(torch.bfloat16) for a in _affine(rng, 320))
    torch.testing.assert_close(norms.layer_norm(t, gt, bt, 1e-5),
                               fused_layer_norm_plain(t, gt, bt, 1e-5),
                               rtol=0, atol=0)
    assert dispatch.launches == {name: 0 for name in dispatch.KERNELS}


def test_flags_off_keep_the_default_norms(rng):
    x = _nchw(rng.standard_normal((2, 16, 16, 64), dtype=np.float32))
    g, b = (torch.from_numpy(a) for a in _affine(rng, 64))
    ref = torch.nn.functional.silu(torch.nn.functional.group_norm(x, 8, g, b, 1e-5))
    torch.testing.assert_close(norms.group_norm(x, g, b, 8, 1e-5, swish=True),
                               ref, rtol=0, atol=0)


# ------------------------------------------------------------- the slice


@pytest.fixture(scope="module")
def params():
    return tiny_params()


@pytest.fixture(scope="module")
def model(params):
    return port_model(params)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_controlled_unet_fused_norms(params, model, rng, fused_norms):
    x = rng.standard_normal((2, 8, 8, 4), dtype=np.float32)
    hint = rng.random((2, 64, 64, 3), dtype=np.float32)
    ctx = rng.standard_normal((2, CFG.clip.max_length, CFG.unet.context_dim),
                              dtype=np.float32)
    t = np.asarray([981.0, 500.0], np.float32)
    ref = jax_controlled_unet(
        params["unet"], params["controlnet"], CFG.controlnet, jnp.asarray(x),
        jnp.asarray(hint), jnp.asarray(t), jnp.asarray(ctx),
        control_scales=[1.0] * 13)
    out = controlled_unet_apply(model.unet, model.control_model, _t(x), _t(hint),
                                _t(t), _t(ctx), control_scales=[1.0] * 13)
    assert_close_scaled(out.numpy(), ref)


def test_vae_decode_fused_norms(params, model, rng, fused_norms):
    z = rng.standard_normal((1, 8, 8, 4), dtype=np.float32)
    ref = jax_vae_decode(params["vae"], CFG.vae, jnp.asarray(z), scaled=True)
    out = vae_decode(model.first_stage_model, _t(z), scaled=True)
    assert_close_scaled(out.numpy(), ref)


def test_plan_sites_are_the_modules_calls(model, rng, fused_norms, monkeypatch):
    """norm_sites (the smoke run's launch expectation) lists exactly the
    norm calls the modules make, and the flags route exactly its gated sites
    to the kernel entries (tiny config, fp32: no LayerNorm site passes its
    gate)."""
    calls, routed = [], collections.Counter()

    def record_gn(x, weight, bias, groups, eps, swish=False):
        calls.append(("gn", tuple(x.shape), swish, groups))
        return gn(x, weight, bias, groups, eps, swish)

    def record_ln(x, weight, bias, eps):
        calls.append(("ln", tuple(x.shape), False, 0))
        return ln(x, weight, bias, eps)

    gn, ln = unet_module.group_norm, unet_module.layer_norm
    monkeypatch.setattr(unet_module, "group_norm", record_gn)
    monkeypatch.setattr(unet_module, "layer_norm", record_ln)
    for name in ("fused_group_norm", "fused_layer_norm"):
        entry = getattr(norms, name)
        monkeypatch.setattr(norms, name, lambda *a, _e=entry, _n=name, **k:
                            (routed.update([_n]), _e(*a, **k))[1])
    sites = chip_smoke.norm_sites(PORT_CFG, 64)
    with torch.no_grad():
        controlled_unet_apply(
            model.unet, model.control_model, _t(rng.standard_normal((2, 8, 8, 4))),
            _t(rng.random((2, 64, 64, 3))), _t([981.0, 500.0]),
            _t(rng.standard_normal((2, CFG.clip.max_length, CFG.unet.context_dim))),
            control_scales=[1.0] * 13)
        assert sorted(calls) == sorted(sites["step"])
        calls.clear()
        vae_decode(model.first_stage_model, _t(rng.standard_normal((1, 8, 8, 4))))
        assert calls == sites["decode"]
        calls.clear()
        clip_text_apply(model.clip, torch.zeros((2, CFG.clip.max_length),
                                                dtype=torch.long))
        assert calls == sites["prompt"]
    want = collections.Counter()
    for part in sites.values():
        want.update(chip_smoke.norm_launches(part, torch.float32))
    assert routed == +want and want["fused_group_norm"] > 0
