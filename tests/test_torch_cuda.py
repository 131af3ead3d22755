"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips without a CUDA device. This file imports no
JAX, so it also runs where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
(--noconftest: tests/conftest.py sets JAX up). Tolerances: fp32 max |d| <=
1e-4 (the two differ in summation order only); bf16 max |d| <= 2e-2 and
mean |d| <= 2e-3 on standard-normal inputs (attention: the kernel rounds
the unnormalised p to bf16, the plain version the normalised one; norms:
both round the same fp32 value once, up to the sums' summation order); the
GroupNorm partial sums within 1e-5 x max |plain|; the int8 matmul within
the same bounds, with inputs scaled to outputs of std ~0.5 (both round the
same fp32 sum once).
"""

import os
import sys

import pytest
import torch

from stablediffusioneo_tpu_torch.config import sd15_pipeline
from stablediffusioneo_tpu_torch.ops import dispatch, norms
from stablediffusioneo_tpu_torch.ops.attention import packed_attention
from stablediffusioneo_tpu_torch.ops.kernels import attention as ka
from stablediffusioneo_tpu_torch.ops.kernels import groupnorm as kg
from stablediffusioneo_tpu_torch.ops.kernels import layernorm as kl
from stablediffusioneo_tpu_torch.ops.kernels import quant as kq
from stablediffusioneo_tpu_torch.ops.kernels.attention import (
    fused_attention,
    fused_attention_packed,
    fused_attention_packed_plain,
    fused_attention_packed_stream,
    fused_attention_packed_stream_plain,
    fused_attention_plain,
)
from stablediffusioneo_tpu_torch.ops.quant import quantize_weights

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402  (the plan-derived main-path shapes; imports no JAX)

pytestmark = pytest.mark.cuda

CFG = sd15_pipeline()
# the seven gated GEMMs and the 15 gated one-pass GroupNorm sites of a
# 512x512 step at the SD-1.5 widths
GEMMS = sorted(set(chip_smoke.quant_gated(chip_smoke.quant_sites(CFG, 512))))
GN_SITES = sorted({(shape, swish, groups)
                   for kind, shape, swish, groups in chip_smoke.norm_sites(CFG, 512)["step"]
                   if kind == "gn" and chip_smoke.gated((kind, shape, swish, groups),
                                                        torch.bfloat16)})


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(shape, gen, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _check(out, ref, dtype):
    err = (out.float() - ref.float()).abs()
    assert torch.isfinite(out).all()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-4
    else:
        assert err.max().item() <= 2e-2 and err.mean().item() <= 2e-3


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,tq,c,s,heads", [
    (2, 4096, 320, 4096, 8), (2, 4096, 320, 77, 8),
    (2, 1024, 640, 1024, 8), (2, 1024, 640, 77, 8),
    (2, 2048, 320, 2048, 8),  # a level-0 self-attention after ToMe at ratio 0.5
    (2, 1000, 1280, 300, 8),  # ragged q and k tiles, d = 160
    (1, 200, 256, 77, 4),     # d = 64
])
def test_packed_kernel_matches_plain(gen, dtype, b, tq, c, s, heads):
    q = _randn((b, tq, c), gen, dtype)
    k, v = _randn((b, s, c), gen, dtype), _randn((b, s, c), gen, dtype)
    scale = (c // heads) ** -0.5
    dispatch.reset_launches()
    ka.variant_launches.clear()
    out = fused_attention_packed(q, k, v, heads, scale)
    assert dispatch.launches["fused_attention_packed"] == 1
    assert dict(ka.variant_launches) == {
        "wgmma" if dtype == torch.bfloat16 else "cuda_core": 1}
    _check(out, fused_attention_packed_plain(q, k, v, heads, scale), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,tq,c,s,heads", [
    (2, 4096, 640, 4096, 10), (2, 4096, 640, 77, 10),      # SDXL 1024x1024, level 1
    (2, 1024, 1280, 1024, 20), (2, 1024, 1280, 77, 20),    # SDXL level 2 and middle
    (2, 9216, 320, 9216, 5), (2, 9216, 320, 77, 5),        # SD-2.1 768x768, level 0
    (2, 2304, 640, 2304, 10), (2, 2304, 640, 77, 10),      # SD-2.1 level 1
])
def test_packed_kernel_head_dim_64(gen, dtype, b, tq, c, s, heads):
    """The SD-2.x / SDXL sites: heads of 64 channels, 5, 10 and 20 of them."""
    q = _randn((b, tq, c), gen, dtype)
    k, v = _randn((b, s, c), gen, dtype), _randn((b, s, c), gen, dtype)
    ka.variant_launches.clear()
    out = fused_attention_packed(q, k, v, heads, 64 ** -0.5)
    assert dict(ka.variant_launches) == {
        "wgmma" if dtype == torch.bfloat16 else "cuda_core": 1}
    _check(out, fused_attention_packed_plain(q, k, v, heads, 64 ** -0.5), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tq", [4429, 4096], ids=["joint", "image_only"])
def test_packed_kernel_at_the_sd3_sites(gen, dtype, tq):
    """SD 3.5 Medium at 1024x1024 through `ops/attention.py:packed_attention`:
    the joint attention over 333 + 4096 tokens (not a multiple of 64) and
    the image-only one over 4096, 24 heads of 64, q and k RMS-normed per head
    by `ops/norms.py:rms_norm` as the MMDiT-X feeds them."""
    b, heads, d = 2, 24, 64
    w = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(dtype)
    q, k = (norms.rms_norm(_randn((b, tq, heads, d), gen, dtype), w, 1e-6).reshape(b, tq, -1)
            for _ in range(2))
    v = _randn((b, tq, heads * d), gen, dtype)
    ka.variant_launches.clear()
    out = packed_attention(q, k, v, heads)
    assert dict(ka.variant_launches) == {
        "wgmma" if dtype == torch.bfloat16 else "cuda_core": 1}
    _check(out, fused_attention_packed_plain(q, k, v, heads, d ** -0.5), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rms_norm_on_the_card(gen, dtype):
    """One `rms_norm` call at SD3's q shape against its definition, counted
    on its card route."""
    x = _randn((2, 4429, 24, 64), gen, dtype)
    w = (1 + 0.1 * torch.randn(64, generator=gen, device="cuda")).to(dtype)
    before = norms.route_counts["rms_norm", "plain_card"]
    out = norms.rms_norm(x, w, 1e-6)
    xf = x.float()
    _check(out, xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + 1e-6) * w.float(), dtype)
    assert norms.route_counts["rms_norm", "plain_card"] == before + 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_split_kernel_at_the_sd21_decode(gen, dtype):
    """The VAE mid-block of a 768x768 decode: 9216 tokens of 512 channels."""
    q, k, v = (_randn((1, 1, 9216, 512), gen, dtype) for _ in range(3))
    ka.variant_launches.clear()
    out = fused_attention(q, k, v, 512 ** -0.5)
    assert dict(ka.variant_launches) == {
        "wgmma_split" if dtype == torch.bfloat16 else "cuda_core": 1}
    _check(out, fused_attention_plain(q, k, v, 512 ** -0.5), dtype)


@pytest.mark.parametrize("s", [77, 4096 + 13])
@pytest.mark.parametrize("d", [40, 80, 160])
def test_wgmma_variant_ragged_keys(gen, d, s):
    """The wgmma variant at a key length that ends inside a tile (the
    zero-filled rows of the last tile are masked before the max), and, at
    Tq = 1000, a q tile that ends inside a warpgroup's rows."""
    tq = 1000 if d == 160 else 2048
    q = _randn((2, tq, 8 * d), gen, torch.bfloat16)
    k, v = (_randn((2, s, 8 * d), gen, torch.bfloat16) for _ in range(2))
    ka.variant_launches.clear()
    out = fused_attention_packed(q, k, v, 8, d ** -0.5)
    assert dict(ka.variant_launches) == {"wgmma": 1}
    _check(out, fused_attention_packed_plain(q, k, v, 8, d ** -0.5), torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_packed_kernel_reads_fused_qkv_views(gen, dtype):
    """q, k, v as column views of one (B, T, 3C) projection."""
    qkv = _randn((2, 1024, 3 * 640), gen, dtype)
    q, k, v = qkv.chunk(3, dim=-1)
    out = fused_attention_packed(q, k, v, 8, 80 ** -0.5)
    _check(out, fused_attention_packed_plain(q, k, v, 8, 80 ** -0.5), dtype)


def test_packed_kernel_unaligned_views(gen):
    """Rows that do not start on 16 bytes take the CUDA-core variant."""
    q, k, v = (_randn((2, 1024, 641), gen, torch.bfloat16)[..., 1:]
               for _ in range(3))  # odd token stride and offset
    ka.variant_launches.clear()
    out = fused_attention_packed(q, k, v, 8, 80 ** -0.5)
    assert dict(ka.variant_launches) == {"cuda_core": 1}
    _check(out, fused_attention_packed_plain(q, k, v, 8, 80 ** -0.5),
           torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_split_kernel_matches_plain(gen, dtype):
    q, k, v = (_randn((1, 1, 4096, 512), gen, dtype) for _ in range(3))
    dispatch.reset_launches()
    ka.variant_launches.clear()
    out = fused_attention(q, k, v, 512 ** -0.5)
    assert dispatch.launches["fused_attention"] == 1
    assert dict(ka.variant_launches) == {
        "wgmma_split" if dtype == torch.bfloat16 else "cuda_core": 1}
    _check(out, fused_attention_plain(q, k, v, 512 ** -0.5), dtype)


def test_split_wgmma_variant_ragged_queries(gen):
    """d = 512 in bf16 with a last q tile of 40 rows (Tq = 4096 - 24)."""
    q = _randn((1, 1, 4096 - 24, 512), gen, torch.bfloat16)
    k, v = (_randn((1, 1, 4096, 512), gen, torch.bfloat16) for _ in range(2))
    ka.variant_launches.clear()
    out = fused_attention(q, k, v, 512 ** -0.5)
    assert dict(ka.variant_launches) == {"wgmma_split": 1}
    _check(out, fused_attention_plain(q, k, v, 512 ** -0.5), torch.bfloat16)


def test_split_kernel_unaligned_bf16_takes_cuda_cores(gen):
    q, k, v = (_randn((1, 1, 1024, 513), gen, torch.bfloat16)[..., 1:]
               for _ in range(3))
    ka.variant_launches.clear()
    out = fused_attention(q, k, v, 512 ** -0.5)
    assert dict(ka.variant_launches) == {"cuda_core": 1}
    _check(out, fused_attention_plain(q, k, v, 512 ** -0.5), torch.bfloat16)


def test_variant_that_does_not_take_the_arguments_raises(gen):
    """No silent switch: a tensor-core variant asked for fp32, or for the
    wrong head dim, is an error."""
    q = _randn((1, 1, 1024, 512), gen, torch.float32)
    with pytest.raises(RuntimeError, match="wgmma_split"):
        ka._split_launch(q, q, q, 512 ** -0.5, "wgmma_split")
    h = _randn((1, 1024, 320), gen, torch.bfloat16)
    with pytest.raises(RuntimeError, match="wgmma_split"):
        ka._packed_launch(h, h, h, 8, 40 ** -0.5, "fused_attention_packed",
                          "wgmma_split")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stream_entry_matches_chunked_plain(gen, dtype):
    """The streaming entry at a multi-tile S (self-attention, d = 40), held
    against its plain version in 512-row chunks; counted on its own."""
    q, k, v = (_randn((2, 2048, 320), gen, dtype) for _ in range(3))
    dispatch.reset_launches()
    out = fused_attention_packed_stream(q, k, v, 8, 40 ** -0.5)
    assert dispatch.launches["fused_attention_packed_stream"] == 1
    assert dispatch.launches["fused_attention_packed"] == 0
    _check(out, fused_attention_packed_stream_plain(q, k, v, 8, 40 ** -0.5, rows=512),
           dtype)


def test_kernel_rejects_what_it_does_not_take(gen):
    q = _randn((1, 1024, 96), gen, torch.bfloat16)  # d = 48
    with pytest.raises(ValueError, match="head dim"):
        fused_attention_packed(q, q, q, 2, 48 ** -0.5)
    h = _randn((1, 1024, 80), gen, torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_attention_packed(h, h, h, 1, 80 ** -0.5)


def _affine(c, gen, dtype):
    return (_randn((c,), gen, torch.float32) * 0.1 + 1).to(dtype), \
        (_randn((c,), gen, torch.float32) * 0.1).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("shape,swish", [((2, 320, 64, 64), True),
                                         ((2, 1280, 16, 16), False)])
def test_group_norm_kernel_matches_plain(gen, dtype, channels_last, shape, swish):
    x = _randn(shape, gen, dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    w, b = _affine(shape[1], gen, dtype)
    dispatch.reset_launches()
    out = kg.fused_group_norm(x, w, b, 32, 1e-5, swish)
    assert dispatch.launches["fused_group_norm"] == 1
    assert out.stride() == x.stride()
    _check(out, kg.fused_group_norm_plain(x, w, b, 32, 1e-5, swish), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_group_norm_two_pass_kernels_match_plain(gen, dtype):
    x = _randn((2, 960, 64, 64), gen, dtype).contiguous(
        memory_format=torch.channels_last)
    w, b = _affine(960, gen, dtype)
    rows = kg.chunk_rows(x, 32)
    dispatch.reset_launches()
    parts = kg.group_norm_stats(x, 32, rows)
    ref = kg.group_norm_stats_plain(x, 32, rows)
    assert (parts - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    out = kg.group_norm_apply(x, ref, w, b, rows, 1e-6, True)
    _check(out, kg.group_norm_apply_plain(x, ref, w, b, 1e-6, True), dtype)
    assert dispatch.launches["group_norm_stats"] == 1
    assert dispatch.launches["group_norm_apply"] == 1
    assert dispatch.launches["fused_group_norm"] == 0
    two_pass = kg.fused_group_norm(x, w, b, 32, 1e-6, True)  # outside the gate
    _check(two_pass, kg.fused_group_norm_plain(x, w, b, 32, 1e-6, True), dtype)


def test_group_norm_kernel_is_deterministic(gen):
    x = _randn((2, 640, 32, 32), gen, torch.bfloat16)
    w, b = _affine(640, gen, torch.bfloat16)
    a = kg.fused_group_norm(x, w, b, 32, 1e-5, True)
    assert torch.equal(a, kg.fused_group_norm(x, w, b, 32, 1e-5, True))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("shape,swish,groups", GN_SITES,
                         ids=[f"{s[1]}x{s[2]}x{s[3]}-{sw}" for s, sw, _ in GN_SITES])
def test_group_norm_kernel_at_the_main_path_shapes(gen, dtype, channels_last, shape,
                                                   swish, groups):
    x = _randn(shape, gen, dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    w, b = _affine(shape[1], gen, dtype)
    kg.plan_launches.clear()
    out = kg.fused_group_norm(x, w, b, groups, 1e-5, swish)
    assert dict(kg.plan_launches) == {
        kg.group_norm_plan(shape, groups, dtype, channels_last): 1}
    assert out.stride() == x.stride()
    _check(out, kg.fused_group_norm_plain(x, w, b, groups, 1e-5, swish), dtype)
    assert torch.equal(out, kg.fused_group_norm(x, w, b, groups, 1e-5, swish))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("shape,groups", [((2, 960, 32, 32), 32), ((1, 96, 24, 40), 8),
                                          ((2, 33, 7, 9), 3)])
def test_group_norm_every_cluster_size(gen, dtype, channels_last, cluster, shape, groups):
    """Each cluster size forced once: 4-byte accesses at 60-byte runs, a
    ragged last block (960 rows over 8 blocks of 120; 63 rows over 8 of 8),
    and element accesses at an odd run length."""
    x = _randn(shape, gen, dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    w, b = _affine(shape[1], gen, dtype)
    plan = kg.group_norm_plan(shape, groups, dtype, channels_last, cluster=cluster)
    assert plan.cluster == cluster
    out = kg.fused_group_norm(x, w, b, groups, 1e-5, True, plan=plan)
    _check(out, kg.fused_group_norm_plain(x, w, b, groups, 1e-5, True), dtype)
    assert torch.equal(out, kg.fused_group_norm(x, w, b, groups, 1e-5, True, plan=plan))


def test_group_norm_slab_read_twice(gen):
    """A group too large for the cluster's shared memory (one group of 1M
    elements in fp32) is read again for the normalisation."""
    x = _randn((1, 64, 128, 128), gen, torch.float32).contiguous(
        memory_format=torch.channels_last)
    w, b = _affine(64, gen, torch.float32)
    plan = kg.group_norm_plan(x.shape, 1, x.dtype, True)
    assert not plan.keep and plan.cluster == 8
    out = kg.fused_group_norm(x, w, b, 1, 1e-5, True, plan=plan)
    _check(out, kg.fused_group_norm_plain(x, w, b, 1, 1e-5, True), torch.float32)


def test_group_norm_plan_that_does_not_fit_raises(gen):
    x = _randn((2, 320, 32, 32), gen, torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    w, b = _affine(320, gen, torch.bfloat16)
    good = kg.group_norm_plan(x.shape, 32, x.dtype, True)
    for bad in (good._replace(vec=4),        # 10 channels a group: 4 does not divide
                good._replace(cluster=3),    # not a power of two
                good._replace(cluster=16),   # beyond the portable cluster size
                good._replace(rows=100),     # 2 x 100 rows do not cover 1024
                kg.NormPlan(2, 1, 1024, True)._replace(vec=16)):
        with pytest.raises(RuntimeError, match="group norm"):
            kg.fused_group_norm(x, w, b, 32, 1e-5, True, plan=bad)
    big = _randn((1, 64, 128, 128), gen, torch.float32)
    wb, bb = _affine(64, gen, torch.float32)
    with pytest.raises(RuntimeError, match="group norm"):  # 4 MB do not fit one block
        kg.fused_group_norm(big, wb, bb, 1, 1e-5, True, plan=kg.NormPlan(4, 1, 16384, True))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 4096, 320), (2, 256, 1280), (3, 77, 768)])
def test_layer_norm_kernel_matches_plain(gen, dtype, shape):
    x = _randn(shape, gen, dtype)
    w, b = _affine(shape[-1], gen, dtype)
    dispatch.reset_launches()
    out = kl.fused_layer_norm(x, w, b, 1e-5)
    assert dispatch.launches["fused_layer_norm"] == 1
    _check(out, kl.fused_layer_norm_plain(x, w, b, 1e-5), dtype)


# the gated LayerNorm shapes of a 512x512 step and of the 1024x1024 hires pass
LN_SHAPES = [(2, 4096, 320), (2, 1024, 640), (2, 256, 1280),
             (2, 16384, 320), (2, 4096, 640), (2, 1024, 1280)]


def _layer_norm_plans(rows, c, dtype, aligned=True):
    """Every way to share a row that holds it in registers, at three block
    widths, with and without a second round of rows; and the read-twice
    walk."""
    vec = kl.layer_norm_plan(rows, c, dtype, dtype, aligned).vec
    plans = set()
    for tpr in kl.row_threads(c // vec):
        if -(-(c // vec) // tpr) > kl.MAX_VECTORS:
            continue
        for threads in (128, 256, 512):
            if tpr > threads:
                continue
            for loop in (1, 2):
                plans.add(kl.layer_norm_plan(rows, c, dtype, dtype, aligned, tpr,
                                             threads, loop))
    plans.add(kl.layer_norm_plan(rows, c, dtype, dtype, aligned, 32)._replace(vectors=0))
    plans.add(kl.layer_norm_plan(rows, c, dtype, dtype, aligned, 128, 256)._replace(vectors=0))
    return sorted(plans)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", LN_SHAPES + [(3, 77, 768), (5, 7, 333), (2, 9, 40)])
def test_layer_norm_every_plan(gen, dtype, shape):
    """Each plan forced once per shape (the six main-path shapes, the CLIP
    tower's, and ragged rows that no vector divides): against the plain
    version, and equal bytes from two runs."""
    x = _randn(shape, gen, dtype)
    w, b = _affine(shape[-1], gen, dtype)
    ref = kl.fused_layer_norm_plain(x, w, b, 1e-5)
    rows = x.numel() // shape[-1]
    plans = _layer_norm_plans(rows, shape[-1], dtype)
    assert len(plans) >= 3
    for plan in plans:
        kl.plan_launches.clear()
        out = kl.fused_layer_norm(x, w, b, 1e-5, plan=plan)
        assert dict(kl.plan_launches) == {plan: 1}
        _check(out, ref, dtype)
        assert torch.equal(out, kl.fused_layer_norm(x, w, b, 1e-5, plan=plan)), plan
    # the plan the shape gives is one the wrapper runs by itself
    kl.plan_launches.clear()
    out = kl.fused_layer_norm(x, w, b, 1e-5)
    assert dict(kl.plan_launches) == {kl.layer_norm_plan(rows, shape[-1], dtype, dtype): 1}
    _check(out, ref, dtype)


def test_layer_norm_mixed_dtypes_and_unaligned_views(gen):
    """bf16 x with fp32 gamma and beta (32-byte vectors of gamma: two
    accesses), and an x that starts 2 bytes off 16: element accesses."""
    x = _randn((2, 1024, 640), gen, torch.bfloat16)
    w, b = _affine(640, gen, torch.float32)
    _check(kl.fused_layer_norm(x, w, b, 1e-5), kl.fused_layer_norm_plain(x, w, b, 1e-5),
           torch.bfloat16)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")[1:].view(x.shape)
    shifted.copy_(x)
    kl.plan_launches.clear()
    out = kl.fused_layer_norm(shifted, w, b, 1e-5)
    assert [plan.vec for plan in kl.plan_launches] == [1]
    _check(out, kl.fused_layer_norm_plain(x, w, b, 1e-5), torch.bfloat16)


def test_layer_norm_plan_that_does_not_fit_raises(gen):
    x = _randn((2, 1024, 640), gen, torch.bfloat16)
    w, b = _affine(640, gen, torch.bfloat16)
    good = kl.layer_norm_plan(2048, 640, x.dtype, w.dtype)
    for bad in (good._replace(vec=16),              # beyond 16 bytes
                good._replace(vec=3),               # does not divide 640
                good._replace(threads_per_row=24),  # neither a power of two nor warps
                good._replace(threads_per_row=8),   # 8 x 3 vectors do not cover 80
                good._replace(vectors=4),           # more than a thread holds
                good._replace(rows_par=64),         # 2048 threads
                good._replace(rows_block=good.rows_par + 1)):
        with pytest.raises(RuntimeError, match="layer norm"):
            kl.fused_layer_norm(x, w, b, 1e-5, plan=bad)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")[1:].view(x.shape)
    with pytest.raises(RuntimeError, match="layer norm"):  # 16-byte accesses off 16
        kl.fused_layer_norm(shifted, w, b, 1e-5, plan=good)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,groups,swish", [
    ((1, 128, 256, 256), 32, True),   # 4 channels a group: two groups a vector
    ((2, 960, 64, 64), 32, True),     # 30 a group: boundaries inside vectors
    ((2, 960, 64, 64), 32, False),
    ((1, 96, 24, 40), 8, True),       # a block of 288 threads, a ragged last tile
    ((2, 33, 7, 9), 3, True),         # no block is whole rows: the column moves
    ((3, 64, 5, 5), 32, False),
])
def test_group_norm_apply_by_rows_equals_by_groups(gen, dtype, shape, groups, swish):
    """Channels-last: the rows x channels kernel against the plain version,
    equal bytes from two runs, and equal bytes to the (sample, group, chunk)
    kernel forced on the same inputs (the same partials added in the same
    order, the same arithmetic per element)."""
    x = _randn(shape, gen, dtype).contiguous(memory_format=torch.channels_last)
    w, b = _affine(shape[1], gen, dtype)
    rows = max(1, min(kg.chunk_rows(x, groups), shape[2] * shape[3] // 3))
    parts = kg.group_norm_stats(x, groups, rows)
    assert parts.shape[2] >= 3
    by_rows = kg.apply_plan(shape, groups, dtype, True, rows)
    by_groups = kg.apply_plan(shape, groups, dtype, True, rows, by_rows=False)
    assert by_rows.by_rows and not by_groups.by_rows
    kg.apply_plan_launches.clear()
    dispatch.reset_launches()
    out = kg.group_norm_apply(x, parts, w, b, rows, 1e-6, swish)
    assert dict(kg.apply_plan_launches) == {by_rows: 1}
    assert dispatch.launches["group_norm_apply"] == 1
    assert out.stride() == x.stride()
    _check(out, kg.group_norm_apply_plain(x, parts, w, b, 1e-6, swish), dtype)
    assert torch.equal(out, kg.group_norm_apply(x, parts, w, b, rows, 1e-6, swish))
    old = kg.group_norm_apply(x, parts, w, b, rows, 1e-6, swish, plan=by_groups)
    assert torch.equal(out, old)
    # other tiles and block widths give the same bytes
    for plan in (by_rows._replace(tile_rows=1), by_rows._replace(tile_rows=7),
                 by_rows._replace(threads=128), by_rows._replace(threads=512, tile_rows=3),
                 by_rows._replace(vec=1)):
        assert torch.equal(out, kg.group_norm_apply(x, parts, w, b, rows, 1e-6, swish,
                                                    plan=plan)), plan


def test_group_norm_apply_nchw_keeps_the_group_kernel(gen):
    x = _randn((2, 960, 64, 64), gen, torch.bfloat16)
    w, b = _affine(960, gen, torch.bfloat16)
    rows = kg.chunk_rows(x, 32)
    parts = kg.group_norm_stats_plain(x, 32, rows)
    kg.apply_plan_launches.clear()
    out = kg.group_norm_apply(x, parts, w, b, rows, 1e-6, True)
    assert [plan.by_rows for plan in kg.apply_plan_launches] == [False]
    _check(out, kg.group_norm_apply_plain(x, parts, w, b, 1e-6, True), torch.bfloat16)


def test_group_norm_apply_plan_that_does_not_fit_raises(gen):
    x = _randn((2, 960, 64, 64), gen, torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    w, b = _affine(960, gen, torch.bfloat16)
    rows = kg.chunk_rows(x, 32)
    parts = kg.group_norm_stats_plain(x, 32, rows)
    good = kg.apply_plan(x.shape, 32, x.dtype, True, rows)
    old = kg.apply_plan(x.shape, 32, x.dtype, True, rows, by_rows=False)
    for bad in (good._replace(vec=16), good._replace(vec=7), good._replace(threads=1024),
                good._replace(threads=100), good._replace(tile_rows=0),
                old._replace(vec=4),          # 30 channels a group: 4 does not divide
                old._replace(threads=128), old._replace(tile_rows=rows + 1)):
        with pytest.raises(RuntimeError, match="group norm apply"):
            kg.group_norm_apply(x, parts, w, b, rows, 1e-6, True, plan=bad)
    with pytest.raises(RuntimeError, match="group norm apply"):  # NCHW memory by rows
        kg.group_norm_apply(x.contiguous(), parts, w, b, rows, 1e-6, True, plan=good)


def test_norm_kernels_reject_what_they_do_not_take(gen):
    x = _randn((2, 64, 16, 16), gen, torch.bfloat16)
    w, b = _affine(64, gen, torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        kg.fused_group_norm(x.transpose(2, 3), w, b, 32, 1e-5, True)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kg.fused_group_norm(x.half(), w, b, 32, 1e-5, True)
    with pytest.raises(ValueError, match="divisible"):
        kg.fused_group_norm(x, w, b, 48, 1e-5, True)
    t = _randn((2, 1024, 320), gen, torch.bfloat16)
    wt, bt = _affine(320, gen, torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        kl.fused_layer_norm(t.transpose(0, 1), wt, bt, 1e-5)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kl.fused_layer_norm(t.half(), wt.half(), bt.half(), 1e-5)


def _qmm_inputs(m, k, n, gen, dtype):
    w = torch.randn((n, k), generator=gen, device="cuda") * (0.5 / k ** 0.5)
    return (_randn((m, k), gen, dtype), *quantize_weights(w))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [
    (8192, 320, 2560), (2048, 2560, 640), (128, 5120, 1280),  # SD-1.5 GEGLU sites
    (40, 200, 384),  # M not a multiple of the tile, K not of 16 (element loads)
])
def test_quantized_matmul_matches_plain(gen, dtype, m, k, n):
    x, w_q, scale = _qmm_inputs(m, k, n, gen, dtype)
    dispatch.reset_launches()
    out = kq.quantized_matmul(x, w_q, scale)
    assert dispatch.launches["quantized_matmul"] == 1
    assert out.dtype == dtype and out.shape == (m, n)
    _check(out, kq.quantized_matmul_plain(x, w_q, scale), dtype)


@pytest.mark.parametrize("m,k,n", GEMMS, ids=[f"{m}x{k}x{n}" for m, k, n in GEMMS])
def test_quantized_matmul_at_the_main_path_shapes(gen, m, k, n):
    """Every gated GEMM of a 512x512 step in bf16: the wgmma variant under
    the plan the shape gives, and equal bytes from two runs."""
    x, w_q, scale = _qmm_inputs(m, k, n, gen, torch.bfloat16)
    kq.plan_launches.clear()
    out = kq.quantized_matmul(x, w_q, scale)
    plan = kq.matmul_plan(m, k, n, torch.bfloat16)
    assert plan.variant == "wgmma" and dict(kq.plan_launches) == {plan: 1}
    _check(out, kq.quantized_matmul_plain(x, w_q, scale), torch.bfloat16)
    assert torch.equal(out, kq.quantized_matmul(x, w_q, scale))


@pytest.mark.parametrize("m,k,n,variant", [
    (8, 64, 128, "wgmma"), (136, 1024, 256, "wgmma"),  # M inside a tile
    (40, 208, 384, "wgmma"), (136, 1040, 128, "wgmma"),  # K inside a slice
    (8, 24, 128, "mma_sync"), (136, 100, 384, "mma_sync"),  # K % 16 != 0
])
def test_quantized_matmul_ragged_shapes(gen, m, k, n, variant):
    x, w_q, scale = _qmm_inputs(m, k, n, gen, torch.bfloat16)
    kq.plan_launches.clear()
    out = kq.quantized_matmul(x, w_q, scale)
    assert [plan.variant for plan in kq.plan_launches] == [variant]
    _check(out, kq.quantized_matmul_plain(x, w_q, scale), torch.bfloat16)


def test_quantized_matmul_unaligned_view_takes_mma_sync(gen):
    x, w_q, scale = _qmm_inputs(64, 256, 128, gen, torch.bfloat16)
    shifted = torch.empty(64 * 256 + 1, dtype=torch.bfloat16, device="cuda")[1:].view(64, 256)
    shifted.copy_(x)  # rows start 2 bytes off 16
    kq.plan_launches.clear()
    out = kq.quantized_matmul(shifted, w_q, scale)
    assert [plan.variant for plan in kq.plan_launches] == ["mma_sync"]
    _check(out, kq.quantized_matmul_plain(x, w_q, scale), torch.bfloat16)


@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("tm,bn", [(128, 128), (128, 64), (64, 128), (64, 64)])
def test_quantized_matmul_every_plan(gen, tm, bn, split):
    """Each tile and each K split forced once, at a shape with a ragged last
    x tile (M = 200) and a last slice of 16 (K = 1040: 17 slices, so the last
    block of a split of 8 has none); two runs give equal bytes."""
    x, w_q, scale = _qmm_inputs(200, 1040, 256, gen, torch.bfloat16)
    plan = kq.Plan("wgmma", tm, bn, split, 4)
    out = kq._launch(x, w_q, scale, plan)
    _check(out, kq.quantized_matmul_plain(x, w_q, scale), torch.bfloat16)
    assert torch.equal(out, kq._launch(x, w_q, scale, plan))


def test_quantized_matmul_plan_that_does_not_fit_raises(gen):
    """No silent switch: the C entry refuses a plan that does not take the
    arguments."""
    x, w_q, scale = _qmm_inputs(64, 256, 256, gen, torch.bfloat16)
    good = kq.matmul_plan(64, 256, 256, torch.bfloat16)
    for bad in (good._replace(bn=256), good._replace(tm=32), good._replace(split=3),
                good._replace(stages=3), good._replace(variant="cuda_core"),
                kq.Plan("mma_sync", 128, 128, 2, 1)):
        with pytest.raises(RuntimeError, match="quantized matmul"):
            kq._launch(x, w_q, scale, bad)
    with pytest.raises(RuntimeError, match="wgmma"):  # fp32 x
        kq._launch(x.float(), w_q, scale, good)
    x24, w24, s24 = _qmm_inputs(64, 24, 128, gen, torch.bfloat16)
    with pytest.raises(RuntimeError, match="wgmma"):  # K % 16 != 0
        kq._launch(x24, w24, s24, good)


def test_quantized_matmul_rejects_what_it_does_not_take(gen):
    x, w_q, scale = _qmm_inputs(64, 256, 256, gen, torch.bfloat16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kq.quantized_matmul(x.half(), w_q, scale)
    with pytest.raises(TypeError, match="int8"):
        kq.quantized_matmul(x, w_q.float(), scale)
    with pytest.raises(ValueError, match="N % 128"):
        kq.quantized_matmul(x, w_q[:192].contiguous(), scale[:192].contiguous())
    with pytest.raises(ValueError, match="M % 8"):
        kq.quantized_matmul(x[:12], w_q, scale)
    with pytest.raises(ValueError, match="contiguous"):
        kq.quantized_matmul(_randn((256, 64), gen, torch.bfloat16).t(), w_q, scale)


# ------------------------------------------------- GroupNorm stats, by rows


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,groups", [
    ((1, 128, 256, 256), 32),   # 4 channels a group: two groups a vector
    ((2, 960, 64, 64), 32),     # 30 a group: boundaries inside vectors
    ((1, 96, 24, 40), 8),       # a block of 288 threads, a ragged last chunk
    ((3, 64, 5, 5), 32),        # more thread rows than spatial rows
    ((2, 33, 7, 9), 3),         # no block of whole rows: the group kernel stays
])
def test_group_norm_stats_every_plan(gen, dtype, shape, groups):
    """Channels-last: the plan `stats_plan` picks, each cluster size forced
    and the (sample, group, chunk) kernel forced, against the plain version
    (1e-5 x max |plain|: fp32 sums in another order), and two runs of each
    equal in bytes."""
    x = _randn(shape, gen, dtype).contiguous(memory_format=torch.channels_last)
    rows = max(1, min(kg.chunk_rows(x, groups), shape[2] * shape[3] // 3))
    ref = kg.group_norm_stats_plain(x, groups, rows)
    tol = 1e-5 * ref.abs().max().item()
    auto = kg.stats_plan(shape, groups, dtype, True, rows)
    kg.stats_plan_launches.clear()
    dispatch.reset_launches()
    out = kg.group_norm_stats(x, groups, rows)
    assert dict(kg.stats_plan_launches) == {auto: 1}
    assert dispatch.launches["group_norm_stats"] == 1
    assert out.shape == ref.shape and (out - ref).abs().max().item() <= tol
    plans = [kg.stats_plan(shape, groups, dtype, True, rows, by_rows=False)]
    if shape[1] != 33:
        by_rows = kg.stats_plan(shape, groups, dtype, True, rows, by_rows=True)
        assert auto == (by_rows if shape[1] // groups * x.element_size() < 32
                        else plans[0])
        plans += [by_rows._replace(cluster=c) for c in (1, 2, 4, 8)]
        plans += [by_rows._replace(vec=1, threads=t) for t in range(32, 513, 32)
                  if t % shape[1] == 0][:1]
    for plan in plans:
        got = kg.group_norm_stats(x, groups, rows, plan=plan)
        assert (got - ref).abs().max().item() <= tol, plan
        assert torch.equal(got, kg.group_norm_stats(x, groups, rows, plan=plan)), plan


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", chip_smoke.APPLY_SHAPES, ids=["128x512x512", "960x64x64"])
def test_group_norm_stats_at_the_large_slabs(gen, dtype, shape):
    x = _randn(shape, gen, dtype).contiguous(memory_format=torch.channels_last)
    rows = kg.chunk_rows(x, 32)
    ref = kg.group_norm_stats_plain(x, 32, rows)
    kg.stats_plan_launches.clear()
    out = kg.group_norm_stats(x, 32, rows)
    # by rows where a group's run is narrower than a sector
    assert [p.by_rows for p in kg.stats_plan_launches] == [shape[1] == 128]
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    assert torch.equal(out, kg.group_norm_stats(x, 32, rows))
    # NCHW memory keeps the (sample, group, chunk) kernel
    kg.stats_plan_launches.clear()
    nchw = kg.group_norm_stats(x.contiguous(), 32, rows)
    assert [p.by_rows for p in kg.stats_plan_launches] == [False]
    assert (nchw - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def test_group_norm_stats_plan_that_does_not_fit_raises(gen):
    x = _randn((2, 960, 64, 64), gen, torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    rows = kg.chunk_rows(x, 32)
    good = kg.stats_plan(x.shape, 32, x.dtype, True, rows, by_rows=True)
    old = kg.stats_plan(x.shape, 32, x.dtype, True, rows, by_rows=False)
    for bad in (good._replace(vec=16), good._replace(vec=7), good._replace(threads=1024),
                good._replace(threads=256),   # not whole rows of 120 vectors
                good._replace(cluster=3), good._replace(cluster=16),
                good._replace(cluster=0),
                old._replace(vec=4),          # 30 channels a group: 4 does not divide
                old._replace(threads=128), old._replace(cluster=2)):
        with pytest.raises(RuntimeError, match="group norm stats"):
            kg.group_norm_stats(x, 32, rows, plan=bad)
    with pytest.raises(RuntimeError, match="group norm stats"):  # NCHW memory by rows
        kg.group_norm_stats(x.contiguous(), 32, rows, plan=good)


# ------------------------------------------------------------ captured engines


def _tiny_runtime(dtype="bfloat16", model_channels=None, tome_min_tokens=None, **kwargs):
    """tiny_pipeline() on the card, weights from seed 0. model_channels=80:
    head dim 40 at level 0, which the attention kernel takes (the tiny
    config's 16 it does not; at 64x64 no site has the tokens to reach it).
    tome_min_tokens: ToMe's site threshold (64: the 8x8 sites of a 64x64
    image merge)."""
    import dataclasses

    from stablediffusioneo_tpu_torch.config import ControlNetConfig, tiny_pipeline
    from stablediffusioneo_tpu_torch.models.cldm import ControlLDM, init_weights
    from stablediffusioneo_tpu_torch.runtime.engine import CNSDRuntime

    cfg = dataclasses.replace(tiny_pipeline(), dtype=dtype)
    if model_channels or tome_min_tokens:
        unet = dataclasses.replace(cfg.unet, model_channels=model_channels
                                   or cfg.unet.model_channels,
                                   tome_min_tokens=tome_min_tokens or cfg.unet.tome_min_tokens)
        cfg = dataclasses.replace(cfg, unet=unet, controlnet=ControlNetConfig(unet=unet))
    model = ControlLDM(cfg).to("cuda")
    init_weights(model, torch.Generator(device="cuda").manual_seed(0))
    return cfg, CNSDRuntime(model, cfg, device="cuda", **kwargs)


def _tiny_inputs(cfg, gen, batch=1, res=64):
    ctx = _randn((2 * batch, cfg.clip.max_length, cfg.unet.context_dim), gen, torch.float32)
    hint = (torch.rand((batch, res, res, 3), generator=gen, device="cuda") > 0.7
            ).to(torch.uint8) * 255
    x_T = _randn((batch, res // 8, res // 8, 4), gen, torch.float32)
    return x_T, hint, ctx[:batch], ctx[batch:]


@pytest.mark.parametrize("kwargs", [
    {}, {"eta": 0.5}, {"guess_mode": True, "strength": 0.7},
    {"encoder_cache_interval": 2}, {"cfg_rescale": 0.7},
], ids=["default", "eta", "guess", "enc_cache", "cfg_rescale"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_engine_replay_equals_eager(gen, dtype, kwargs):
    """Tiny config: a captured engine's replays against the eager loop on the
    same inputs and noise: equal bytes (the same kernels in the same order),
    also for a second request through the same graph; and the fused engine
    against the granular path."""
    cfg, rt = _tiny_runtime(dtype)
    assert rt.capturing
    for seed in (3, 4):
        x_T, hint, ctx_c, ctx_u = _tiny_inputs(cfg, gen)
        g = lambda: torch.Generator(device="cuda").manual_seed(seed)
        rt.graphs = None
        img = rt.sample_decode(4, x_T, hint, ctx_c, ctx_u, generator=g(), **kwargs)
        z = rt.last_latents
        granular = rt.decode_latent_device(
            rt.sample(4, x_T, hint, ctx_c, ctx_u, generator=g(), **kwargs))
        rt.graphs = False
        eager = rt.sample_decode(4, x_T, hint, ctx_c, ctx_u, generator=g(), **kwargs)
        assert torch.isfinite(z).all() and img.shape == (1, 64, 64, 3)
        assert torch.equal(z, rt.last_latents)
        assert torch.equal(img, eager) and torch.equal(img, granular)
    compiled = [e.get_engine_infor()["compiled"] for e in rt._engines.values()]
    assert sorted(compiled) == [False, True, True, True]
    lines = rt.report().splitlines()
    assert len(lines) == 4 and sum("device ops, pool" in line for line in lines) == 3
    rt.graphs = None
    assert rt.warmup(resolution=64, num_steps=2) == (1, 64, 64, 3)
    rt.release()
    assert rt._engines == {}


@pytest.mark.parametrize("kwargs", [
    {"sampler": "plms"}, {"sampler": "dpmpp-karras"}, {"sampler": "unipc"},
    {"sampler": "euler-a"}, {"sampler": "heun-uniform"}, {"tome_ratio": 0.5},
    {"sampler": "euler-a", "tome_ratio": 0.5, "guess_mode": True},
], ids=["plms", "dpmpp-karras", "unipc", "euler-a", "heun-uniform", "tome", "euler-a_tome_guess"])
def test_sampler_engine_replay_equals_eager(gen, kwargs):
    """Tiny config in bf16, ToMe's threshold at the 8x8 sites: the captured
    loop of each sampler (and with token merging) against the eager one on
    the same inputs and noise, equal bytes, for two requests through the
    same graph; Euler-a's noise drawn outside the graph from the generator."""
    cfg, rt = _tiny_runtime(tome_min_tokens=64)
    for seed in (3, 4):
        x_T, hint, ctx_c, ctx_u = _tiny_inputs(cfg, gen)
        outs = []
        for graphs in (None, False):
            rt.graphs = graphs
            outs.append(rt.sample_decode(
                4, x_T, hint, ctx_c, ctx_u,
                generator=torch.Generator(device="cuda").manual_seed(seed), **kwargs))
            assert torch.isfinite(rt.last_latents).all()
        assert torch.equal(*outs)
    assert sum(e.compiled for e in rt._engines.values()) == 1


def test_tome_merge_is_deterministic_on_the_card(gen):
    """build_merge at the SD-1.5 level-0 site in bf16 (2 x 4096 tokens of
    320 channels, 2048 merged): twice on the same metric, the merged and
    unmerged tensors are equal in bytes (the mean into the dst tokens is a
    matmul, not float atomics), and the merged length is the packed
    kernel's."""
    from stablediffusioneo_tpu_torch.ops.tome import build_merge, merge_count

    metric = _randn((2, 4096, 320), gen, torch.bfloat16)
    payload = _randn((2, 4096, 320), gen, torch.bfloat16)
    r = merge_count(64, 64, 0.5)
    outs = []
    for _ in range(2):
        merge, unmerge, n = build_merge(metric, 64, 64, r)
        merged = merge(payload)
        outs.append((merged, unmerge(merged)))
    assert n == 2048 and outs[0][0].shape == (2, 2048, 320)
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    assert torch.isfinite(outs[0][1].float()).all()


def test_engine_img2img_variant_replay_equals_eager(gen):
    cfg, rt = _tiny_runtime()
    x_T, hint, ctx_c, ctx_u = _tiny_inputs(cfg, gen)
    for seed in (5, 6):
        outs = []
        for graphs in (None, False):
            rt.graphs = graphs
            outs.append(rt.sample_decode(
                4, None, hint, ctx_c, ctx_u, init_latent=x_T, t_enc=3, eta=0.3,
                generator=torch.Generator(device="cuda").manual_seed(seed)))
        assert torch.equal(*outs)
    assert sorted(e.name for e in rt._engines.values()) == [
        "ddim+decode_3x1x64x64_genxT-img2img"] * 2


@pytest.mark.parametrize("flags", [{}, {"groupnorm": True, "layernorm": True}],
                         ids=["default", "fused_norms"])
def test_counters_after_a_replay_equal_the_captures(gen, flags):
    """256x256 at 80 channels, so that the level-0 sites (1024 tokens, head
    dim 40) reach the attention kernel: the counters after a replay equal an
    eager request's, the capture itself leaves them standing, and the latents
    are equal in bytes (the sampler engine: the tiny VAE's mid-block has a
    head dim the split kernel does not take)."""
    dispatch.set_kernels(**flags)
    try:
        cfg, rt = _tiny_runtime(model_channels=80)
        x_T, hint, ctx_c, ctx_u = _tiny_inputs(cfg, gen, res=256)
        counters = (ka.variant_launches, kg.plan_launches, kl.plan_launches,
                    kq.plan_launches, norms.route_counts)

        def request(graphs):
            rt.graphs = graphs
            dispatch.reset_launches()
            for c in counters:
                c.clear()
            z = rt.sample(3, x_T, hint, ctx_c, ctx_u)
            return z, dict(dispatch.launches), [dict(c) for c in counters]

        eager = request(False)
        first = request(None)    # the eager pass of load(), the capture, a replay
        replay = request(None)   # a replay alone
        assert eager[1]["fused_attention_packed"] > 0
        assert eager[2][0] == {"wgmma": eager[1]["fused_attention_packed"]}
        # the card's rule: the norms reach their kernels whatever the flags
        assert eager[1]["fused_group_norm"] > 0 and eager[1]["fused_layer_norm"] > 0
        assert {route for _, route in eager[2][4]} <= {"one_pass", "pair", "kernel"}
        assert replay[1:] == eager[1:]
        assert first[1] == {k: 2 * v for k, v in eager[1].items()}
        assert torch.equal(eager[0], replay[0]) and torch.equal(eager[0], first[0])
        info = next(e for e in rt._engines.values() if e.compiled).get_engine_infor()
        assert info["compile_seconds"] > 0 and info["memory"]["pool_bytes"] > 0
        assert info["device_ops"] > 100
    finally:
        dispatch.set_kernels(groupnorm=False, layernorm=False, int8_linear=False)


# GroupNorm sites the JAX package's VMEM gate kept on the plain path, which
# the card's rule sends to the kernels: SDXL's 128x128x320 and 64x64x640,
# SD-1.5's 64x64x960 and the VAE decoder's 512x512x128
GATE_REFUSED_GN = [((2, 320, 128, 128), True), ((2, 640, 64, 64), True),
                   ((2, 960, 64, 64), True), ((1, 128, 512, 512), True),
                   ((2, 640, 64, 64), False)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("shape,swish", GATE_REFUSED_GN,
                         ids=[f"{s[1]}x{s[2]}x{s[3]}-{sw}" for s, sw in GATE_REFUSED_GN])
def test_group_norm_route_at_the_sites_the_gate_refused(gen, dtype, channels_last, shape,
                                                        swish):
    """ops/norms.group_norm with the flags off, outside autograd, at the
    shapes the JAX gate refused: the stats + apply pair runs, held to fp32
    F.group_norm (+SiLU) of the same input, in either memory layout."""
    x = _randn(shape, gen, dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    w, b = _affine(shape[1], gen, dtype)
    assert not kg.group_norm_supported(shape, 32) and not dispatch.kernels_enabled("groupnorm")
    dispatch.reset_launches()
    norms.route_counts.clear()
    with torch.no_grad():
        out = norms.group_norm(x, w, b, 32, 1e-6, swish)
    assert dispatch.launches["group_norm_stats"] == dispatch.launches["group_norm_apply"] == 1
    assert dispatch.launches["fused_group_norm"] == 0
    assert norms.route_counts == {("group_norm", "pair"): 1}
    assert out.dtype == dtype and out.stride() == x.stride()
    ref = torch.nn.functional.group_norm(x.float(), 32, w.float(), b.float(), 1e-6)
    _check(out, torch.nn.functional.silu(ref) if swish else ref, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 77, 768), (2, 77, 1280), (2, 64, 1280), (2, 4096, 320)])
def test_layer_norm_route_at_every_size(gen, dtype, shape):
    """ops/norms.layer_norm with the flags off: CLIP's and bigG's towers and
    the 8x8 mid-block (under the JAX gate's 256K elements) reach the kernel
    too, held to fp32 F.layer_norm."""
    x = _randn(shape, gen, dtype)
    w, b = _affine(shape[-1], gen, dtype)
    dispatch.reset_launches()
    norms.route_counts.clear()
    with torch.no_grad():
        out = norms.layer_norm(x, w, b, 1e-5)
    assert dispatch.launches["fused_layer_norm"] == 1
    assert norms.route_counts == {("layer_norm", "kernel"): 1}
    _check(out, torch.nn.functional.layer_norm(x.float(), (shape[-1],), w.float(), b.float(),
                                               1e-5), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 4096, 1536), (2, 333, 1536)], ids=["image", "context"])
def test_layer_norm_without_affine_at_the_sd3_sites(gen, dtype, shape):
    """SD3's adaLN norm, `layer_norm(x, None, None, 1e-6)` at width 1536,
    over the image and the context tokens of a 1024x1024 evaluation: the
    kernel with `unit_affine` standing in, held to fp32 F.layer_norm without
    affine."""
    x = _randn(shape, gen, dtype)
    dispatch.reset_launches()
    norms.route_counts.clear()
    with torch.no_grad():
        out = norms.layer_norm(x, None, None, 1e-6)
    assert dispatch.launches["fused_layer_norm"] == 1
    assert norms.route_counts == {("layer_norm", "kernel"): 1}
    _check(out, torch.nn.functional.layer_norm(x.float(), (shape[-1],), None, None, 1e-6),
           dtype)


def test_norm_routes_that_stay_plain_on_the_card(gen):
    """A strided input and a call under autograd run the plain norms on the
    card, raising nothing, with the flags off."""
    x = _randn((2, 320, 32, 32), gen, torch.bfloat16)
    w, b = _affine(320, gen, torch.bfloat16)
    t = _randn((77, 2, 768), gen, torch.bfloat16).transpose(0, 1)
    wt, bt = _affine(768, gen, torch.bfloat16)
    dispatch.reset_launches()
    norms.route_counts.clear()
    with torch.no_grad():
        strided = norms.group_norm(x.transpose(2, 3), w, b, 32, 1e-5, True)
        ln = norms.layer_norm(t, wt, bt, 1e-5)
    xg = x.detach().requires_grad_()
    norms.group_norm(xg, w, b, 32, 1e-5, True).float().sum().backward()
    assert torch.isfinite(xg.grad.float()).all()
    assert dispatch.launches == {name: 0 for name in dispatch.KERNELS}
    assert norms.route_counts == {("group_norm", "plain_refused"): 1,
                                  ("layer_norm", "plain_refused"): 1,
                                  ("group_norm", "plain_grad"): 1}
    ref = torch.nn.functional.group_norm(x.transpose(2, 3).float(), 32, w.float(), b.float(),
                                         1e-5)
    _check(strided, torch.nn.functional.silu(ref), torch.bfloat16)
    _check(ln, torch.nn.functional.layer_norm(t.float(), (768,), wt.float(), bt.float(), 1e-5),
           torch.bfloat16)


def test_a_flagged_layer_norm_under_grad_counts_as_the_kernel_it_launches(gen):
    """Under autograd with the layernorm flag on, a gated LayerNorm launches
    the kernel through its autograd Function, and route_counts says so
    (kernel); the gradient flows."""
    x = _randn((2, 4096, 320), gen, torch.bfloat16).requires_grad_()
    w, b = _affine(320, gen, torch.bfloat16)
    dispatch.reset_launches()
    norms.route_counts.clear()
    dispatch.set_kernels(layernorm=True)
    try:
        norms.layer_norm(x, w, b, 1e-5).float().sum().backward()
    finally:
        dispatch.set_kernels(layernorm=False)
    assert torch.isfinite(x.grad.float()).all()
    assert dispatch.launches["fused_layer_norm"] == 1
    assert norms.route_counts == {("layer_norm", "kernel"): 1}


def test_captured_sd15_request_reaches_no_plain_norm(gen):
    """A full-width SD-1.5 ControlNet request at 512x512 in bf16 through the
    captured sample+decode engine, the flags off: every norm call of the
    replay counts under a kernel route, as many as the plan lists (steps x
    the step's sites + the decode's), and none under plain_*."""
    from stablediffusioneo_tpu_torch.runtime.engine import CNSDRuntime

    cfg, steps = sd15_pipeline(), 2
    rt = CNSDRuntime(chip_smoke.build_model(cfg, seed=0), cfg, device="cuda")
    x_T, hint, ctx_c, ctx_u = _tiny_inputs(cfg, gen, res=512)
    sites = chip_smoke.norm_sites(cfg, 512)
    for _ in range(2):  # the load's eager pass, the capture and a replay; a replay
        norms.route_counts.clear()
        img = rt.sample_decode(steps, x_T, hint, ctx_c, ctx_u)
    assert img.shape == (1, 512, 512, 3) and torch.isfinite(rt.last_latents).all()
    assert any(e.compiled for e in rt._engines.values())
    assert {route for _, route in norms.route_counts} == {"one_pass", "pair", "kernel"}
    assert sum(norms.route_counts.values()) == steps * len(sites["step"]) + len(sites["decode"])
    rt.release()


def test_a_capture_copies_its_arguments_into_contiguous_buffers(gen):
    """A captured engine's static buffers are contiguous whatever the first
    call's layout, as an eager engine's copies are, so the GroupNorm kernel,
    which keeps its input's layout, sums in one order in both and a replay
    equals an eager call in bytes (an NHWC view of NCHW memory here)."""
    from stablediffusioneo_tpu_torch.runtime.engine import Engine

    w, b = _affine(320, gen, torch.bfloat16)

    def fn(x):  # NHWC in, as the engines take their latents
        with torch.no_grad():
            return norms.group_norm(x.permute(0, 3, 1, 2), w, b, 32, 1e-5, True)

    x = _randn((2, 320, 32, 32), gen, torch.bfloat16).permute(0, 2, 3, 1)
    assert not x.is_contiguous()
    captured = Engine(fn, capture=True)
    out = captured(x).clone()
    assert captured.compiled and all(buf.is_contiguous() for buf in captured._inputs)
    assert torch.equal(out, Engine(fn)(x))


def test_an_eager_engine_takes_the_buffers_layout(gen):
    """An argument that is contiguous but carries other strides on a size-1
    dim (depth2img's (B, h, w, 1) depth channel, a permuted view) reaches an
    eager engine's function in the strides a captured engine's static
    buffer has, so that torch.cat takes one layout in both (channels-last
    here, NCHW from the view) and a replay equals an eager call in bytes."""
    from stablediffusioneo_tpu_torch.runtime.engine import Engine

    w, b = _affine(321, gen, torch.bfloat16)

    def fn(x, depth):  # NHWC in; the depth channel joined as a concat UNet's input is
        with torch.no_grad():
            h = torch.cat([x.permute(0, 3, 1, 2), depth.permute(0, 3, 1, 2)], dim=1)
            return norms.group_norm(h, w, b, 3, 1e-5, True)

    x = _randn((2, 32, 32, 320), gen, torch.bfloat16)
    depth = _randn((2, 1, 32, 32), gen, torch.bfloat16).permute(0, 2, 3, 1)
    assert depth.is_contiguous() and depth.stride() != (1024, 32, 1, 1)
    captured = Engine(fn, capture=True)
    out = captured(x, depth).clone()
    assert torch.equal(out, Engine(fn)(x, depth))


def test_a_capture_that_fails_raises(gen):
    from stablediffusioneo_tpu_torch.runtime.engine import Engine

    def syncs(x):
        return x * float(x.sum().item())  # a device-to-host copy: not capturable

    eng = Engine(syncs, name="syncs", capture=True)
    with pytest.raises(Exception):
        eng.load(torch.ones(4, device="cuda"))
    assert not eng.compiled
    ok = Engine(lambda x: x * 2, name="double", capture=True).load(torch.ones(4, device="cuda"))
    assert ok.compiled and ok(torch.full((4,), 3.0, device="cuda")).tolist() == [6.0] * 4
    with pytest.raises(ValueError, match="captured for"):
        ok(torch.ones(5, device="cuda"))


def test_a_capture_records_no_event_and_replays_carry_device_times(gen):
    """With tracing on, a span inside the captured function records host
    times only while the stream is captured (the graph holds no event: as
    many nodes as a capture with tracing off), and every replay's
    `runtime.engine` span carries a device time once it has completed."""
    from stablediffusioneo_tpu_torch.runtime import profiling
    from stablediffusioneo_tpu_torch.runtime.engine import Engine

    def fn(x):
        with profiling.span("inner", device=x.device):
            return (x @ x).relu()

    x = torch.randn(1024, 1024, device="cuda", generator=gen)
    assert profiling.RECORDER.on
    profiling.clear()
    eng = Engine(fn, name="mm", capture=True).load(x)
    eager, captured = [sp for sp in profiling.spans() if sp.name == "inner"]
    assert eager.device_ms > 0  # the eager run before the capture, synchronised
    assert captured.device_ms is None and captured.end_event is None
    profiling.set_tracing(False)
    try:
        bare = Engine(fn, name="mm", capture=True).load(x)
    finally:
        profiling.set_tracing(True)
    assert eng.get_engine_infor()["device_ops"] == bare.get_engine_infor()["device_ops"]
    profiling.clear()
    for _ in range(3):
        eng(x)
    torch.cuda.synchronize()
    runs = profiling.spans()
    assert [sp.name for sp in runs] == ["runtime.engine"] * 3
    assert all(sp.device_ms > 0 for sp in runs)
    assert runs[0].attrs == {"engine": "mm", "batch": 1024}


# ------------------------------------------- the VAE encoder, img2img, inpaint


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_encoder_engine_replay_equals_eager(gen, dtype):
    """Tiny config at 64x64 and 128x96: the captured encoder (posterior mode,
    and a sample with eps handed in) against the eager one, equal bytes."""
    cfg, rt = _tiny_runtime(dtype)
    for h, w in ((64, 64), (128, 96)):
        img = torch.rand((2, h, w, 3), generator=gen, device="cuda") * 2 - 1
        eps = _randn((2, h // 8, w // 8, 4), gen, torch.float32)
        outs = {}
        for graphs in (None, False):
            rt.graphs = graphs
            outs[graphs] = [rt.encode_image(img, deterministic=True) for _ in range(2)] \
                + [rt.encode_image(img, eps=eps)]
        for a, b in zip(outs[None], outs[False]):
            assert torch.equal(a, b) and torch.isfinite(a).all()
        assert torch.equal(outs[None][0], outs[None][1])
        assert outs[None][0].shape == (2, h // 8, w // 8, 4)
        assert outs[None][0].dtype == getattr(torch, dtype)
    captured = sorted(e.name for e in rt._engines.values() if e.compiled)
    assert captured == ["encoder_b2_128x96", "encoder_b2_128x96_det",
                        "encoder_b2_64x64", "encoder_b2_64x64_det"]


@pytest.mark.parametrize("kind", ["img2img", "inpaint"])
def test_img2img_and_inpaint_process_replay_equals_eager(gen, kind):
    """process() on the tiny config: the replayed engines' image equals the
    eager loop's in bytes, for two seeds."""
    import numpy as np

    from stablediffusioneo_tpu_torch.models.tokenizer import toy_tokenizer
    from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline

    cfg, rt = _tiny_runtime()
    pipe = Canny2ImagePipeline(rt.model, toy_tokenizer(max_length=cfg.clip.max_length),
                               cfg, device="cuda")
    rng = np.random.default_rng(0)
    image = (rng.random((64, 64, 3)) * 255).astype(np.uint8)
    source = (rng.random((80, 72, 3)) * 255).astype(np.uint8)
    mask = np.zeros((80, 72), np.uint8)
    mask[10:50, 20:60] = 255
    extra = ({"init_image": source, "denoise_strength": 0.6} if kind == "img2img"
             else {"inpaint_image": source, "inpaint_mask": mask, "eta": 0.3})
    for seed in (1, 2):
        outs = []
        for graphs in (None, False):
            pipe.runtime.graphs = graphs
            outs.append(pipe.process(image, "a bird", image_resolution=64, ddim_steps=4,
                                     seed=seed, **extra)[1])
        assert np.array_equal(*outs)
    assert all(e.compiled for k, e in pipe.runtime._engines.items() if k[-2])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s", [154, 231])
@pytest.mark.parametrize("b,tq,c", [(2, 4096, 320), (2, 1024, 640)])
def test_packed_kernel_long_prompt_keys(gen, dtype, b, tq, c, s):
    """The cross-attention sites of a long prompt: key lengths of 2 and 3
    windows of 77, multiples of neither 64 nor 16, so the last K tile is
    ragged (its zero-filled rows masked)."""
    q = _randn((b, tq, c), gen, dtype)
    k, v = _randn((b, s, c), gen, dtype), _randn((b, s, c), gen, dtype)
    scale = (c // 8) ** -0.5
    ka.variant_launches.clear()
    ka.key_length_launches.clear()
    out = fused_attention_packed(q, k, v, 8, scale)
    assert dict(ka.variant_launches) == {
        "wgmma" if dtype == torch.bfloat16 else "cuda_core": 1}
    assert dict(ka.key_length_launches) == {s: 1}
    _check(out, fused_attention_packed_plain(q, k, v, 8, scale), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("heads", [16, 12])
def test_split_kernel_reads_vit_qkv_views(gen, dtype, heads):
    """A MiDaS ViT block at a 512x512 input (DPT-L 16 heads, the DPT-hybrid
    12, head dim 64): q, k, v as (B, H, T, d) views of one (B, T, 3, H, d)
    projection, token stride 3C, and 1,025 tokens (a one-row tail in both
    the query and the key tiles)."""
    qkv = _randn((1, 1025, 3, heads, 64), gen, dtype)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    ka.variant_launches.clear()
    out = fused_attention(q, k, v, 64 ** -0.5)
    assert dict(ka.variant_launches) == {
        "wgmma" if dtype == torch.bfloat16 else "cuda_core": 1}
    _check(out, fused_attention_plain(q, k, v, 64 ** -0.5), dtype)


def test_detectors_default_to_the_card(gen):
    """HED and MiDaS DPT-L with seeded weights, built with no device named:
    on the card in bf16; DPT-L at a 512x512 image launches the split kernel
    once a ViT block on the tensor-core variant."""
    import numpy as np

    from stablediffusioneo_tpu_torch.annotators import HEDdetector, MidasDetector

    img = (np.random.default_rng(0).random((512, 512, 3)) * 255).astype(np.uint8)
    hed = HEDdetector()
    assert hed.net.norm.device.type == "cuda" and hed.net.norm.dtype == torch.bfloat16
    edge = hed(img)
    assert edge.shape == (512, 512) and edge.dtype == np.uint8
    midas = MidasDetector(model_type="dpt_large")
    dispatch.reset_launches()
    ka.variant_launches.clear()
    depth, normal = midas(img)
    assert dispatch.launches["fused_attention"] == 24
    assert dict(ka.variant_launches) == {"wgmma": 24}
    assert depth.shape == (512, 512) and normal.shape == (512, 512, 3)


# ------------------------------------------------------------------ training


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("entry,q_shape,s,heads", chip_smoke.GRAD_ROWS,
                         ids=[f"{r[0]}-{'x'.join(map(str, r[1]))}-{r[2]}"
                              for r in chip_smoke.GRAD_ROWS])
def test_attention_gradients_match_the_plain_version(gen, dtype, entry, q_shape, s, heads):
    """Each attention entry under autograd at a training shape: its Function
    (the kernel forward, one launch; the port's copy of the JAX backward)
    against autograd through the plain version, per gradient within
    chip_smoke.GRAD_TOL x max |plain gradient|."""
    split = entry == "fused_attention"
    kv_shape = q_shape[:-2] + (s, q_shape[-1]) if split else (q_shape[0], s, q_shape[2])
    d = q_shape[-1] if split else q_shape[2] // heads
    fn, plain = getattr(ka, entry), getattr(ka, entry + "_plain")
    args = () if split else (heads,)
    inputs = [_randn(shape, gen, dtype) for shape in (q_shape, kv_shape, kv_shape)]
    cot = _randn(q_shape, gen, dtype)

    def grads(f):
        xs = [t.detach().requires_grad_() for t in inputs]
        return torch.autograd.grad(f(*xs, *args, d ** -0.5), xs, cot)

    dispatch.reset_launches()
    got = grads(fn)
    assert dispatch.launches[entry] == 1
    for a, b in zip(got, grads(plain)):
        assert a.shape == b.shape and torch.isfinite(a).all()
        err = (a.float() - b.float()).abs().max() / b.float().abs().max()
        assert err.item() <= chip_smoke.GRAD_TOL[dtype]


def test_norm_and_int8_kernels_refuse_gradients_on_the_card(gen):
    x = _randn((2, 320, 32, 32), gen, torch.bfloat16).requires_grad_()
    w, b = _affine(320, gen, torch.bfloat16)
    with pytest.raises(RuntimeError, match="has no gradient"):
        kg.fused_group_norm(x, w, b, 32, 1e-5, True)
    w_q, scale = quantize_weights(torch.randn(1280, 320, device="cuda"))
    with pytest.raises(RuntimeError, match="has no gradient"):
        kq.quantized_matmul(_randn((64, 320), gen, torch.bfloat16).requires_grad_(), w_q, scale)
    with torch.no_grad():
        assert torch.isfinite(kg.fused_group_norm(x, w, b, 32, 1e-5, True)).all()


def test_full_width_train_step_reaches_the_level0_projections(gen, monkeypatch):
    """A full-width SD-1.5 ControlNet train_step at 256x256 b1 in fp32
    through the kernels (14 launches): the level-0 attn1.to_q gradient it
    took is non-zero and matches the same step with the packed entry's
    forward replaced by its plain version (chip_smoke.TRAIN_REF_TOL x max
    |plain gradient|)."""
    import dataclasses

    from stablediffusioneo_tpu_torch.training.trainer import (
        create_train_state, make_schedule_buffers, step_draws, train_step)

    cfg = dataclasses.replace(sd15_pipeline(), dtype="float32")
    model = chip_smoke.build_model(cfg, seed=0)
    batch = {"x0": torch.randn((1, 32, 32, 4), generator=gen, device="cuda"),
             "hint": torch.rand((1, 256, 256, 3), generator=gen, device="cuda"),
             "ctx": torch.randn((1, 77, 768), generator=gen, device="cuda")}
    t, noise = step_draws(0, 0, batch["x0"], 1000)
    sa, s1 = make_schedule_buffers(cfg, "cuda")
    name = "input_blocks.1.1.transformer_blocks.0.attn1.to_q.weight"

    def step():
        state, tx = create_train_state(model.control_model, 1e-5)
        state, _ = train_step(state, tx, model.unet, cfg, sa, s1, batch, key=0, t=t,
                              noise=noise)
        return state.params[name].grad

    dispatch.reset_launches()
    got = step()
    assert dispatch.launches["fused_attention_packed"] == 14
    monkeypatch.setattr(ka, "_packed_forward", lambda q, k, v, h, sc, stream:
                        fused_attention_packed_plain(q, k, v, h, sc))
    want = step()
    assert got.abs().max() > 0
    assert ((got - want).abs().max() / want.abs().max()).item() <= chip_smoke.TRAIN_REF_TOL
