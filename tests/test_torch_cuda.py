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

import pytest
import torch

from stablediffusioneo_tpu_torch.ops import dispatch
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

pytestmark = pytest.mark.cuda


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
@pytest.mark.parametrize("shape", [(2, 4096, 320), (2, 256, 1280), (3, 77, 768)])
def test_layer_norm_kernel_matches_plain(gen, dtype, shape):
    x = _randn(shape, gen, dtype)
    w, b = _affine(shape[-1], gen, dtype)
    dispatch.reset_launches()
    out = kl.fused_layer_norm(x, w, b, 1e-5)
    assert dispatch.launches["fused_layer_norm"] == 1
    _check(out, kl.fused_layer_norm_plain(x, w, b, 1e-5), dtype)


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
