"""The port's CUDA attention kernel against its plain version, on the card.

Marked `cuda`: each test skips without a CUDA device. This file imports no
JAX, so it also runs where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
(--noconftest: tests/conftest.py sets JAX up). Tolerances: fp32 max |d| <=
1e-4 (the two differ in summation order only); bf16 max |d| <= 2e-2 and
mean |d| <= 2e-3 on standard-normal inputs (the kernel rounds the
unnormalised p to bf16, the plain version the normalised one).
"""

import pytest
import torch

from stablediffusioneo_tpu_torch.ops import dispatch
from stablediffusioneo_tpu_torch.ops.kernels.attention import (
    fused_attention,
    fused_attention_packed,
    fused_attention_packed_plain,
    fused_attention_plain,
)

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
    out = fused_attention_packed(q, k, v, heads, scale)
    assert dispatch.launches["fused_attention_packed"] == 1
    _check(out, fused_attention_packed_plain(q, k, v, heads, scale), dtype)


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
    out = fused_attention_packed(q, k, v, 8, 80 ** -0.5)
    _check(out, fused_attention_packed_plain(q, k, v, 8, 80 ** -0.5),
           torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_split_kernel_matches_plain(gen, dtype):
    q, k, v = (_randn((1, 1, 4096, 512), gen, dtype) for _ in range(3))
    dispatch.reset_launches()
    out = fused_attention(q, k, v, 512 ** -0.5)
    assert dispatch.launches["fused_attention"] == 1
    _check(out, fused_attention_plain(q, k, v, 512 ** -0.5), dtype)


def test_kernel_rejects_what_it_does_not_take(gen):
    q = _randn((1, 1024, 96), gen, torch.bfloat16)  # d = 48
    with pytest.raises(ValueError, match="head dim"):
        fused_attention_packed(q, q, q, 2, 48 ** -0.5)
    h = _randn((1, 1024, 80), gen, torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_attention_packed(h, h, h, 1, 80 ** -0.5)
