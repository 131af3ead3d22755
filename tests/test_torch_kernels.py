"""The port's attention kernel entries against the JAX package's Pallas
kernels, and the dispatch rule.

On the CPU the entries run their plain versions; the JAX side runs the
Pallas kernels in interpret mode, as tests/test_pallas_kernels.py does.
The CUDA kernels themselves are compared with the plain versions on the card
in tests/test_torch_cuda.py; which variant of the CUDA source a call runs
is a pure function of its arguments and is held here, as are the bounds
that chip_smoke.py reports for the attention rows.
"""

import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from stablediffusioneo_tpu.ops.pallas.attention import (
    fused_attention as jax_fused_attention,
    fused_attention_packed as jax_fused_attention_packed,
)
from stablediffusioneo_tpu_torch.config import sd15_pipeline
from stablediffusioneo_tpu_torch.ops import dispatch
from stablediffusioneo_tpu_torch.ops.attention import attention, multi_head_attention
from stablediffusioneo_tpu_torch.ops.kernels.attention import (
    VARIANTS,
    attention_variant,
    fused_attention,
    fused_attention_packed,
    fused_attention_packed_plain,
    fused_attention_plain,
    views_aligned,
)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402  (the plan-derived attention rows, the bounds)

TOL = 1e-5  # fp32 plain math vs fp32 Pallas interpret: same algorithm


@pytest.mark.parametrize("s", [256, 77])
def test_packed_plain_matches_pallas(rng, s):
    b, t, h, d = 2, 256, 2, 32
    q, k, v = (rng.standard_normal(shape, dtype=np.float32)
               for shape in ((b, t, h * d), (b, s, h * d), (b, s, h * d)))
    ref = np.asarray(jax_fused_attention_packed(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h, scale=d ** -0.5,
        interpret=True))
    out = fused_attention_packed(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), h, d ** -0.5).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)


def test_split_plain_matches_pallas(rng):
    shape = (1, 1, 256, 64)
    q, k, v = (rng.standard_normal(shape, dtype=np.float32) for _ in range(3))
    ref = np.asarray(jax_fused_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 64 ** -0.5,
        interpret=True))
    out = fused_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), 64 ** -0.5).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)


def test_cpu_tensors_take_plain_version_and_count_nothing(rng):
    """At a kernel-gated site (no mask, >= 1024 query tokens) CPU tensors run
    the plain version and no launch is counted."""
    dispatch.reset_launches()
    b, t, c, heads = 1, dispatch.ATTN_MIN_TQ, 16, 2
    x = torch.from_numpy(rng.standard_normal((b, t, c), dtype=np.float32))
    w = [torch.from_numpy(rng.standard_normal((c, c), dtype=np.float32) * 0.2)
         for _ in range(4)]
    out = multi_head_attention(x, None, *w, None, heads)
    q, k, v = (x @ wi.T for wi in w[:3])
    ref = fused_attention_packed_plain(q, k, v, heads, (c // heads) ** -0.5) @ w[3].T
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    split = attention(q[:, None], k[:, None], v[:, None])
    torch.testing.assert_close(
        split, fused_attention_plain(q[:, None], k[:, None], v[:, None], c ** -0.5))
    assert dispatch.launches == {name: 0 for name in dispatch.KERNELS}


# ------------------------------------------------------- variant choice

# every distinct kernel-gated attention call of the 512x512 request and of
# the 1024x1024 hires pass, SD-1.5 widths
ROWS = chip_smoke.attention_rows(sd15_pipeline())


def _row_dims(entry, q_shape, heads):
    """(Tq, head dim) of a chip_smoke attention row."""
    if entry == "fused_attention":
        return q_shape[2], q_shape[3]
    return q_shape[1], q_shape[2] // heads


@pytest.mark.parametrize("entry,q_shape,s,heads", ROWS,
                         ids=[f"{r[0]}-{r[1]}x{r[2]}" for r in ROWS])
def test_main_path_rows_take_the_tensor_core_variants(entry, q_shape, s, heads):
    """bf16 on aligned tensors: d = 512 takes the split wgmma variant, every
    other site (long self-attention and S = 77 alike) the packed wgmma one;
    the same rows in fp32 take the CUDA cores."""
    tq, d = _row_dims(entry, q_shape, heads)
    want = "wgmma_split" if d == 512 else "wgmma"
    assert attention_variant(torch.bfloat16, d, tq, s, True) == want
    assert attention_variant(torch.float32, d, tq, s, True) == "cuda_core"
    assert attention_variant(torch.bfloat16, d, tq, s, False) == "cuda_core"


def test_main_path_rows_cover_the_sites_the_redesign_names():
    rows = {(r[0], tuple(r[1]), r[2]) for r in ROWS}
    for want in (("fused_attention", (1, 1, 4096, 512), 4096),
                 ("fused_attention", (1, 1, 16384, 512), 16384),
                 ("fused_attention_packed_stream", (2, 16384, 320), 16384),
                 ("fused_attention_packed", (2, 4096, 320), 4096),
                 ("fused_attention_packed", (2, 4096, 640), 4096),
                 ("fused_attention_packed", (2, 4096, 320), 77),
                 # a long prompt's cross-attention at 2 and 3 windows
                 ("fused_attention_packed", (2, 4096, 320), 154),
                 ("fused_attention_packed", (2, 1024, 640), 231),
                 # a level-0 self-attention after token merging at ratio 0.5
                 ("fused_attention_packed", (2, 2048, 320), 2048),
                 # SD-2.1 768x768: 5 and 10 heads of 64 channels, its decode
                 ("fused_attention_packed", (2, 9216, 320), 9216),
                 ("fused_attention_packed", (2, 2304, 640), 77),
                 ("fused_attention", (1, 1, 9216, 512), 9216),
                 # SDXL 1024x1024: 10 and 20 heads of 64 channels
                 ("fused_attention_packed", (2, 4096, 640), 4096),
                 ("fused_attention_packed", (2, 1024, 1280), 77),
                 # the SDXL refiner at 1024x1024: 12 and 24 heads of 64 channels
                 ("fused_attention_packed", (2, 4096, 768), 4096),
                 ("fused_attention_packed", (2, 4096, 768), 77),
                 ("fused_attention_packed", (2, 1024, 1536), 1024),
                 ("fused_attention_packed", (2, 1024, 1536), 77)):
        assert want in rows, want
    assert ("fused_attention_packed", (2, 4096, 640), 4096, 10) in ROWS
    assert ("fused_attention_packed", (2, 1024, 1280), 1024, 20) in ROWS
    assert ("fused_attention_packed", (2, 4096, 768), 4096, 12) in ROWS
    assert ("fused_attention_packed", (2, 1024, 1536), 1024, 24) in ROWS
    # 12 of the 512x512 and 1024x1024 requests, 4 of the long prompts, 1 of
    # ToMe, 5 of SD-2.1 at 768x768, 4 of SDXL and 4 of the SDXL refiner at
    # 1024x1024 (their decode's split row is the hires pass's; the 9-channel
    # inpainting request's rows are the 512x512 request's)
    assert len(ROWS) == 30


@pytest.mark.parametrize("dtype,d,tq,s,aligned,want", [
    (torch.float32, 40, 4096, 4096, True, "cuda_core"),
    (torch.float32, 512, 4096, 4096, True, "cuda_core"),
    (torch.bfloat16, 80, 1024, 1024, False, "cuda_core"),   # unaligned view
    (torch.bfloat16, 512, 4096, 4096, False, "cuda_core"),
    (torch.bfloat16, 40, 4096, 77, True, "wgmma"),          # cross-attention
    (torch.bfloat16, 160, 1024, 77, True, "wgmma"),
    (torch.bfloat16, 64, 200, 77, True, "wgmma"),
    (torch.bfloat16, 40, 16384, 16384, True, "wgmma"),      # the streaming sites
    (torch.bfloat16, 512, 4096, 4096, True, "wgmma_split"),
    (torch.bfloat16, 512, 16384, 16384, True, "wgmma_split"),
])
def test_attention_variant(dtype, d, tq, s, aligned, want):
    assert attention_variant(dtype, d, tq, s, aligned) == want
    assert want in VARIANTS


def _packed_strides(q, k, v, out, d):
    return [(t.stride(0), d, t.stride(1)) for t in (q, k, v, out)]


@pytest.mark.parametrize("dtype,offset,want", [
    (torch.bfloat16, 0, True),    # column views of a fused QKV projection
    (torch.bfloat16, 1, False),   # rows that start 2 bytes off
    (torch.float32, 0, False),    # the tensor-core variants are bf16 only
])
def test_views_aligned(dtype, offset, want):
    d, heads = 80, 8
    qkv = torch.zeros((2, 16, 3 * d * heads + offset), dtype=dtype)[..., offset:]
    q, k, v = qkv.chunk(3, dim=-1)
    out = torch.empty((2, 16, d * heads), dtype=dtype)
    assert views_aligned(q, k, v, out, _packed_strides(q, k, v, out, d)) == want


# ---------------------------------------------------------------- bounds

# the least time an H100 could take, ms: 4 B H Tq S d operations at 989
# TFLOP/s dense bf16, or q, k, v, o once at 3.35 TB/s, whichever is larger
BOUNDS = [
    ([("fused_attention", (1, 1, 4096, 512), 4096, 1)], 0.035, "operations"),
    ([("fused_attention", (1, 1, 16384, 512), 16384, 1)], 0.556, "operations"),
    ([("fused_attention_packed_stream", (2, 16384, 320), 16384, 8)], 0.695,
     "operations"),
    # the four packed rows of the 512x512 request, summed
    ([("fused_attention_packed", (2, 4096, 320), 4096, 8),
      ("fused_attention_packed", (2, 4096, 320), 77, 8),
      ("fused_attention_packed", (2, 1024, 640), 1024, 8),
      ("fused_attention_packed", (2, 1024, 640), 77, 8)], 0.053, None),
]


@pytest.mark.parametrize("rows,want_ms,want_by", BOUNDS,
                         ids=["split-4096", "split-16384", "stream-16384", "packed-512"])
def test_attention_bounds(rows, want_ms, want_by):
    total = 0.0
    for entry, q_shape, s, heads in rows:
        assert (entry, q_shape, s, heads) in ROWS
        tq, d = _row_dims(entry, q_shape, heads)
        ops, nbytes, exps = chip_smoke.attention_work(q_shape[0], heads, tq, s, d)
        assert exps == q_shape[0] * heads * tq * s
        ms, by = chip_smoke.bound_ms(ops, chip_smoke.PEAK_BF16, nbytes)
        if want_by:
            assert by == want_by
        elif s == 77:  # cross-attention moves more than it multiplies
            assert by == "bytes"
        total += ms
    assert abs(total - want_ms) <= 0.05 * want_ms


def test_streaming_row_exp_figure():
    """The second figure beside the bound: 2 x 8 x 16384^2 exps on the
    special-function units take longer than the row's tensor-core bound."""
    ops, nbytes, exps = chip_smoke.attention_work(2, 8, 16384, 16384, 40)
    exp_ms = exps / chip_smoke.PEAK_EXP * 1e3
    assert 1.1 < exp_ms < 1.3
    assert exp_ms > chip_smoke.bound_ms(ops, chip_smoke.PEAK_BF16, nbytes)[0]
