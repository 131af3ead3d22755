"""The port's attention kernel entries against the JAX package's Pallas
kernels, and the dispatch rule.

On the CPU the entries run their plain versions; the JAX side runs the
Pallas kernels in interpret mode, as tests/test_pallas_kernels.py does.
The CUDA kernel itself is compared with the plain version on the card in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from stablediffusioneo_tpu.ops.pallas.attention import (
    fused_attention as jax_fused_attention,
    fused_attention_packed as jax_fused_attention_packed,
)
from stablediffusioneo_tpu_torch.ops import dispatch
from stablediffusioneo_tpu_torch.ops.attention import attention, multi_head_attention
from stablediffusioneo_tpu_torch.ops.kernels.attention import (
    fused_attention,
    fused_attention_packed,
    fused_attention_packed_plain,
    fused_attention_plain,
)

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
