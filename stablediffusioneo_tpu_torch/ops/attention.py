"""Attention ops (counterpart of stablediffusioneo_tpu/ops/attention.py).

  * `attention`: q (..., Tq, D) against k/v (..., Tk, D) with an fp32 softmax
    island and an optional finite additive mask (CLIP's causal mask). Four-dim
    unmasked inputs with at least ATTN_MIN_TQ query tokens go to the fused
    kernel's split entry (the VAE mid-block); the rest is plain math.
  * `context_kv`: the cross-attention K/V projection of a step-invariant
    context, one matmul against the concatenated weights.
  * `multi_head_attention`: project (fused QKV for self-attention), attend,
    out-project. Unmasked sites with at least ATTN_MIN_TQ query tokens go to
    the kernel's head-packed entry, or to its streaming entry where the JAX
    package streams K/V (`stream_attention`).
"""

from __future__ import annotations

from typing import Optional

import torch

from stablediffusioneo_tpu_torch.ops.dispatch import ATTN_MIN_TQ
from stablediffusioneo_tpu_torch.ops.kernels.attention import (
    fused_attention,
    fused_attention_packed,
    fused_attention_packed_stream,
)
from stablediffusioneo_tpu_torch.ops.layers import linear


# The JAX package's routing constants (ops/pallas/attention.py): the budget
# tiers of its full-K/V packed kernel and the blocks of its streaming one.
# Here they only decide which entry (and counter) a site takes; the CUDA
# kernel streams K/V at every site.
_BUDGET, _BUDGET_BIG = 14 * 1024 * 1024, 20 * 1024 * 1024


def _pick_block_q_packed(tq: int, s: int, c: int, itemsize: int) -> int:
    """The JAX package's _pick_block_q_packed: the q block of its full-K/V
    packed kernel, 0 when none fits."""
    tiers = (_BUDGET, _BUDGET_BIG) if itemsize == 2 else (_BUDGET,)
    for budget in tiers:
        for bq in (512, 256, 128):
            if tq % bq or (bq == 512 and bq * s * (4 + itemsize) > 3_500_000):
                continue
            if (bq * s * (4 + itemsize) + 2 * s * c * itemsize
                    + 2 * bq * c * itemsize <= budget):
                return bq
    return 0


def _pick_blocks_stream(tq: int, s: int, itemsize: int):
    """The JAX package's _pick_blocks_stream: (bq, bk) or None (bf16 only)."""
    if itemsize != 2:
        return None
    for bq in (256, 512, 128):
        if tq % bq == 0:
            bk = next((b for b in (4096, 2048, 1024, 512) if s % b == 0), None)
            if bk:
                return bq, bk
    return None


def stream_attention(tq: int, s: int, c: int, dtype: torch.dtype) -> bool:
    """Whether the JAX package runs this packed site on its streaming kernel
    (`_packed_impl`): self-attention whose full K/V slab fits no block of
    the packed kernel, e.g. the 1024x1024 hires pass's level-0 sites
    (2, 16384, 320)."""
    itemsize = torch.finfo(dtype).bits // 8
    return (tq == s and _pick_block_q_packed(tq, s, c, itemsize) == 0
            and _pick_blocks_stream(tq, s, itemsize) is not None)


def attention(q, k, v, mask: Optional[torch.Tensor] = None,
              scale: Optional[float] = None):
    """Scaled dot-product attention, fp32 logits and softmax, output in q's
    dtype. mask: additive, broadcastable to (..., Tq, Tk), large negative
    finite values (not -inf)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if mask is None and q.dim() == 4 and q.shape[-2] >= ATTN_MIN_TQ:
        return fused_attention(q, k, v, float(scale))
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits + mask.float()
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(w.float(), v.float()).to(q.dtype)


def context_kv(context, wk, wv):
    """(B, Tk, Ck) -> (k, v), each (B, Tk, inner). wk/wv are (inner, Ck)."""
    kv = linear(context, torch.cat([wk, wv], dim=0))
    return kv.chunk(2, dim=-1)


def multi_head_attention(x, context, wq, wk, wv, wo, bo, num_heads: int,
                         mask=None, kv=None):
    """x (B, Tq, C); context (B, Tk, Ck) or None for self-attention.
    Weights in torch (out, in) layout; kv: optional precomputed (k, v) from
    `context_kv` (samplers hoist the step-invariant context projection)."""
    b, tq, _ = x.shape
    inner = wq.shape[0]
    head_dim = inner // num_heads
    if kv is not None:
        q = linear(x, wq)
        k, v = kv
    elif context is None:
        q, k, v = linear(x, torch.cat([wq, wk, wv], dim=0)).chunk(3, dim=-1)
    else:
        q = linear(x, wq)
        k, v = context_kv(context, wk, wv)
    tk = k.shape[1]
    if mask is None and tq >= ATTN_MIN_TQ:
        entry = (fused_attention_packed_stream
                 if stream_attention(tq, tk, inner, q.dtype) else fused_attention_packed)
        out = entry(q, k, v, num_heads, scale=head_dim ** -0.5)
    else:
        def heads(t, n):
            return t.reshape(b, n, num_heads, head_dim).transpose(1, 2)

        out = attention(heads(q, tq), heads(k, tk), heads(v, tk), mask=mask)
        out = out.transpose(1, 2).reshape(b, tq, inner)
    return linear(out, wo, bo)
