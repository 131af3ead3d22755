"""Attention ops (counterpart of stablediffusioneo_tpu/ops/attention.py).

  * `attention`: q (..., Tq, D) against k/v (..., Tk, D) with an fp32 softmax
    island and an optional finite additive mask (CLIP's causal mask). Four-dim
    unmasked inputs with at least ATTN_MIN_TQ query tokens go to the fused
    kernel's split entry (the VAE mid-block); the rest is plain math.
  * `context_kv`: the cross-attention K/V projection of a step-invariant
    context, one matmul against the concatenated weights.
  * `multi_head_attention`: project (fused QKV for self-attention), attend,
    out-project. Unmasked sites with at least ATTN_MIN_TQ query tokens go to
    the kernel's head-packed entry.
"""

from __future__ import annotations

from typing import Optional

import torch

from stablediffusioneo_tpu_torch.ops.dispatch import ATTN_MIN_TQ
from stablediffusioneo_tpu_torch.ops.kernels.attention import (
    fused_attention,
    fused_attention_packed,
)
from stablediffusioneo_tpu_torch.ops.layers import linear


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
        out = fused_attention_packed(q, k, v, num_heads, scale=head_dim ** -0.5)
    else:
        def heads(t, n):
            return t.reshape(b, n, num_heads, head_dim).transpose(1, 2)

        out = attention(heads(q, tq), heads(k, tk), heads(v, tk), mask=mask)
        out = out.transpose(1, 2).reshape(b, tq, inner)
    return linear(out, wo, bo)
