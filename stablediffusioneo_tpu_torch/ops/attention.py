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
from stablediffusioneo_tpu_torch.parallel.mesh import (
    all_gather,
    copy_to,
    gather_from,
    local_slice,
    row_linear,
    spatial_axis,
)


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


def packed_partition(b: int, tq: int, s: int, c: int, heads: int, itemsize: int,
                     nb: int = 1, ntq: int = 1, nc: int = 1):
    """The partition algebra of the JAX package's packed attention
    (ops/pallas/attention.py:_packed_partition): of the candidates (batch,
    query-token, channel shard counts) (nb, ntq, nc), (nb, 1, nc),
    (nb, ntq, 1), (nb, 1, 1), (1, 1, 1), the first whose per-rank shape the
    kernel takes: shards tile b, tq, c and the heads, a rank's query count
    is a multiple of 128 and a q block fits (or the streaming kernel
    takes the self-attention). K/V are never split. Degrading to 1 on an
    axis means that axis's ranks run the site whole."""
    def shard_ok(nb_, ntq_, nc_):
        if b % nb_ or tq % ntq_ or c % nc_ or heads % nc_:
            return False
        ltq, lc, lh = tq // ntq_, c // nc_, heads // nc_
        if ltq % 128 or lc % lh:
            return False
        if _pick_block_q_packed(ltq, s, lc, itemsize) > 0:
            return True
        return ltq == s and _pick_blocks_stream(ltq, s, itemsize) is not None

    for cand in ((nb, ntq, nc), (nb, 1, nc), (nb, ntq, 1), (nb, 1, 1), (1, 1, 1)):
        if shard_ok(*cand):
            return cand
    raise ValueError(f"packed attention unsupported even replicated: q {(b, tq, c)} "
                     f"x kv_len {s}, heads={heads}")


def _sp_queries(q, k, v, dim: int, run, self_attention: bool, heads: int,
                kernel: bool, nc: int = 1):
    """Attention of this rank's rows under sp (parallel/mesh.py): K/V of a
    self-attention all-gathered over sp on `dim` (a cross-attention's come
    whole from the context), and the queries kept as this rank's where the
    partition algebra keeps them sharded (kernel sites; plain sites always),
    else gathered too and the rank's rows of the output taken back."""
    ax = spatial_axis()
    if self_attention:
        k, v = gather_from(k, ax, dim), gather_from(v, ax, dim)
    if kernel:
        b, tq, c = q.shape[0], q.shape[dim] * ax.size, q.shape[-1] * nc
        itemsize = torch.finfo(q.dtype).bits // 8
        # the JAX kernel takes no site whose query count is not a multiple
        # of 128 (its plain path runs it); the port's kernel does, whole
        ntq = packed_partition(b, tq, k.shape[dim], c, heads * nc, itemsize,
                               ntq=ax.size, nc=nc)[1] if tq % 128 == 0 else 1
        if ntq == 1:
            return local_slice(run(all_gather(q, ax, dim), k, v), ax, dim)
    return run(q, k, v)


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


def grid_attention(q, k, v):
    """`attention` of (N, 1, T, C) single-head tokens of an image (the VAE
    mid-block): inside a mesh engine split by rows, this rank's queries
    against the whole image's K/V, the fused-kernel gate read on the whole
    image's query count (as the JAX gate reads the global shape)."""
    ax = spatial_axis()
    if ax is None:
        return attention(q, k, v)
    kernel = q.shape[-2] * ax.size >= ATTN_MIN_TQ
    run = ((lambda q_, k_, v_: fused_attention(q_, k_, v_, q_.shape[-1] ** -0.5))
           if kernel else attention)
    return _sp_queries(q, k, v, 2, run, True, 1, kernel)


def context_kv(context, wk, wv):
    """(B, Tk, Ck) -> (k, v), each (B, Tk, inner). wk/wv are (inner, Ck)."""
    kv = linear(context, torch.cat([wk, wv], dim=0))
    return kv.chunk(2, dim=-1)


def multi_head_attention(x, context, wq, wk, wv, wo, bo, num_heads: int,
                         mask=None, kv=None, tp=None):
    """x (B, Tq, C); context (B, Tk, Ck) or None for self-attention.
    Weights in torch (out, in) layout; kv: optional precomputed (k, v) from
    `context_kv` (samplers hoist the step-invariant context projection).
    tp: the tp axis of a site parallel/mesh.py:shard_params split by heads
    (the weights are this rank's heads; wo's rows reduced by `row_linear`).
    Inside a mesh engine split by rows over sp, x is this rank's tokens:
    a self-attention's K/V are all-gathered over sp, and the kernel gate
    reads the whole image's query count."""
    b, tq, _ = x.shape
    inner = wq.shape[0]
    head_dim = inner // num_heads
    x = copy_to(x, tp)
    if context is not None:
        context = copy_to(context, tp)
    if kv is not None:
        q = linear(x, wq)
        k, v = kv
    elif context is None:
        q, k, v = linear(x, torch.cat([wq, wk, wv], dim=0)).chunk(3, dim=-1)
    else:
        q = linear(x, wq)
        k, v = context_kv(context, wk, wv)
    sp = spatial_axis()
    n_sp = sp.size if sp is not None else 1
    tq_all = tq * n_sp
    tk_all = k.shape[1] * (n_sp if context is None and kv is None else 1)
    kernel = mask is None and tq_all >= ATTN_MIN_TQ

    def run(q, k, v):
        if kernel:
            entry = (fused_attention_packed_stream
                     if stream_attention(tq_all, tk_all, inner, q.dtype)
                     else fused_attention_packed)
            return entry(q, k, v, num_heads, scale=head_dim ** -0.5)

        def heads(t):
            return t.reshape(t.shape[0], t.shape[1], num_heads, head_dim).transpose(1, 2)

        out = attention(heads(q), heads(k), heads(v), mask=mask)
        return out.transpose(1, 2).reshape(q.shape[0], q.shape[1], inner)

    if sp is None:
        out = run(q, k, v)
    else:
        out = _sp_queries(q, k, v, 1, run, context is None and kv is None, num_heads,
                          kernel, tp.size if tp is not None else 1)
    if tp is not None:
        return row_linear(out, wo, bo, tp)
    return linear(out, wo, bo)
