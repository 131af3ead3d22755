"""Fused attention: the CUDA kernels' wrappers and their plain versions.

Counterpart of stablediffusioneo_tpu/ops/pallas/attention.py. The source
(csrc/attention.cu) replaces `_attn_kernel_packed` (entry
`fused_attention_packed`), `_attn_kernel_packed_stream` (entry
`fused_attention_packed_stream`) and `_attn_kernel` (entry
`fused_attention`). Every entry passes batch/head/token strides, streams
K/V tiles with an online softmax whatever the key length, and adds to its
own counter. The source holds three variants of that schedule;
`attention_variant` chooses one from the dtype, head dim, lengths and
alignment, and the C entry launches exactly that one or returns an error.
On CPU tensors each entry runs its plain version, which mirrors the JAX
package's `_packed_math` / `_split_math`.

Under autograd (grad enabled and an input that requires grad) each entry
runs through a torch.autograd.Function, the JAX `_packed_vjp` /
`_split_vjp`: its forward is the entry as above (the kernel on the card, the
plain version on the CPU; the counters count these forward launches only),
it keeps the JAX residuals (q, k, v, out), and its backward is the port's
copy of the JAX backward, which is plain XLA there and plain PyTorch here,
the same code on both devices: key lengths above `_BWD_CHUNK_THRESHOLD`
that split into `_BWD_CHUNK` chunks take the flash-style recurrence of
`attn_bwd_chunked`, the rest the VJP of the plain version. Without grad the
entries call no Function.
"""

from __future__ import annotations

import collections
import ctypes
import math
from typing import Optional

import torch

from stablediffusioneo_tpu_torch.ops import dispatch

SOURCES = ("attention.cu",)
HEAD_DIMS = (40, 64, 80, 160, 512)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LL = ctypes.c_longlong

# variant name -> code of csrc/attention.cu's `Variant`
VARIANTS = {
    "cuda_core": 0,    # fp32 FMAs from shared memory: fp32, and unaligned views
    "wgmma": 1,        # bf16 d <= 160: wgmma, cp.async ring, 2-4 warpgroups a block
    "wgmma_split": 2,  # bf16 d = 512: wgmma, O's columns split over 2 warpgroups
}
# launches by variant name since the last clear() (chip_smoke.py reads it)
variant_launches: "collections.Counter[str]" = collections.Counter()
dispatch.register_counter(variant_launches)
# launches by key length S since the last clear(): a long prompt's
# cross-attention runs at S = 154 or 231 instead of 77 (chip_smoke.py reads it)
key_length_launches: "collections.Counter[int]" = collections.Counter()
dispatch.register_counter(key_length_launches)


def attention_variant(dtype: torch.dtype, head_dim: int, tq: int, s: int,
                      aligned: bool) -> str:
    """The variant of csrc/attention.cu that one call runs. `aligned`: every
    row of q, k and v starts on 16 bytes and every row of the output on 4
    (`views_aligned`), which the tensor-core variants' vector loads need.
    The lengths do not enter yet: on the H100 the wgmma variant is the
    faster one at every main-path site, S = 77 included (PERF.md)."""
    del tq, s
    if dtype != torch.bfloat16 or not aligned:
        return "cuda_core"
    return "wgmma_split" if head_dim == 512 else "wgmma"


def views_aligned(q, k, v, out, strides) -> bool:
    """strides: (batch, head, token) element strides of q, k, v, out."""
    if any(t.element_size() != 2 for t in (q, k, v, out)):
        return False
    if any(x % 8 for st in strides[:3] for x in st) or any(x % 2 for x in strides[3]):
        return False
    return (all(t.data_ptr() % 16 == 0 for t in (q, k, v))
            and out.data_ptr() % 4 == 0)


def _library() -> ctypes.CDLL:
    from stablediffusioneo_tpu_torch.ops.kernels.build import load_library

    lib = load_library("attention", SOURCES)
    fn = lib.sdeo_attention_forward
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [_LL] * 12
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return lib


def _scaled_q(q: torch.Tensor, scale: float) -> torch.Tensor:
    # the scale is rounded to q's dtype first, as jnp.asarray(scale, q.dtype)
    return q * dispatch.const_tensor(float(scale), q.dtype, q.device)


def _rounded_scale(scale: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(scale, dtype=dtype))


def _launch(q, k, v, out, batch, heads, tq, s, head_dim, strides, scale,
            variant: Optional[str] = None):
    """strides: (batch, head, token) element strides of q, k, v, out.
    variant: a name of VARIANTS to run instead of `attention_variant`'s
    choice (for tests); the C entry refuses a variant that does not take the
    arguments, and the refusal raises here."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"attention kernel takes float32 or bfloat16, got {q.dtype}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("attention kernel needs q, k and v of one dtype")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"attention kernel head dim {head_dim} not in {HEAD_DIMS}")
    if s < 1 or tq < 1:
        raise ValueError(f"attention kernel needs tokens, got Tq={tq} S={s}")
    if any(t.stride(-1) != 1 for t in (q, k, v, out)):
        raise ValueError("attention kernel needs a contiguous head dim")
    if len({t.device for t in (q, k, v, out)}) != 1:
        raise ValueError("attention kernel inputs on different devices")
    if variant is None:
        variant = attention_variant(q.dtype, head_dim, tq, s,
                                    views_aligned(q, k, v, out, strides))
    fn = _library().sdeo_attention_forward
    flat = [x for st in strides for x in st]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             _DTYPE_CODE[q.dtype], batch, heads, tq, s, head_dim, *flat,
             _rounded_scale(scale, q.dtype), VARIANTS[variant], stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed ({variant}): "
                           f"cudaError {err}")
    variant_launches[variant] += 1
    key_length_launches[s] += 1


# ------------------------------------------------------------- packed entry


def fused_attention_packed_plain(q, k, v, heads: int, scale: float):
    """Plain version of the packed kernel (JAX `_packed_math`): scale q in its
    own dtype, fp32 logits and softmax, weights in v's dtype, fp32 AV."""
    b, tq, c = q.shape
    s = k.shape[1]
    d = c // heads
    qs = _scaled_q(q, scale).reshape(b, tq, heads, d).transpose(1, 2)
    kh = k.reshape(b, s, heads, d).transpose(1, 2)
    vh = v.reshape(b, s, heads, d).transpose(1, 2)
    logits = torch.matmul(qs.float(), kh.float().transpose(-1, -2))
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(w.float(), vh.float())
    return out.to(q.dtype).transpose(1, 2).reshape(b, tq, c)


def _packed_launch(q, k, v, heads: int, scale: float, counter: str,
                   variant: Optional[str] = None):
    b, tq, c = q.shape
    s = k.shape[1]
    if c % heads or k.shape != (b, s, c) or v.shape != (b, s, c):
        raise ValueError(f"packed attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, heads {heads}")
    d = c // heads
    out = torch.empty((b, tq, c), dtype=q.dtype, device=q.device)
    strides = [(t.stride(0), d, t.stride(1)) for t in (q, k, v, out)]
    _launch(q, k, v, out, b, heads, tq, s, d, strides, scale, variant)
    dispatch.count_launch(counter)
    return out


def fused_attention_packed(q, k, v, heads: int, scale: float):
    """Head-packed layout: q (B, Tq, H*D), k/v (B, S, H*D) -> (B, Tq, H*D).
    Heads are sliced inside the kernel by the head stride, so no
    (B,T,H,D)<->(B,H,T,D) relayout happens. q, k and v may be column views
    of a fused QKV projection: only the head dim must be contiguous; under
    autograd their gradients have the views' shapes."""
    if dispatch.needs_grad(q, k, v):
        return _PackedAttention.apply(q, k, v, heads, float(scale), False)
    return _packed_forward(q, k, v, heads, scale, False)


# ------------------------------------------------- packed streaming entry

# fp32 logits held at once by the chunked plain version (1 GiB)
_PLAIN_LOGITS_BYTES = 1 << 30


def fused_attention_packed_stream_plain(q, k, v, heads: int, scale: float,
                                        rows: Optional[int] = None):
    """Plain version of the streaming kernel: the packed plain version over
    chunks of `rows` query rows (softmax is per row, so the result is the
    same). At the hires sites unchunked logits would take (2, 8, 16384,
    16384) fp32 = 17 GB; by default a chunk's logits take 1 GiB."""
    b, tq, _ = q.shape
    rows = rows or max(1, _PLAIN_LOGITS_BYTES // (4 * b * heads * k.shape[1]))
    return torch.cat([fused_attention_packed_plain(q[:, i:i + rows], k, v, heads, scale)
                      for i in range(0, tq, rows)], dim=1)


def fused_attention_packed_stream(q, k, v, heads: int, scale: float):
    """The packed entry at the sites where the JAX package streams K/V
    (`_packed_stream_call`: bf16 self-attention too long for its full-K/V
    kernel, ops/attention.py:stream_attention). Same layout and kernel as
    `fused_attention_packed`, its own launch counter; the same backward
    (the JAX package routes its VJP through `_packed_vjp` too)."""
    if dispatch.needs_grad(q, k, v):
        return _PackedAttention.apply(q, k, v, heads, float(scale), True)
    return _packed_forward(q, k, v, heads, scale, True)


def _packed_forward(q, k, v, heads: int, scale: float, stream: bool):
    """A packed entry's output: the kernel on CUDA tensors, else the plain
    version (chunked over query rows for the streaming entry)."""
    if not dispatch.use_kernel(q, k, v):
        plain = fused_attention_packed_stream_plain if stream else fused_attention_packed_plain
        return plain(q, k, v, heads, scale)
    return _packed_launch(q, k, v, heads, scale,
                          "fused_attention_packed_stream" if stream
                          else "fused_attention_packed")


# -------------------------------------------------------------- split entry


def fused_attention_plain(q, k, v, scale: float):
    """Plain version of the split kernel (JAX `_split_math`)."""
    logits = torch.matmul(_scaled_q(q, scale).float(),
                          k.float().transpose(-1, -2))
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(w.float(), v.float()).to(q.dtype)


def _split_launch(q, k, v, scale: float, variant: Optional[str] = None):
    b, h, tq, d = q.shape
    s = k.shape[2]
    if k.shape != (b, h, s, d) or v.shape != (b, h, s, d):
        raise ValueError(f"split attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    out = torch.empty((b, h, tq, d), dtype=q.dtype, device=q.device)
    strides = [(t.stride(0), t.stride(1), t.stride(2)) for t in (q, k, v, out)]
    _launch(q, k, v, out, b, h, tq, s, d, strides, scale, variant)
    dispatch.count_launch("fused_attention")
    return out


def fused_attention(q, k, v, scale: float):
    """Split layout: q (B, H, Tq, D), k/v (B, H, S, D) -> (B, H, Tq, D)."""
    if dispatch.needs_grad(q, k, v):
        return _SplitAttention.apply(q, k, v, float(scale))
    return _split_forward(q, k, v, scale)


def _split_forward(q, k, v, scale: float):
    if not dispatch.use_kernel(q, k, v):
        return fused_attention_plain(q, k, v, scale)
    return _split_launch(q, k, v, scale)


# ------------------------------------------------------------------ backward

# The JAX package's backward constants (ops/pallas/attention.py): key lengths
# up to the threshold take the VJP of the plain math; longer ones that split
# into chunks take the chunked recurrence, which holds (Tq, chunk) logits at
# a time instead of (Tq, S).
_BWD_CHUNK_THRESHOLD = 1024
_BWD_CHUNK = 512


def attn_bwd_chunked(q, k, v, out, g, scale: float):
    """The JAX `_attn_bwd_chunked` on (B, H, T, D) tensors: the row max and
    sum of exponentials over key chunks first, then per chunk the
    probabilities again, dV and dK of the chunk and dQ summed over chunks;
    no (Tq, S) buffer. Where JAX multiplies operands of the inputs' dtype
    into fp32 (`preferred_element_type=float32`), the operands here are
    widened to fp32 first, which holds every product of two bf16 values
    exactly; the probabilities and dS are rounded to the inputs' dtype
    before their products, as there."""
    dt = q.dtype
    qs = _scaled_q(q, scale).float()        # S = qs @ k^T, as in the forward
    kc = k.float().split(_BWD_CHUNK, dim=2)
    vc = v.float().split(_BWD_CHUNK, dim=2)
    m = torch.full(q.shape[:3], -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros(q.shape[:3], dtype=torch.float32, device=q.device)
    for kj in kc:  # pass 1: running (row max, sum of exponentials)
        sj = qs @ kj.transpose(-1, -2)
        m_new = torch.maximum(m, sj.amax(-1))
        l = l * torch.exp(m - m_new) + torch.exp(sj - m_new[..., None]).sum(-1)
        m = m_new
    gf = g.float()
    d_row = (gf * out.float()).sum(-1)      # D_i = sum_d dO * O
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for kj, vj in zip(kc, vc):  # pass 2: dQ summed, dK and dV per chunk
        pj = torch.exp(qs @ kj.transpose(-1, -2) - m[..., None]) / l[..., None]
        dvs.append(pj.to(dt).float().transpose(-1, -2) @ gf)
        dp = gf @ vj.transpose(-1, -2)
        ds = (pj * (dp - d_row[..., None])).to(dt).float()
        dq += ds @ kj
        dks.append(ds.transpose(-1, -2) @ qs)
    return ((dq * scale).to(dt),             # d/dq of qs = q * scale
            torch.cat(dks, dim=2).to(k.dtype), torch.cat(dvs, dim=2).to(v.dtype))


def _chunked(s: int) -> bool:
    return s > _BWD_CHUNK_THRESHOLD and s % _BWD_CHUNK == 0


def _split_heads(x, heads: int):
    b, t, c = x.shape
    return x.reshape(b, t, heads, c // heads).transpose(1, 2)


def _merge_heads(x):
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def packed_bwd(q, k, v, out, g, heads: int, scale: float):
    """(dq, dk, dv) of a packed entry: the JAX `_packed_bwd`."""
    if _chunked(k.shape[1]):
        grads = attn_bwd_chunked(*(_split_heads(t, heads) for t in (q, k, v, out, g)), scale)
        return tuple(_merge_heads(t) for t in grads)
    return dispatch.vjp(lambda a, b, c: fused_attention_packed_plain(a, b, c, heads, scale),
                        (q, k, v), g)


def split_bwd(q, k, v, out, g, scale: float):
    """(dq, dk, dv) of the split entry: the JAX `_split_bwd`."""
    if _chunked(k.shape[2]):
        return attn_bwd_chunked(q, k, v, out, g, scale)
    return dispatch.vjp(lambda a, b, c: fused_attention_plain(a, b, c, scale), (q, k, v), g)


class _PackedAttention(torch.autograd.Function):
    """The packed entries under autograd (the JAX `_packed_vjp`)."""

    @staticmethod
    def forward(ctx, q, k, v, heads, scale, stream):
        out = _packed_forward(q, k, v, heads, scale, stream)
        ctx.save_for_backward(q, k, v, out)
        ctx.heads, ctx.scale = heads, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out = ctx.saved_tensors
        return (*packed_bwd(q, k, v, out, g, ctx.heads, ctx.scale), None, None, None)


class _SplitAttention(torch.autograd.Function):
    """The split entry under autograd (the JAX `_split_vjp`)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out = _split_forward(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out = ctx.saved_tensors
        return (*split_bwd(q, k, v, out, g, ctx.scale), None)
