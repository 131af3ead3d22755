"""Fused attention: the CUDA kernel's wrappers and their plain versions.

Counterpart of stablediffusioneo_tpu/ops/pallas/attention.py. The kernel
(csrc/attention.cu) replaces `_attn_kernel_packed` (entry
`fused_attention_packed`) and `_attn_kernel` (entry `fused_attention`); both
entries launch the same CUDA kernel and differ only in the strides they
pass. On CPU tensors each entry runs its plain version, which mirrors the
JAX package's `_packed_math` / `_split_math`.
"""

from __future__ import annotations

import ctypes

import torch

from stablediffusioneo_tpu_torch.ops import dispatch

SOURCES = ("attention.cu",)
HEAD_DIMS = (40, 64, 80, 160, 512)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LL = ctypes.c_longlong


def _library() -> ctypes.CDLL:
    from stablediffusioneo_tpu_torch.ops.kernels.build import load_library

    lib = load_library("attention", SOURCES)
    fn = lib.sdeo_attention_forward
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [_LL] * 12 + [ctypes.c_float, ctypes.c_void_p])
    return lib


def _scaled_q(q: torch.Tensor, scale: float) -> torch.Tensor:
    # the scale is rounded to q's dtype first, as jnp.asarray(scale, q.dtype)
    return q * torch.tensor(scale, dtype=q.dtype, device=q.device)


def _rounded_scale(scale: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(scale, dtype=dtype))


def _launch(q, k, v, out, batch, heads, tq, s, head_dim, strides, scale):
    """strides: (batch, head, token) element strides of q, k, v, out."""
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
    fn = _library().sdeo_attention_forward
    flat = [x for st in strides for x in st]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             _DTYPE_CODE[q.dtype], batch, heads, tq, s, head_dim, *flat,
             _rounded_scale(scale, q.dtype), stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: cudaError {err}")


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


def fused_attention_packed(q, k, v, heads: int, scale: float):
    """Head-packed layout: q (B, Tq, H*D), k/v (B, S, H*D) -> (B, Tq, H*D).
    Heads are sliced inside the kernel by the head stride, so no
    (B,T,H,D)<->(B,H,T,D) relayout happens. q, k and v may be column views
    of a fused QKV projection: only the head dim must be contiguous."""
    if not dispatch.use_kernel(q, k, v):
        return fused_attention_packed_plain(q, k, v, heads, scale)
    b, tq, c = q.shape
    s = k.shape[1]
    if c % heads or k.shape != (b, s, c) or v.shape != (b, s, c):
        raise ValueError(f"packed attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, heads {heads}")
    d = c // heads
    out = torch.empty((b, tq, c), dtype=q.dtype, device=q.device)
    strides = [(t.stride(0), d, t.stride(1)) for t in (q, k, v, out)]
    _launch(q, k, v, out, b, heads, tq, s, d, strides, scale)
    dispatch.count_launch("fused_attention_packed")
    return out


# -------------------------------------------------------------- split entry


def fused_attention_plain(q, k, v, scale: float):
    """Plain version of the split kernel (JAX `_split_math`)."""
    logits = torch.matmul(_scaled_q(q, scale).float(),
                          k.float().transpose(-1, -2))
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(w.float(), v.float()).to(q.dtype)


def fused_attention(q, k, v, scale: float):
    """Split layout: q (B, H, Tq, D), k/v (B, H, S, D) -> (B, H, Tq, D)."""
    if not dispatch.use_kernel(q, k, v):
        return fused_attention_plain(q, k, v, scale)
    b, h, tq, d = q.shape
    s = k.shape[2]
    if k.shape != (b, h, s, d) or v.shape != (b, h, s, d):
        raise ValueError(f"split attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    out = torch.empty((b, h, tq, d), dtype=q.dtype, device=q.device)
    strides = [(t.stride(0), t.stride(1), t.stride(2)) for t in (q, k, v, out)]
    _launch(q, k, v, out, b, h, tq, s, d, strides, scale)
    dispatch.count_launch("fused_attention")
    return out
