"""Row LayerNorm: the CUDA kernel's wrapper and its plain version.

Counterpart of stablediffusioneo_tpu/ops/pallas/layernorm.py. The kernel
(csrc/layernorm.cu) replaces `_ln_kernel` (entry `fused_layer_norm`): fp32
one-pass row statistics, var = E[x²] - mean², affine in fp32, rounded once.
It takes bfloat16 and float32; the dispatch gate, as the JAX package's,
admits bfloat16 only.
"""

from __future__ import annotations

import ctypes

import torch

from stablediffusioneo_tpu_torch.ops import dispatch

SOURCES = ("layernorm.cu",)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# The JAX package's gate constants (ops/pallas/layernorm.py).
_BLOCK_BUDGET_BYTES = 6 * 1024 * 1024
_BYTES_PER_ELEM_EST = 12
_MIN_ELEMS = 256 * 1024


def _pick_rows(rows: int, c: int) -> int:
    """The JAX package's row chunk: largest multiple of 8 dividing rows that
    fits its VMEM budget; 0 if none."""
    max_rows = _BLOCK_BUDGET_BYTES // (c * _BYTES_PER_ELEM_EST)
    best = 0
    for cand in range(8, max_rows + 1, 8):
        if rows % cand == 0:
            best = cand
    return best


def layer_norm_supported(shape, dtype) -> bool:
    """Dispatch gate, the JAX package's layer_norm_pallas_supported:
    bfloat16, at least 256K elements, row-chunkable."""
    if len(shape) < 2 or dtype != torch.bfloat16:
        return False
    c = shape[-1]
    rows = 1
    for s in shape[:-1]:
        rows *= s
    if rows * c < _MIN_ELEMS:
        return False
    return _pick_rows(rows, c) > 0


def fused_layer_norm_plain(x, weight, bias, eps: float):
    """Plain version of the kernel (`_ln_kernel` math)."""
    xf = x.float()
    inv_c = 1.0 / x.shape[-1]
    mean = xf.sum(-1, keepdim=True) * inv_c
    var = (xf * xf).sum(-1, keepdim=True) * inv_c - mean * mean
    y = (xf - mean) * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return y.to(x.dtype)


def _library() -> ctypes.CDLL:
    from stablediffusioneo_tpu_torch.ops.kernels.build import load_library

    lib = load_library("layernorm", SOURCES)
    fn = lib.sdeo_layer_norm
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                          ctypes.c_float, ctypes.c_void_p])
    return lib


def fused_layer_norm(x, weight, bias, eps: float):
    """LayerNorm over the last dim of x (any leading dims)."""
    if not dispatch.use_kernel(x, weight, bias):
        return fused_layer_norm_plain(x, weight, bias, eps)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"layer norm kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() < 1 or x.numel() == 0 or not x.is_contiguous():
        raise ValueError(f"layer norm kernel needs a contiguous non-empty input, "
                         f"got {tuple(x.shape)} strides {x.stride()}")
    c = x.shape[-1]
    for t in (weight, bias):
        if t.shape != (c,) or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"layer norm weight and bias must be contiguous ({c},) "
                             f"on {x.device}, got {tuple(t.shape)} on {t.device}")
    if weight.dtype not in _DTYPE_CODE or bias.dtype != weight.dtype:
        raise TypeError("layer norm weight and bias must share a float32 or "
                        f"bfloat16 dtype, got {weight.dtype} and {bias.dtype}")
    y = torch.empty_like(x)
    err = _library().sdeo_layer_norm(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[weight.dtype], x.numel() // c, c,
        1.0 / c, eps, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"layer norm kernel launch failed: cudaError {err}")
    dispatch.count_launch("fused_layer_norm")
    return y
