"""Int8 weight-only matrix product: the CUDA kernel's wrapper and its plain
version.

Counterpart of stablediffusioneo_tpu/ops/pallas/quant.py. The kernel
(csrc/quant.cu) replaces `_qmm_kernel` (entry `quantized_matmul`): x (M, K)
times int8 weights dequantised with per-output-channel fp32 scales, fp32
accumulation, output in x's dtype. The weights keep torch's (out, in)
layout: w_q is (N, K), scale (N,).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from stablediffusioneo_tpu_torch.ops import dispatch

SOURCES = ("quant.cu",)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# The JAX package's block picks (ops/pallas/quant.py quantized_linear): the
# largest of these dividing N and M. The gate sends a product to the kernel
# only when both exist.
BLOCK_N = (512, 256, 128)
BLOCK_M = (512, 256, 128, 64, 32, 16, 8)


def pick_blocks(m: int, n: int) -> Optional[Tuple[int, int]]:
    """(block_m, block_n) as the JAX package picks them, or None."""
    bn = next((b for b in BLOCK_N if n % b == 0), None)
    bm = next((b for b in BLOCK_M if m % b == 0), None)
    return (bm, bn) if bm and bn else None


def quantized_matmul_plain(x, w_q, scale):
    """Plain version of the kernel (`_qmm_kernel` math): x in fp32 against
    the fp32 dequantised weights q * s, rounded once to x's dtype."""
    w = w_q.float() * scale.float()[:, None]
    return (x.float() @ w.T).to(x.dtype)


def _library() -> ctypes.CDLL:
    from stablediffusioneo_tpu_torch.ops.kernels.build import load_library

    lib = load_library("quant", SOURCES)
    fn = lib.sdeo_quantized_matmul
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return lib


def quantized_matmul(x, w_q, scale):
    """x (M, K) float32/bfloat16, w_q (N, K) int8, scale (N,) float32 ->
    (M, N) in x's dtype. Takes the shapes the gate sends: M a multiple of 8,
    N a multiple of 128."""
    if not dispatch.use_kernel(x, w_q, scale):
        return quantized_matmul_plain(x, w_q, scale)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"quantized matmul takes float32 or bfloat16 x, got {x.dtype}")
    if w_q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"quantized matmul takes int8 weights and float32 scales, "
                        f"got {w_q.dtype} and {scale.dtype}")
    if x.dim() != 2 or w_q.dim() != 2 or scale.shape != (w_q.shape[0],):
        raise ValueError(f"quantized matmul shapes x {tuple(x.shape)}, "
                         f"w_q {tuple(w_q.shape)}, scale {tuple(scale.shape)}")
    (m, k), n = x.shape, w_q.shape[0]
    if w_q.shape[1] != k or pick_blocks(m, n) is None:
        raise ValueError(f"quantized matmul takes M % 8 == 0 and N % 128 == 0 "
                         f"with matching K, got x {tuple(x.shape)}, w_q "
                         f"{tuple(w_q.shape)}")
    if not (x.is_contiguous() and w_q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("quantized matmul needs contiguous rows of x and w_q")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    err = _library().sdeo_quantized_matmul(
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[x.dtype], m, n, k, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quantized matmul launch failed: cudaError {err}")
    dispatch.count_launch("quantized_matmul")
    return out
