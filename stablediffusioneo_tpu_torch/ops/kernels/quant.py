"""Int8 weight-only matrix product: the CUDA kernel's wrapper and its plain
version.

Counterpart of stablediffusioneo_tpu/ops/pallas/quant.py. The kernel
(csrc/quant.cu) replaces `_qmm_kernel` (entry `quantized_matmul`): x (M, K)
times int8 weights dequantised with per-output-channel fp32 scales, fp32
accumulation, output in x's dtype. The weights keep torch's (out, in)
layout: w_q is (N, K), scale (N,). The source holds three variants;
`matmul_plan` chooses one, with its tile and K split, from the shape, the
dtype and the alignment, and the C entry launches exactly that plan or
returns an error.
"""

from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple, Optional, Tuple

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


# variant name -> code of csrc/quant.cu's `Variant`
VARIANTS = {
    "cuda_core": 0,  # fp32 x: fp32 FMAs, the exact checks
    "mma_sync": 1,   # bf16 x with K % 16 != 0 or unaligned views
    "wgmma": 2,      # bf16 x: int8 -> bf16 in registers, wgmma, TMA ring
}
SM_COUNT = 132          # blocks that fill an H100
K_SLICE = 64            # depth of one ring stage of the wgmma variant
_MIN_SLICES = 4         # K slices a block of a split product keeps at least
# blocks a tile's K slices are split over at most: at 8 the exchange of the
# partial tiles cost more than the extra blocks brought (PERF.md)
MAX_SPLIT = 4


class Plan(NamedTuple):
    """What one launch runs: the variant, a block's output tile (tm x rows by
    bn weight rows), the blocks a tile's K slices are split over (a thread
    block cluster, partial tiles added in rank order) and the ring depth."""
    variant: str
    tm: int
    bn: int
    split: int
    stages: int

    def __str__(self) -> str:
        return (f"{self.variant} {self.tm}x{self.bn} split {self.split} "
                f"stages {self.stages}")


# launches by plan since the last clear() (chip_smoke.py reads it)
plan_launches: "collections.Counter[Plan]" = collections.Counter()
dispatch.register_counter(plan_launches)


def plan_blocks(plan: Plan, m: int, n: int) -> int:
    return -(-m // plan.tm) * (n // plan.bn) * plan.split


def plan_smem_bytes(plan: Plan) -> int:
    """Dynamic shared memory of the wgmma variant (csrc/quant.cu QTile)."""
    ring = plan.stages * (plan.tm * K_SLICE * 2 + plan.bn * K_SLICE)
    return max(ring, plan.tm * (plan.bn + 4) * 4) + 2 * plan.stages * 8 + 1024


def split_pieces(k: int, split: int):
    """[begin, end) in K of each block of a split product."""
    slices = -(-k // K_SLICE)
    per = -(-slices // split)
    return [(min(k, z * per * K_SLICE), min(k, (z + 1) * per * K_SLICE))
            for z in range(split)]


def matmul_plan(m: int, k: int, n: int, dtype: torch.dtype,
                aligned: bool = True) -> Plan:
    """The plan one call runs, a pure function of its arguments. `aligned`:
    x, w_q, scale and the output start on 16 bytes. fp32 takes the CUDA
    cores. bf16 takes wgmma wherever a tensor map describes the operands (K
    % 16 == 0, aligned): the largest tile whose grid still covers the SMs; where none does
    (M = 128 or 512 against a narrow N), 64 weight rows a block and the K
    slices split over a cluster of at most `MAX_SPLIT` blocks until it does,
    a block keeping at least `_MIN_SLICES` slices."""
    if dtype != torch.bfloat16:
        return Plan("cuda_core", 64, 64, 1, 1)
    if k % 16 or not aligned:
        return Plan("mma_sync", 128, 128, 1, 1)
    tm = 128 if m > 64 else 64
    for bn in (128, 64):
        plan = Plan("wgmma", tm, bn, 1, 4)
        if plan_blocks(plan, m, n) >= SM_COUNT:
            return plan
    slices = -(-k // K_SLICE)
    split = 1
    while (plan_blocks(plan._replace(split=split), m, n) < SM_COUNT
           and split < MAX_SPLIT and slices // (2 * split) >= _MIN_SLICES):
        split *= 2
    return plan._replace(split=split)


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
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    return lib


def quantized_matmul(x, w_q, scale):
    """x (M, K) float32/bfloat16, w_q (N, K) int8, scale (N,) float32 ->
    (M, N) in x's dtype. Takes the shapes the gate sends: M a multiple of 8,
    N a multiple of 128."""
    if not dispatch.use_kernel(x, w_q, scale):
        return quantized_matmul_plain(x, w_q, scale)
    return _launch(x, w_q, scale)


def _launch(x, w_q, scale, plan: Optional[Plan] = None):
    """plan: a Plan to run instead of `matmul_plan`'s choice (for tests and
    measurements); the C entry refuses a plan that does not take the
    arguments, and the refusal raises here."""
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
    if plan is None:
        plan = matmul_plan(m, k, n, x.dtype, all(
            t.data_ptr() % 16 == 0 for t in (x, w_q, scale, out)))
    err = _library().sdeo_quantized_matmul(
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[x.dtype], m, n, k, VARIANTS[plan.variant], plan.tm, plan.bn,
        plan.split, plan.stages, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quantized matmul launch failed ({plan}): "
                           f"cudaError {err}")
    plan_launches[plan] += 1
    dispatch.count_launch("quantized_matmul")
    return out
