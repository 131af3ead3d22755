"""Row LayerNorm: the CUDA kernel's wrapper and its plain version.

Counterpart of stablediffusioneo_tpu/ops/pallas/layernorm.py. The kernel
(csrc/layernorm.cu) replaces `_ln_kernel` (entry `fused_layer_norm`): fp32
one-pass row statistics, var = E[x²] - mean², affine in fp32, rounded once.
It takes bfloat16 and float32; the dispatch gate, as the JAX package's,
admits bfloat16 only. How a call is laid out on the card (access width,
threads a row, rows a block) is `layer_norm_plan`'s choice, a pure function
of the shape; the C entry launches exactly that plan or returns an error.
Under autograd the entry runs through a torch.autograd.Function (the JAX
`_ln_vjp`): its forward is the kernel (the plain version on the CPU), its
residuals (x, weight, bias), its backward the VJP of the plain version (the
JAX `_ln_bwd`, plain XLA there), the same code on both devices.
"""

from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple, Optional

import torch

from stablediffusioneo_tpu_torch.ops import dispatch
from stablediffusioneo_tpu_torch.ops.kernels.groupnorm import access_width

SOURCES = ("layernorm.cu",)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# The JAX package's gate constants (ops/pallas/layernorm.py).
_BLOCK_BUDGET_BYTES = 6 * 1024 * 1024
_BYTES_PER_ELEM_EST = 12
_MIN_ELEMS = 256 * 1024


MAX_THREADS = 512   # csrc/layernorm.cu kMaxThreads
MAX_VECTORS = 3     # csrc/layernorm.cu kMaxVectors
SM_COUNT = 132      # blocks that fill an H100
# Threads a block aims at, and blocks a launch aims at before a block takes
# more rows than it runs side by side. Measured on the H100 at the SD-1.5
# sites (scripts/torch_kernel_sweep.py ln, PERF.md section 6).
BLOCK_THREADS = 256
BLOCKS_BEFORE_LOOP = 2 * SM_COUNT


class LayerNormPlan(NamedTuple):
    """What one launch runs: elements per access; threads that share a row;
    vectors of the row each of them holds in registers (0: the row is too
    long to hold and is read twice); rows a block runs side by side; rows a
    block takes in all (a multiple of rows_par)."""
    vec: int
    threads_per_row: int
    vectors: int
    rows_par: int
    rows_block: int

    def __str__(self) -> str:
        held = f"{self.vectors} held" if self.vectors else "read twice"
        return (f"vec {self.vec} threads/row {self.threads_per_row} ({held}) "
                f"rows {self.rows_par} of {self.rows_block}")


# launches by plan since the last clear() (chip_smoke.py reads it)
plan_launches: "collections.Counter[LayerNormPlan]" = collections.Counter()
dispatch.register_counter(plan_launches)


def row_threads(vectors: int):
    """The thread counts a row of `vectors` accesses may be shared by: a
    power of two up to one warp, or whole warps up to the block."""
    legal = [1, 2, 4, 8, 16] + list(range(32, MAX_THREADS + 1, 32))
    return [t for t in legal if t < 2 * vectors or t == 1]


def layer_norm_plan(rows: int, c: int, dtype: torch.dtype, wdtype: torch.dtype,
                    aligned: bool = True,
                    threads_per_row: Optional[int] = None,
                    block_threads: Optional[int] = None,
                    loop: Optional[int] = None) -> LayerNormPlan:
    """The plan one call runs, a pure function of its arguments. `aligned`:
    x, y, gamma and beta start on 16 bytes. Accesses are the widest vector
    of at most 16 bytes of x that divides C (`access_width` of a row taken as
    one run of C elements). A row is shared by the fewest
    threads that hold it in `MAX_VECTORS` vectors each (so C = 320, 640, 1280 in
    bf16 take 16, 32 and 64 threads); a block runs as many rows side by side as
    fill `BLOCK_THREADS` threads, and takes more rows, one after the other,
    only when the launch would otherwise exceed `BLOCKS_BEFORE_LOOP` blocks.
    `threads_per_row`, `block_threads` and `loop` (the rows a block takes, in
    multiples of those it runs side by side) force those choices (tests,
    measurements)."""
    del wdtype  # gamma and beta follow x's vectors; two accesses where wider
    vec = access_width((1, c, 1, 1), 1, dtype.itemsize, True, 1, aligned)
    nvec = c // vec
    if threads_per_row is None:
        fits = [t for t in row_threads(nvec) if -(-nvec // t) <= MAX_VECTORS]
        threads_per_row = fits[0] if fits else MAX_THREADS
    held = -(-nvec // threads_per_row)
    vectors = held if held <= MAX_VECTORS else 0
    rows_par = max(1, (block_threads or BLOCK_THREADS) // threads_per_row)
    if threads_per_row < 32:  # whole warps
        rows_par = max(rows_par, 32 // threads_per_row)
    rows_block = rows_par * (loop or 1)
    while loop is None and -(-rows // rows_block) > BLOCKS_BEFORE_LOOP:
        rows_block *= 2
    return LayerNormPlan(vec, threads_per_row, vectors, rows_par, rows_block)


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
                       + [ctypes.c_longlong] + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    return lib


def fused_layer_norm(x, weight, bias, eps: float,
                     plan: Optional[LayerNormPlan] = None):
    """LayerNorm over the last dim of x (any leading dims). plan: a
    LayerNormPlan to run instead of `layer_norm_plan`'s choice (tests,
    measurements); the C entry refuses a plan that does not fit, and the
    refusal raises here."""
    if dispatch.needs_grad(x, weight, bias):
        return _LayerNorm.apply(x, weight, bias, float(eps), plan)
    return _layer_norm_forward(x, weight, bias, eps, plan)


class _LayerNorm(torch.autograd.Function):
    """fused_layer_norm under autograd (the JAX `_ln_vjp`)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, plan):
        ctx.save_for_backward(x, weight, bias)
        ctx.eps = eps
        return _layer_norm_forward(x, weight, bias, eps, plan)

    @staticmethod
    def backward(ctx, g):
        eps = ctx.eps
        grads = dispatch.vjp(lambda a, w, b: fused_layer_norm_plain(a, w, b, eps),
                     ctx.saved_tensors, g)
        return (*grads, None, None)


def _layer_norm_forward(x, weight, bias, eps: float, plan: Optional[LayerNormPlan]):
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
    rows = x.numel() // c
    if plan is None:
        plan = layer_norm_plan(rows, c, x.dtype, weight.dtype, all(
            t.data_ptr() % 16 == 0 for t in (x, y, weight, bias)))
    err = _library().sdeo_layer_norm(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[weight.dtype], rows, c, *plan,
        1.0 / c, eps, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"layer norm kernel launch failed ({plan}): "
                           f"cudaError {err}")
    plan_launches[plan] += 1
    dispatch.count_launch("fused_layer_norm")
    return y
