"""GroupNorm(+SiLU): the CUDA kernels' wrappers and their plain versions.

Counterpart of stablediffusioneo_tpu/ops/pallas/groupnorm.py. The kernels
(csrc/groupnorm.cu) replace `_gn_fused_kernel` / `_gn_resident_kernel`
(entry `fused_group_norm`, one pass), `_gn_stats_kernel` (entry
`group_norm_stats`) and `_gn_apply_kernel` (entry `group_norm_apply`).
`fused_group_norm` takes the one-pass kernel wherever the JAX entry does
(`_spatial_chunk(h*w, c) == h*w`) and the stats+apply pair otherwise.

Input is NCHW, in plain or channels-last memory (the port's networks hold
channels-last, the JAX package's NHWC bytes). The math is the Pallas
kernels', not F.group_norm's two-pass form: fp32 Σx and Σx² per (sample,
group), var = E[x²] - mean², affine and SiLU in fp32, rounded once. The
plain versions compute the same on CPU tensors.
"""

from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple, Optional

import torch

from stablediffusioneo_tpu_torch.ops import dispatch

SOURCES = ("groupnorm.cu",)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# The JAX package's VMEM regimes (ops/pallas/groupnorm.py), kept so that the
# port takes the one-pass kernel, and gates dispatch, exactly where it does.
_SINGLE_PASS_MAX_ELEMS = (15 * 1024 * 1024) // 18
_RESIDENT_MAX_ELEMS = (13 * 1024 * 1024) // 8
_CHUNK_BUDGET_BYTES = 6 * 1024 * 1024
_BYTES_PER_ELEM_EST = 16

# elements of one group per block of the two-pass kernels
_TWO_PASS_CHUNK_ELEMS = 16384
_MAX_CHUNKS = 65535  # grid y limit

MAX_CLUSTER = 8              # portable thread block cluster size
MAX_SLAB_BYTES = 232448 - 1024  # csrc/groupnorm.cu kMaxSlabBytes
THREADS = 512                # csrc/groupnorm.cu kFusedThreads
# Accesses (vectors) of one group beyond which it is spread over a cluster of
# two blocks. Measured on the H100 at the SD-1.5 sites
# (scripts/torch_kernel_sweep.py, PERF.md): up to four accesses a thread one
# block is fastest (it needs no cluster launch and no exchange); beyond, two
# blocks win at every site. Four blocks were level with two at the 64 x 64
# sites on some cards and 2-4 us slower on others, and slower everywhere
# else (a larger cluster costs more to schedule and to synchronise than its
# blocks bring), so the cluster grows past two only to fit shared memory.
SPREAD_BEYOND_VECTORS = 4 * THREADS


class NormPlan(NamedTuple):
    """What one launch of the one-pass kernel runs: elements per access, the
    blocks (one cluster) that share a (sample, group), the spatial rows each
    takes, and whether a block keeps its rows in shared memory between the
    sums and the normalisation (else it reads them again)."""
    vec: int
    cluster: int
    rows: int
    keep: bool

    def __str__(self) -> str:
        return (f"vec {self.vec} cluster {self.cluster} rows {self.rows} "
                f"{'kept' if self.keep else 'read twice'}")


# launches of the one-pass kernel by plan since the last clear()
# (chip_smoke.py reads it)
plan_launches: "collections.Counter[NormPlan]" = collections.Counter()


def access_width(shape, groups: int, itemsize: int, channels_last: bool,
                 rows: int, aligned: bool = True) -> int:
    """Elements per access: the widest vector of at most 16 bytes that
    divides every run of a group's elements and the pitch between runs. In
    channels-last memory a run is the group's C / groups channels of one
    spatial row (pitch C); in NCHW memory it is `rows` spatial rows of one
    channel (pitch H W). `aligned`: the tensors start on 16 bytes."""
    _, c, h, w = shape
    if not aligned:
        return 1
    units = (c // groups,) if channels_last else (rows, h * w)
    return next(v for v in (8, 4, 2, 1)
                if v * itemsize <= 16 and all(u % v == 0 for u in units))


def group_norm_plan(shape, groups: int, dtype: torch.dtype,
                    channels_last: bool, aligned: bool = True,
                    cluster: Optional[int] = None) -> NormPlan:
    """The plan one call of the one-pass kernel runs, a pure function of its
    arguments. A group of more than `SPREAD_BEYOND_VECTORS` accesses is spread
    over a cluster of two blocks, which doubles while a block's rows would
    not fit its shared memory; a slab that does not fit the largest cluster
    is read twice.
    `cluster` forces a size (tests, measurements)."""
    n, c, h, w = shape
    hw, cg, itemsize = h * w, c // groups, dtype.itemsize

    def rows_of(size: int) -> int:
        rows = -(-hw // size)
        if not channels_last:  # NCHW runs are `rows` long: keep them whole vectors
            v = access_width(shape, groups, itemsize, False, hw, aligned)
            rows = -(-rows // v) * v
        return rows

    def fits(size: int) -> bool:
        return rows_of(size) * cg * itemsize <= MAX_SLAB_BYTES

    if cluster is None:
        vectors = cg * hw // access_width(shape, groups, itemsize, channels_last,
                                          hw, aligned)
        cluster = 1 if vectors <= SPREAD_BEYOND_VECTORS else 2
        while cluster < MAX_CLUSTER and not fits(cluster):
            cluster *= 2
    rows = rows_of(cluster)
    vec = access_width(shape, groups, itemsize, channels_last, rows, aligned)
    return NormPlan(vec, cluster, rows, fits(cluster))


def _spatial_chunk(hw: int, c: int) -> int:
    """The JAX package's row chunk: == hw when its one-pass kernel fits,
    else a multiple of 8 that divides hw and fits the chunk budget (0 if
    none)."""
    if hw * c <= _RESIDENT_MAX_ELEMS and (
        hw * c <= _SINGLE_PASS_MAX_ELEMS or hw % 8 == 0
    ):
        return hw
    max_rows = _CHUNK_BUDGET_BYTES // (c * _BYTES_PER_ELEM_EST)
    chunk = 0
    for cand in range(8, max_rows + 1, 8):
        if hw % cand == 0:
            chunk = cand
    return chunk


def group_norm_supported(shape, groups: int) -> bool:
    """Dispatch gate, the JAX package's group_norm_pallas_supported on an
    NCHW shape: 4-D, channels divisible by groups, and the per-sample slab
    takes the one-pass kernel."""
    if len(shape) != 4:
        return False
    _, c, h, w = shape
    if c % groups:
        return False
    return _spatial_chunk(h * w, c) == h * w


def chunk_rows(x: torch.Tensor, groups: int) -> int:
    """Spatial rows per block of the two-pass kernels."""
    n, c, h, w = x.shape
    hw = h * w
    rows = max(1, _TWO_PASS_CHUNK_ELEMS // (c // groups))
    return min(hw, max(rows, -(-hw // _MAX_CHUNKS)))


# ------------------------------------------------------------ plain versions


def _group_view(x: torch.Tensor, groups: int) -> torch.Tensor:
    n, c = x.shape[:2]
    return x.float().reshape(n, groups, c // groups, -1)


def _mean_rstd(s1, s2, inv_count: float, eps: float):
    mean = s1 * inv_count
    var = s2 * inv_count - mean * mean
    return mean, torch.rsqrt(var + eps)


def _normalize(x, mean, rstd, weight, bias, swish: bool):
    """(x - mean) * rstd * gamma + beta (+ SiLU) in fp32, rounded to x's
    dtype; mean and rstd per (sample, group)."""
    n, c = x.shape[:2]
    groups = mean.shape[1]
    xf = _group_view(x, groups)
    y = (xf - mean[..., None, None]) * rstd[..., None, None]
    y = (y * weight.float().reshape(1, groups, -1, 1)
         + bias.float().reshape(1, groups, -1, 1))
    if swish:
        y = y * torch.sigmoid(y)
    return y.reshape(x.shape).to(x.dtype)


def fused_group_norm_plain(x, weight, bias, groups: int, eps: float,
                           swish: bool):
    """Plain version of the one-pass kernel (`_gn_fused_kernel` math)."""
    xf = _group_view(x, groups)
    s1, s2 = xf.sum((2, 3)), (xf * xf).sum((2, 3))
    inv_count = 1.0 / (xf.shape[2] * xf.shape[3])
    return _normalize(x, *_mean_rstd(s1, s2, inv_count, eps), weight, bias,
                      swish)


def group_norm_stats_plain(x, groups: int, rows: int):
    """Plain version of the stats kernel: (N, G, chunks, 2) fp32 Σx, Σx² of
    each group over spatial chunks of `rows` rows."""
    xf = _group_view(x, groups)
    return torch.stack([torch.stack([ch.sum((2, 3)), (ch * ch).sum((2, 3))], -1)
                        for ch in xf.split(rows, dim=3)], dim=2)


def group_norm_apply_plain(x, partials, weight, bias, eps: float, swish: bool):
    """Plain version of the apply kernel: reduce the partials, normalize."""
    n, c, h, w = x.shape
    sums = partials.sum(2)
    inv_count = 1.0 / (c // partials.shape[1] * h * w)
    return _normalize(x, *_mean_rstd(sums[..., 0], sums[..., 1], inv_count, eps),
                      weight, bias, swish)


# ------------------------------------------------------------------ kernels


def _library() -> ctypes.CDLL:
    from stablediffusioneo_tpu_torch.ops.kernels.build import load_library

    lib = load_library("groupnorm", SOURCES)
    if lib.sdeo_group_norm_fused.argtypes is None:
        ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sdeo_group_norm_fused.argtypes = [ptr] * 4 + [i] * 11 + [f, f, i, ptr]
        lib.sdeo_group_norm_stats.argtypes = [ptr] * 2 + [i] * 9 + [ptr]
        lib.sdeo_group_norm_apply.argtypes = [ptr] * 5 + [i] * 10 + [f, f, i, ptr]
        for fn in (lib.sdeo_group_norm_fused, lib.sdeo_group_norm_stats,
                   lib.sdeo_group_norm_apply):
            fn.restype = ctypes.c_int
    return lib


def _check_input(x: torch.Tensor, groups: int) -> int:
    """Raise on what the kernels do not take; return 1 for channels-last
    memory, 0 for plain NCHW."""
    if x.dim() != 4:
        raise ValueError(f"group norm kernel takes NCHW, got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"group norm kernel takes float32 or bfloat16, got {x.dtype}")
    n, c, h, w = x.shape
    if c % groups:
        raise ValueError(f"{c} channels not divisible by {groups} groups")
    if x.numel() == 0 or x.numel() >= 2 ** 31:
        raise ValueError(f"group norm kernel shape {tuple(x.shape)} out of range")
    if x.is_contiguous():
        return 0
    if x.is_contiguous(memory_format=torch.channels_last):
        return 1
    raise ValueError("group norm kernel needs contiguous NCHW or channels-last memory")


def _check_affine(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor):
    c = x.shape[1]
    for t in (weight, bias):
        if t.shape != (c,) or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"group norm weight and bias must be contiguous ({c},) "
                             f"on {x.device}, got {tuple(t.shape)} on {t.device}")
    if weight.dtype not in _DTYPE_CODE or bias.dtype != weight.dtype:
        raise TypeError("group norm weight and bias must share a float32 or "
                        f"bfloat16 dtype, got {weight.dtype} and {bias.dtype}")


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def group_norm_stats(x, groups: int, rows: int):
    """(N, G, ceil(h*w / rows), 2) fp32 partial Σx, Σx² per spatial chunk."""
    if not dispatch.use_kernel(x):
        return group_norm_stats_plain(x, groups, rows)
    cl = _check_input(x, groups)
    n, c, h, w = x.shape
    chunks = -(-(h * w) // rows)
    if not 0 < chunks <= _MAX_CHUNKS:
        raise ValueError(f"group norm stats: {chunks} chunks of {rows} rows")
    partials = torch.empty((n, groups, chunks, 2), dtype=torch.float32,
                           device=x.device)
    vec = access_width(x.shape, groups, x.element_size(), bool(cl), rows,
                       _aligned(x))
    _raise_on(_library().sdeo_group_norm_stats(
        x.data_ptr(), partials.data_ptr(), _DTYPE_CODE[x.dtype], cl, n, c,
        h * w, groups, rows, chunks, vec, _stream(x)), "group norm stats")
    dispatch.count_launch("group_norm_stats")
    return partials


def group_norm_apply(x, partials, weight, bias, rows: int, eps: float,
                     swish: bool):
    """Normalize, affine and SiLU from the stats kernel's partials."""
    if not dispatch.use_kernel(x, partials, weight, bias):
        return group_norm_apply_plain(x, partials, weight, bias, eps, swish)
    n, c, h, w = x.shape
    groups, chunks = partials.shape[1], partials.shape[2]
    cl = _check_input(x, groups)
    _check_affine(x, weight, bias)
    if (partials.shape != (n, groups, -(-(h * w) // rows), 2)
            or partials.dtype != torch.float32 or not partials.is_contiguous()):
        raise ValueError(f"group norm partials {tuple(partials.shape)} "
                         f"{partials.dtype} do not fit x {tuple(x.shape)}")
    y = torch.empty_like(x)
    vec = access_width(x.shape, groups, x.element_size(), bool(cl), rows,
                       _aligned(x, y, weight, bias))
    _raise_on(_library().sdeo_group_norm_apply(
        x.data_ptr(), partials.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        y.data_ptr(), _DTYPE_CODE[x.dtype], _DTYPE_CODE[weight.dtype], cl, n, c,
        h * w, groups, rows, chunks, vec, 1.0 / (c // groups * h * w), eps,
        int(swish), _stream(x)), "group norm apply")
    dispatch.count_launch("group_norm_apply")
    return y


def fused_group_norm(x, weight, bias, groups: int, eps: float,
                     swish: bool = False, plan: Optional[NormPlan] = None):
    """GroupNorm(+SiLU) of NCHW x with fp32 one-pass statistics: the
    one-pass kernel where the JAX entry runs its single pallas_call, the
    stats+apply pair otherwise. plan: a NormPlan for the one-pass kernel to
    run instead of `group_norm_plan`'s choice (tests, measurements); the C
    entry refuses a plan that does not fit, and the refusal raises here."""
    n, c, h, w = x.shape
    if _spatial_chunk(h * w, c) != h * w:
        rows = chunk_rows(x, groups)
        return group_norm_apply(x, group_norm_stats(x, groups, rows), weight,
                                bias, rows, eps, swish)
    if not dispatch.use_kernel(x, weight, bias):
        return fused_group_norm_plain(x, weight, bias, groups, eps, swish)
    cl = _check_input(x, groups)
    _check_affine(x, weight, bias)
    y = torch.empty_like(x)
    if plan is None:
        plan = group_norm_plan(x.shape, groups, x.dtype, bool(cl),
                               _aligned(x, y, weight, bias))
    _raise_on(_library().sdeo_group_norm_fused(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[weight.dtype], cl, n, c, h * w, groups,
        plan.vec, plan.cluster, plan.rows, int(plan.keep),
        1.0 / (c // groups * h * w), eps, int(swish), _stream(x)),
        f"group norm ({plan})")
    plan_launches[plan] += 1
    dispatch.count_launch("fused_group_norm")
    return y
