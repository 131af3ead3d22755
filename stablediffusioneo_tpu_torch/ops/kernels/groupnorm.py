"""GroupNorm(+SiLU): the CUDA kernels' wrappers and their plain versions.

Counterpart of stablediffusioneo_tpu/ops/pallas/groupnorm.py. The kernels
(csrc/groupnorm.cu) replace `_gn_fused_kernel` / `_gn_resident_kernel`
(entry `fused_group_norm`, one pass), `_gn_stats_kernel` (entry
`group_norm_stats`) and `_gn_apply_kernel` (entry `group_norm_apply`).
Each entry's launch plan is a pure function here (`group_norm_plan`,
`stats_plan`, `apply_plan`), handed to the C entry, which refuses a plan
that does not fit its arguments.
`fused_group_norm` takes the one-pass kernel wherever the JAX entry does
(`_spatial_chunk(h*w, c) == h*w`) and the stats+apply pair otherwise.

Input is NCHW, in plain or channels-last memory (the port's networks hold
channels-last, the JAX package's NHWC bytes). The math is the Pallas
kernels', not F.group_norm's two-pass form: fp32 Σx and Σx² per (sample,
group), var = E[x²] - mean², affine and SiLU in fp32, rounded once. The
plain versions compute the same on CPU tensors. The JAX package defines no
VJP for these kernels, so under autograd every entry raises, on either
device (ops/dispatch.py:refuse_grad).
"""

from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple, Optional

import torch

from stablediffusioneo_tpu_torch.ops import dispatch
from stablediffusioneo_tpu_torch.ops.kernels import build

SOURCES = ("groupnorm.cu",)
build.register("groupnorm", SOURCES)
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

CHUNK_THREADS = 256      # csrc/groupnorm.cu kChunkThreads
ROWS_MAX_THREADS = 512   # csrc/groupnorm.cu kRowsMaxThreads
APPLY_BATCH = 4          # csrc/groupnorm.cu kBatch: accesses a thread has in flight
SM_COUNT = 132           # blocks that fill an H100
# Blocks the rows-by-channels apply kernel aims at for each SM: enough to hide
# a block's prologue (the sample's partials, reduced in chunk order) behind
# the others' streaming. Measured on the H100 (scripts/torch_kernel_sweep.py
# apply, PERF.md section 6).
APPLY_BLOCKS_PER_SM = 2


class ApplyPlan(NamedTuple):
    """What one launch of the apply pass runs. by_rows: a block takes a tile
    of `tile_rows` whole spatial rows of one sample, all channels
    (channels-last memory only); else a block takes one (sample, group,
    chunk), `tile_rows` being the chunk's rows. vec: elements per access."""
    by_rows: bool
    vec: int
    threads: int
    tile_rows: int

    def __str__(self) -> str:
        return (f"{'rows x channels' if self.by_rows else 'group x chunk'} vec "
                f"{self.vec} threads {self.threads} tile {self.tile_rows} rows")


# launches of the apply kernel by plan since the last clear()
apply_plan_launches: "collections.Counter[ApplyPlan]" = collections.Counter()

SECTOR_BYTES = 32        # what the card fetches from device memory at least
STATS_BATCH = 8          # csrc/groupnorm.cu kStatsBatch: accesses a thread has in flight
STATS_SMEM_BYTES = 48 * 1024  # shared memory the rows x channels stats kernel may take
# The plan of the rows x channels stats kernel, measured on the H100
# (scripts/torch_kernel_sweep.py stats, PERF.md section 6): the widest block of
# whole rows is fastest (512 threads 26.9 us, 256 threads 30.7 at
# (1,128,512,512) in bf16); the cluster of a (sample, chunk) doubles while the
# launch stays within one block an SM (64 chunks: two blocks each 26.9 us, one
# 30.9, four 37.0) and a block's share still gives every thread
# `STATS_MIN_BATCHES` batches of accesses; it stops at four blocks, since 16
# clusters of eight fit the card's GPCs only where every GPC has 16 free SMs
# (14.1 us against 9.8 for clusters of four at (2,960,64,64) in bf16).
STATS_MAX_CLUSTER = 4
STATS_MIN_BATCHES = 4


class StatsPlan(NamedTuple):
    """What one launch of the stats pass runs. by_rows: a cluster of `cluster`
    blocks of `threads` threads takes one (sample, chunk), all channels, each
    block a share of the chunk's spatial rows (channels-last memory only);
    else one block takes one (sample, group, chunk). vec: elements per
    access."""
    by_rows: bool
    vec: int
    threads: int
    cluster: int

    def __str__(self) -> str:
        return (f"{'rows x channels' if self.by_rows else 'group x chunk'} vec "
                f"{self.vec} threads {self.threads} cluster {self.cluster}")


# launches of the stats kernel by plan since the last clear()
stats_plan_launches: "collections.Counter[StatsPlan]" = collections.Counter()

for _counter in (plan_launches, apply_plan_launches, stats_plan_launches):
    dispatch.register_counter(_counter)


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


def apply_plan(shape, groups: int, dtype: torch.dtype, channels_last: bool,
               rows: int, aligned: bool = True,
               by_rows: Optional[bool] = None) -> ApplyPlan:
    """The plan one call of the apply pass runs, a pure function of its
    arguments; `rows` are the spatial rows of a chunk of the partials.
    Channels-last memory is cut by rows x all channels: accesses of the
    widest vector of at most 16 bytes that divides C (it may straddle
    groups), a block as wide as a whole number of rows' vectors where one
    fits (then a thread's column, and with it its group, gamma and beta, is
    fixed), and tiles of so many rows that each SM gets about
    `APPLY_BLOCKS_PER_SM` blocks and a thread at least one batch of accesses.
    NCHW memory, whose runs are whole chunks of a channel, keeps one block a
    (sample, group, chunk). `by_rows` forces the cut (tests, measurements)."""
    n, c, h, w = shape
    hw = h * w
    if by_rows is None:
        by_rows = channels_last
    if not by_rows:
        return ApplyPlan(False, access_width(shape, groups, dtype.itemsize,
                                             channels_last, rows, aligned),
                         CHUNK_THREADS, rows)
    if not channels_last:
        raise ValueError("the rows x channels apply plan takes channels-last memory")
    # a vector stays inside a spatial row (one "group" of all C channels)
    vec = access_width(shape, 1, dtype.itemsize, True, rows, aligned)
    rv = c // vec  # vectors of one spatial row
    # the widest block of whole rows up to the most threads; a row wider
    # than that is walked with a moving column
    threads = _whole_row_threads(rv) or CHUNK_THREADS
    batch_rows = -(-threads * APPLY_BATCH // rv)  # rows one batch of the block covers
    tile_rows = max(batch_rows, -(-n * hw // (APPLY_BLOCKS_PER_SM * SM_COUNT)))
    tile_rows = -(-tile_rows // batch_rows) * batch_rows
    return ApplyPlan(True, vec, threads, min(tile_rows, hw))


def _whole_row_threads(rv: int, widest: bool = False) -> int:
    """The block width, a whole number of rows of `rv` vectors and of warps,
    nearest to CHUNK_THREADS (widest: the widest within ROWS_MAX_THREADS); 0
    when there is none."""
    whole = [t for t in range(rv, ROWS_MAX_THREADS + 1, rv) if t % 32 == 0]
    if not whole:
        return 0
    return max(whole) if widest else min(whole, key=lambda t: (abs(t - CHUNK_THREADS), t))


def stats_plan(shape, groups: int, dtype: torch.dtype, channels_last: bool,
               rows: int, aligned: bool = True, by_rows: Optional[bool] = None,
               cluster: Optional[int] = None) -> StatsPlan:
    """The plan one call of the stats pass runs, a pure function of its
    arguments; `rows` are the spatial rows of a chunk of the partials.
    Channels-last memory whose groups' runs are narrower than a sector (at
    C = 128 a run is 8 bytes in bf16, so four (sample, group, chunk) blocks
    would fetch each sector) is cut by rows x all channels where a block of
    whole rows fits (the widest vector of at most 16 bytes that divides C; the
    widest block of a whole number of rows' vectors, so a thread's column is
    fixed; its column sums within `STATS_SMEM_BYTES`): a (sample, chunk) is
    one contiguous span, shared by a cluster sized as the constants above say.
    NCHW memory, whose runs are whole chunks of a channel, wider runs (at
    C = 960 the (sample, group, chunk) kernel measured faster) and shapes with
    no such block keep one block a (sample, group, chunk). `by_rows` and
    `cluster` force the cut and the cluster size (tests, measurements)."""
    n, c, h, w = shape
    hw = h * w
    vec = access_width(shape, 1, dtype.itemsize, True, rows, aligned)
    threads = _whole_row_threads(c // vec, widest=True)
    fits = (channels_last and threads > 0
            and (threads * vec + c + groups) * 8 <= STATS_SMEM_BYTES)
    if by_rows is None:
        by_rows = fits and c // groups * dtype.itemsize < SECTOR_BYTES
    if not by_rows:
        return StatsPlan(False, access_width(shape, groups, dtype.itemsize,
                                             channels_last, rows, aligned),
                         CHUNK_THREADS, 1)
    if not fits:
        raise ValueError("the rows x channels stats plan takes channels-last "
                         f"memory and a block of whole rows; got {tuple(shape)}")
    if cluster is None:
        rows = min(rows, hw)
        pairs = n * -(-hw // rows)
        # rows that give every thread of a block its least batches
        least = STATS_MIN_BATCHES * -(-threads * STATS_BATCH // (c // vec))
        cluster = 1
        while (cluster < STATS_MAX_CLUSTER and 2 * cluster * pairs <= SM_COUNT
               and rows >= 2 * cluster * least):
            cluster *= 2
    return StatsPlan(True, vec, threads, cluster)


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


def memory_layout(x: torch.Tensor) -> str:
    """"contiguous", "channels_last" (4-D only) or "strided"."""
    if x.is_contiguous():
        return "contiguous"
    if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
        return "channels_last"
    return "strided"


def refusal(shape, groups: int, dtype: torch.dtype, layout: str) -> Optional[Exception]:
    """Why the kernels do not take an input of this shape, dtype and memory
    layout (`memory_layout`'s name), or None where they do, one pass or the
    stats + apply pair as `fused_group_norm` picks. The one rule: the
    entries raise it (`_check_input`) and ops/norms.py routes by it. There
    is no gate of the JAX package's here; the batch stays within the grid's
    y limit, which the rows x channels kernels take it along. (A chunk count
    `chunk_rows` gives never passes that limit.)"""
    if len(shape) != 4:
        return ValueError(f"group norm kernel takes NCHW, got shape {tuple(shape)}")
    if dtype not in _DTYPE_CODE:
        return TypeError(f"group norm kernel takes float32 or bfloat16, got {dtype}")
    n, c, h, w = shape
    if groups < 1 or c % groups:
        return ValueError(f"{c} channels not divisible by {groups} groups")
    if not 0 < n * c * h * w < 2 ** 31 or n > _MAX_CHUNKS:
        return ValueError(f"group norm kernel shape {tuple(shape)} out of range")
    if layout not in ("contiguous", "channels_last"):
        return ValueError("group norm kernel needs contiguous NCHW or channels-last memory")
    return None


def affine_refusal(what: str, c: int, device: torch.device, weight: torch.Tensor,
                   bias: torch.Tensor) -> Optional[Exception]:
    """Why the kernel `what` ("group norm", "layer norm") does not take this
    weight and bias for c channels on `device`, or None where it does:
    contiguous (c,) tensors on that device, both float32 or both bfloat16."""
    for t in (weight, bias):
        if t.shape != (c,) or not t.is_contiguous() or t.device != device:
            return ValueError(f"{what} weight and bias must be contiguous ({c},) "
                              f"on {device}, got {tuple(t.shape)} on {t.device}")
    if weight.dtype not in _DTYPE_CODE or bias.dtype != weight.dtype:
        return TypeError(f"{what} weight and bias must share a float32 or "
                         f"bfloat16 dtype, got {weight.dtype} and {bias.dtype}")
    return None


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


def group_norm_apply_plain(x, partials, weight, bias, eps: float, swish: bool,
                           count: Optional[int] = None):
    """Plain version of the apply kernel: reduce the partials, normalize."""
    n, c, h, w = x.shape
    sums = partials.sum(2)
    inv_count = 1.0 / (count or c // partials.shape[1] * h * w)
    return _normalize(x, *_mean_rstd(sums[..., 0], sums[..., 1], inv_count, eps),
                      weight, bias, swish)


# ------------------------------------------------------------------ kernels


def _library() -> ctypes.CDLL:
    lib = build.load_library("groupnorm", SOURCES)
    if lib.sdeo_group_norm_fused.argtypes is None:
        ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sdeo_group_norm_fused.argtypes = [ptr] * 4 + [i] * 11 + [f, f, i, ptr]
        lib.sdeo_group_norm_stats.argtypes = [ptr] * 2 + [i] * 12 + [ptr]
        lib.sdeo_group_norm_apply.argtypes = [ptr] * 5 + [i] * 13 + [f, f, i, ptr]
        for fn in (lib.sdeo_group_norm_fused, lib.sdeo_group_norm_stats,
                   lib.sdeo_group_norm_apply):
            fn.restype = ctypes.c_int
    return lib


def _check_input(x: torch.Tensor, groups: int) -> int:
    """Raise `refusal`'s reason; return 1 for channels-last memory, 0 for
    plain NCHW."""
    layout = memory_layout(x)
    err = refusal(x.shape, groups, x.dtype, layout)
    if err is not None:
        raise err
    return int(layout == "channels_last")


def _check_affine(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor):
    err = affine_refusal("group norm", x.shape[1], x.device, weight, bias)
    if err is not None:
        raise err


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def group_norm_stats(x, groups: int, rows: int,
                     plan: Optional[StatsPlan] = None):
    """(N, G, ceil(h*w / rows), 2) fp32 partial Σx, Σx² per spatial chunk.
    plan: a StatsPlan to run instead of `stats_plan`'s choice (tests,
    measurements); the C entry refuses a plan that does not fit, and the
    refusal raises."""
    dispatch.refuse_grad("group_norm_stats", x)
    if not dispatch.use_kernel(x):
        return group_norm_stats_plain(x, groups, rows)
    cl = _check_input(x, groups)
    n, c, h, w = x.shape
    chunks = -(-(h * w) // rows)
    if not 0 < chunks <= _MAX_CHUNKS:
        raise ValueError(f"group norm stats: {chunks} chunks of {rows} rows")
    partials = torch.empty((n, groups, chunks, 2), dtype=torch.float32,
                           device=x.device)
    if plan is None:
        plan = stats_plan(x.shape, groups, x.dtype, bool(cl), rows, _aligned(x))
    _raise_on(_library().sdeo_group_norm_stats(
        x.data_ptr(), partials.data_ptr(), _DTYPE_CODE[x.dtype], cl, n, c,
        h * w, groups, rows, chunks, int(plan.by_rows), plan.vec, plan.threads,
        plan.cluster, _stream(x)), f"group norm stats ({plan})")
    stats_plan_launches[plan] += 1
    dispatch.count_launch("group_norm_stats")
    return partials


def group_norm_apply(x, partials, weight, bias, rows: int, eps: float,
                     swish: bool, plan: Optional[ApplyPlan] = None,
                     count: Optional[int] = None):
    """Normalize, affine and SiLU from the stats kernel's partials. plan: an
    ApplyPlan to run instead of `apply_plan`'s choice (tests, measurements);
    the C entry refuses a plan that does not fit, and the refusal raises.
    count: the elements a group's partials sum over (default x's own, c /
    groups * h * w; partials summed over an image's row shards cover more)."""
    dispatch.refuse_grad("group_norm_apply", x, partials, weight, bias)
    if not dispatch.use_kernel(x, partials, weight, bias):
        return group_norm_apply_plain(x, partials, weight, bias, eps, swish, count)
    n, c, h, w = x.shape
    groups, chunks = partials.shape[1], partials.shape[2]
    cl = _check_input(x, groups)
    _check_affine(x, weight, bias)
    if (partials.shape != (n, groups, -(-(h * w) // rows), 2)
            or partials.dtype != torch.float32 or not partials.is_contiguous()):
        raise ValueError(f"group norm partials {tuple(partials.shape)} "
                         f"{partials.dtype} do not fit x {tuple(x.shape)}")
    y = torch.empty_like(x)
    if plan is None:
        plan = apply_plan(x.shape, groups, x.dtype, bool(cl), rows,
                          _aligned(x, y, weight, bias))
    _raise_on(_library().sdeo_group_norm_apply(
        x.data_ptr(), partials.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        y.data_ptr(), _DTYPE_CODE[x.dtype], _DTYPE_CODE[weight.dtype], cl, n, c,
        h * w, groups, rows, chunks, int(plan.by_rows), plan.vec, plan.threads,
        plan.tile_rows, 1.0 / (count or c // groups * h * w), eps, int(swish),
        _stream(x)), f"group norm apply ({plan})")
    apply_plan_launches[plan] += 1
    dispatch.count_launch("group_norm_apply")
    return y


def fused_group_norm(x, weight, bias, groups: int, eps: float,
                     swish: bool = False, plan: Optional[NormPlan] = None):
    """GroupNorm(+SiLU) of NCHW x with fp32 one-pass statistics: the
    one-pass kernel where the JAX entry runs its single pallas_call, the
    stats+apply pair otherwise. plan: a NormPlan for the one-pass kernel to
    run instead of `group_norm_plan`'s choice (tests, measurements); the C
    entry refuses a plan that does not fit, and the refusal raises here."""
    dispatch.refuse_grad("fused_group_norm", x, weight, bias)
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
