"""The launch plans of the int8 matmul, GroupNorm and LayerNorm kernels.

Which variant, tile, K split, access width, cluster size, threads a row and
tile of rows a call runs is a pure function of its arguments
(`ops/kernels/quant.py:matmul_plan`, `ops/kernels/groupnorm.py:
group_norm_plan` and `apply_plan`, `ops/kernels/layernorm.py:
layer_norm_plan`), chosen in Python and passed to the C entry. Held here, on the CPU, over every main-path shape of the SD-1.5
configuration (the 512x512 request and the 1024x1024 hires pass) and over
ragged ones: what the C entries would refuse never comes out of the plan
functions. The kernels themselves run on the card (tests/test_torch_cuda.py).
Also: a shared header under csrc/ is part of every library's hash.
"""

import os
import shutil
import sys

import pytest
import torch

from stablediffusioneo_tpu_torch.config import sd15_pipeline
from stablediffusioneo_tpu_torch.ops.kernels import build
from stablediffusioneo_tpu_torch.ops.kernels import groupnorm as kg
from stablediffusioneo_tpu_torch.ops.kernels import layernorm as kl
from stablediffusioneo_tpu_torch.ops.kernels import quant as kq

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402  (the plan-derived main-path shapes)

CFG = sd15_pipeline()
SMEM = 232448  # bytes of shared memory one block can use on the H100


def _gemms(res):
    return sorted(set(chip_smoke.quant_gated(chip_smoke.quant_sites(CFG, res))))


def _gn_sites(res):
    """(shape, groups) of every gated one-pass GroupNorm site of a step."""
    return sorted({(shape, groups)
                   for kind, shape, swish, groups in chip_smoke.norm_sites(CFG, res)["step"]
                   if kind == "gn" and chip_smoke.gated((kind, shape, swish, groups),
                                                        torch.bfloat16)})


GEMMS_512 = _gemms(512)
GEMMS = GEMMS_512 + [s for s in _gemms(1024) if s not in GEMMS_512]
GN_512 = _gn_sites(512)
GN = GN_512 + [s for s in _gn_sites(1024) if s not in GN_512]


# ------------------------------------------------------------ int8 matmul


def test_the_seven_gated_products_of_a_512_step():
    assert GEMMS_512 == sorted([
        (8192, 320, 2560), (2048, 640, 5120), (2048, 2560, 640), (512, 1280, 10240),
        (512, 5120, 1280), (128, 1280, 10240), (128, 5120, 1280)])


@pytest.mark.parametrize("m,k,n", GEMMS, ids=[f"{m}x{k}x{n}" for m, k, n in GEMMS])
def test_main_path_products_take_the_wgmma_variant(m, k, n):
    plan = kq.matmul_plan(m, k, n, torch.bfloat16)
    assert plan.variant == "wgmma" and plan.variant in kq.VARIANTS
    assert plan.tm in (64, 128) and plan.bn in (64, 128) and plan.stages == 4
    assert n % plan.bn == 0 and plan.tm % plan.split == 0
    assert plan.split in (1, 2, 4) and plan.split <= kq.MAX_SPLIT
    assert kq.plan_smem_bytes(plan) <= SMEM
    # the grid covers the SMs wherever the work allows: short of them only
    # when the K split is at its cap or a block would keep too few slices
    slices = -(-k // kq.K_SLICE)
    assert (kq.plan_blocks(plan, m, n) >= kq.SM_COUNT or plan.split == kq.MAX_SPLIT
            or slices // (2 * plan.split) < 4)
    # the same shape in fp32 and off 16-byte alignment
    assert kq.matmul_plan(m, k, n, torch.float32).variant == "cuda_core"
    assert kq.matmul_plan(m, k, n, torch.bfloat16, aligned=False).variant == "mma_sync"


@pytest.mark.parametrize("k", [64, 320, 1280, 5120, 208, 1040])
@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_split_pieces_cover_k_exactly(k, split):
    pieces = kq.split_pieces(k, split)
    assert len(pieces) == split and pieces[0][0] == 0 and pieces[-1][1] == k
    for (a, b), (c, _) in zip(pieces, pieces[1:]):
        assert a <= b == c  # contiguous, in order; a late piece may be empty
    assert all(a % kq.K_SLICE == 0 for a, _ in pieces if a < k)


@pytest.mark.parametrize("m,k,n,dtype,variant,tm", [
    (8, 64, 128, torch.bfloat16, "wgmma", 64),       # one x row group
    (136, 1024, 256, torch.bfloat16, "wgmma", 128),  # M ends inside a tile
    (40, 208, 384, torch.bfloat16, "wgmma", 64),     # K ends inside a slice
    (8, 24, 128, torch.bfloat16, "mma_sync", 128),   # K % 16 != 0
    (136, 100, 384, torch.bfloat16, "mma_sync", 128),
    (40, 200, 384, torch.bfloat16, "mma_sync", 128),
    (8, 24, 128, torch.float32, "cuda_core", 64),
    (136, 1024, 256, torch.float32, "cuda_core", 64),
])
def test_ragged_products(m, k, n, dtype, variant, tm):
    plan = kq.matmul_plan(m, k, n, dtype)
    assert (plan.variant, plan.tm) == (variant, tm)
    assert n % plan.bn == 0
    if variant == "wgmma":
        assert kq.plan_smem_bytes(plan) <= SMEM
        assert kq.split_pieces(k, plan.split)[-1][1] == k
    else:
        assert plan.split == 1


@pytest.mark.parametrize("m,k,n,want", [
    (8192, 320, 2560, ("wgmma", 128, 128, 1, 4)),   # 1280 tiles: the large tile
    (2048, 2560, 640, ("wgmma", 128, 64, 1, 4)),    # 80 large tiles: 64 weight rows
    (512, 5120, 1280, ("wgmma", 128, 64, 2, 4)),    # 80 blocks: K over 2
    (128, 5120, 1280, ("wgmma", 128, 64, 4, 4)),    # 20 blocks: K over the cap of 4
])
def test_plans_of_named_products(m, k, n, want):
    assert tuple(kq.matmul_plan(m, k, n, torch.bfloat16)) == want
    assert str(kq.Plan(*want)).startswith("wgmma ")


# ------------------------------------------------------- one-pass GroupNorm


def test_the_fifteen_gated_group_norm_shapes_of_a_512_step():
    with_swish = {(shape, swish, groups)
                  for kind, shape, swish, groups in chip_smoke.norm_sites(CFG, 512)["step"]
                  if kind == "gn" and chip_smoke.gated((kind, shape, swish, groups),
                                                       torch.bfloat16)}
    assert len(with_swish) == 15 and len(GN_512) == 11


@pytest.mark.parametrize("channels_last", [True, False], ids=["channels_last", "nchw"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape,groups", GN, ids=[f"{s[1]}x{s[2]}x{s[3]}" for s, _ in GN])
def test_main_path_group_norm_plans(shape, groups, dtype, channels_last):
    plan = kg.group_norm_plan(shape, groups, dtype, channels_last)
    n, c, h, w = shape
    hw, cg, size = h * w, c // groups, dtype.itemsize
    assert plan.cluster in (1, 2, 4, 8) and plan.cluster <= kg.MAX_CLUSTER
    assert plan.vec in (1, 2, 4, 8) and plan.vec * size <= 16
    if channels_last:  # the group's run at one pixel, and the pitch between runs
        assert cg % plan.vec == 0 and c % plan.vec == 0
    else:  # a channel's rows of one block, and the pitch between channels
        assert plan.rows % plan.vec == 0 and hw % plan.vec == 0
    assert plan.rows * plan.cluster >= hw > plan.rows * (plan.cluster - 1)
    assert plan.keep and plan.rows * cg * size <= kg.MAX_SLAB_BYTES <= SMEM
    # spread over a cluster wherever the work allows: a group of more than
    # four accesses a thread never stays in one block
    vectors = cg * hw // plan.vec
    assert kg.SPREAD_BEYOND_VECTORS == 4 * kg.THREADS
    assert (plan.cluster > 1) == (vectors > kg.SPREAD_BEYOND_VECTORS)
    assert plan.cluster <= 2  # larger clusters only where shared memory asks
    if plan.cluster > 1:
        assert n * groups * plan.cluster >= 128


@pytest.mark.parametrize("shape,want", [
    ((2, 320, 64, 64), (2, 2, 2048, True)),   # 20-byte runs: 4-byte accesses
    ((2, 640, 32, 32), (4, 2, 512, True)),    # 40-byte runs: 8-byte accesses
    ((2, 1280, 32, 32), (8, 2, 512, True)),   # 80-byte runs: 16-byte accesses
    ((2, 1280, 8, 8), (8, 1, 64, True)),      # 320 accesses: one block
    ((2, 1280, 16, 16), (8, 1, 256, True)),   # 1280 accesses: still one block
    ((2, 2560, 16, 16), (8, 2, 128, True)),   # 2560 accesses: two
])
def test_plans_of_named_group_norm_shapes(shape, want):
    assert tuple(kg.group_norm_plan(shape, 32, torch.bfloat16, True)) == want


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_forced_cluster_sizes_stay_legal(cluster):
    for channels_last in (True, False):
        plan = kg.group_norm_plan((2, 960, 32, 32), 32, torch.bfloat16, channels_last,
                                  cluster=cluster)
        assert plan.cluster == cluster and plan.rows * cluster >= 1024 and plan.keep
        assert plan.vec == (8 if not channels_last else 2)


def test_ragged_group_norm_plans():
    # 12 channels a group over 24 x 40 pixels: 8-byte accesses in both formats
    plan = kg.group_norm_plan((1, 96, 24, 40), 8, torch.bfloat16, True)
    assert plan.vec == 4 and plan.rows * plan.cluster >= 960
    plan = kg.group_norm_plan((1, 96, 24, 40), 8, torch.float32, False)
    assert plan.vec == 4 and plan.rows % 4 == 0
    # an odd run length: element accesses
    assert kg.group_norm_plan((2, 33, 7, 9), 3, torch.float32, True).vec == 1
    assert kg.group_norm_plan((2, 33, 7, 9), 3, torch.float32, False).vec == 1
    # unaligned tensors: element accesses
    assert kg.group_norm_plan((2, 640, 32, 32), 32, torch.bfloat16, True,
                              aligned=False).vec == 1
    # one group of 3.9M elements: the largest cluster, and still read twice
    plan = kg.group_norm_plan((2, 960, 64, 64), 1, torch.bfloat16, True)
    assert plan.cluster == kg.MAX_CLUSTER and not plan.keep
    # 512K elements in one group: an eighth of them fits a block's shared
    # memory in bf16 (128 KB) and not in fp32 (256 KB)
    big = (1, 32, 128, 128)
    assert tuple(kg.group_norm_plan(big, 1, torch.bfloat16, True)) == (8, 8, 2048, True)
    assert tuple(kg.group_norm_plan(big, 1, torch.float32, True)) == (4, 8, 2048, False)


# ---------------------------------------------------------------- LayerNorm

LN = chip_smoke.layer_norm_shapes(CFG)
BF16, FP32 = torch.bfloat16, torch.float32


def _check_layer_norm_plan(plan, rows, c, dtype, wdtype):
    """What csrc/layernorm.cu's entry demands of a plan, and that the launch
    covers the tensor."""
    assert plan.vec in (1, 2, 4, 8) and plan.vec * dtype.itemsize <= 16
    assert c % plan.vec == 0                       # vectors divide the row
    nvec, tpr = c // plan.vec, plan.threads_per_row
    assert (tpr <= 32 and tpr & (tpr - 1) == 0) or tpr % 32 == 0
    threads = tpr * plan.rows_par
    assert threads % 32 == 0 and 32 <= threads <= kl.MAX_THREADS
    assert 0 <= plan.vectors <= kl.MAX_VECTORS == 3
    if plan.vectors:                               # threads cover the row
        assert plan.vectors * tpr >= nvec > (plan.vectors - 1) * tpr
    assert plan.rows_block % plan.rows_par == 0    # whole rounds
    blocks = -(-rows // plan.rows_block)
    assert blocks * plan.rows_block >= rows        # blocks cover the rows
    return blocks


def test_the_six_gated_layer_norm_shapes():
    assert LN == [(2, 4096, 320), (2, 1024, 640), (2, 256, 1280),
                  (2, 16384, 320), (2, 4096, 640), (2, 1024, 1280)]


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("dtype,wdtype", [(BF16, BF16), (FP32, FP32), (BF16, FP32)],
                         ids=["bf16", "fp32", "bf16-fp32"])
@pytest.mark.parametrize("shape", LN, ids=["x".join(map(str, s)) for s in LN])
def test_main_path_layer_norm_plans(shape, dtype, wdtype, aligned):
    rows, c = shape[0] * shape[1], shape[2]
    plan = kl.layer_norm_plan(rows, c, dtype, wdtype, aligned)
    blocks = _check_layer_norm_plan(plan, rows, c, dtype, wdtype)
    assert plan.vec == ((8 if dtype == BF16 else 4) if aligned else 1)
    assert plan.vectors, "a UNet row is held in registers"
    # every SM has work wherever the rows allow, and a block takes a second
    # round of rows only when the launch is beyond two blocks an SM
    assert blocks >= min(kl.SM_COUNT, -(-rows // plan.rows_par)) - 4
    if plan.rows_block > plan.rows_par:
        assert blocks <= kl.BLOCKS_BEFORE_LOOP < 2 * blocks


@pytest.mark.parametrize("shape,want", [
    ((2, 4096, 320), (8, 16, 3, 16, 32)),    # 40 vectors: 16 threads hold 3, two rounds
    ((2, 1024, 640), (8, 32, 3, 8, 8)),      # 80 vectors: one warp a row
    ((2, 256, 1280), (8, 64, 3, 4, 4)),      # 160 vectors: two warps a row
    ((2, 16384, 320), (8, 16, 3, 16, 128)),
    ((2, 4096, 640), (8, 32, 3, 8, 32)),
    ((2, 1024, 1280), (8, 64, 3, 4, 8)),
])
def test_plans_of_named_layer_norm_shapes(shape, want):
    plan = kl.layer_norm_plan(shape[0] * shape[1], shape[2], BF16, BF16)
    assert tuple(plan) == want
    assert str(plan).startswith("vec 8 threads/row ")


@pytest.mark.parametrize("rows,c,dtype,vec,held", [
    (231, 768, BF16, 8, True),      # the CLIP tower's rows
    (35, 333, FP32, 1, True),       # no vector divides C
    (35, 333, BF16, 1, True),
    (18, 40, BF16, 8, True),        # 5 vectors: part of a warp
    (7, 5, FP32, 1, True),
    (3, 1, FP32, 1, True),          # one element a row
    (64, 2052, BF16, 4, True),      # 513 vectors of 8 bytes
    (10, 8200, FP32, 4, False),     # 2050 vectors: beyond 512 threads x 3, read twice
    (10, 40000, BF16, 8, False),
])
def test_ragged_layer_norm_plans(rows, c, dtype, vec, held):
    plan = kl.layer_norm_plan(rows, c, dtype, dtype)
    _check_layer_norm_plan(plan, rows, c, dtype, dtype)
    assert plan.vec == vec and bool(plan.vectors) == held
    forced = kl.layer_norm_plan(rows, c, dtype, dtype, aligned=False)
    _check_layer_norm_plan(forced, rows, c, dtype, dtype)
    assert forced.vec == 1


def test_forced_layer_norm_plans_stay_legal():
    for tpr in kl.row_threads(160):
        if -(-160 // tpr) > kl.MAX_VECTORS:
            continue
        for threads in (128, 256, 512):
            if tpr > threads:
                continue
            for loop in (1, 2, 4):
                plan = kl.layer_norm_plan(512, 1280, BF16, BF16, True, tpr, threads, loop)
                _check_layer_norm_plan(plan, 512, 1280, BF16, BF16)
                assert plan.threads_per_row == tpr
                assert plan.rows_block == loop * plan.rows_par
    assert kl.row_threads(160)[-1] == 288 and kl.row_threads(1) == [1]
    # what the C entry refuses never comes out of the plan function: a row
    # shared by 24 threads, or by so few that they cannot hold it
    assert 24 not in kl.row_threads(160)
    assert kl.layer_norm_plan(512, 1280, BF16, BF16, threads_per_row=8).vectors == 0


# ------------------------------------------------------- GroupNorm apply pass

APPLY = [(shape, dtype, cl) for shape in chip_smoke.APPLY_SHAPES
         for dtype in (BF16, FP32) for cl in (True, False)]


def _check_apply_plan(plan, shape, groups, dtype, channels_last, rows):
    n, c, h, w = shape
    hw = h * w
    assert plan.vec in (1, 2, 4, 8) and plan.vec * dtype.itemsize <= 16
    if not plan.by_rows:  # the (sample, group, chunk) kernel: the stats kernel's rule
        assert plan.threads == kg.CHUNK_THREADS and plan.tile_rows == rows
        assert plan.vec == kg.access_width(shape, groups, dtype.itemsize, channels_last, rows)
        return
    assert channels_last
    assert c % plan.vec == 0                          # a vector stays inside a row
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= kg.ROWS_MAX_THREADS
    assert 1 <= plan.tile_rows <= hw
    tiles = -(-hw // plan.tile_rows)
    assert tiles * plan.tile_rows >= hw and tiles * n >= 1   # tiles cover every row


@pytest.mark.parametrize("shape,dtype,channels_last", APPLY,
                         ids=[f"{s[1]}x{s[2]}-{str(d)[6:]}-{'cl' if cl else 'nchw'}"
                              for s, d, cl in APPLY])
def test_apply_plans_of_the_large_slabs(shape, dtype, channels_last):
    rows = max(1, 16384 // (shape[1] // 32))
    plan = kg.apply_plan(shape, 32, dtype, channels_last, rows)
    _check_apply_plan(plan, shape, 32, dtype, channels_last, rows)
    assert plan.by_rows == channels_last
    if channels_last:
        n, c, h, w = shape
        assert plan.vec * dtype.itemsize == 16
        assert plan.threads % (c // plan.vec) == 0   # a thread's column is fixed
        blocks = n * -(-(h * w) // plan.tile_rows)
        assert kg.SM_COUNT <= blocks <= 4 * kg.SM_COUNT
        # a thread gets whole batches of accesses
        assert plan.tile_rows * (c // plan.vec) % (plan.threads * kg.APPLY_BATCH) == 0


@pytest.mark.parametrize("shape,dtype,want", [
    ((1, 128, 512, 512), BF16, (True, 8, 256, 1024)),
    ((1, 128, 512, 512), FP32, (True, 4, 256, 1024)),
    ((2, 960, 64, 64), BF16, (True, 8, 480, 32)),
    ((2, 960, 64, 64), FP32, (True, 4, 480, 32)),
])
def test_plans_of_named_apply_shapes(shape, dtype, want):
    plan = kg.apply_plan(shape, 32, dtype, True, 4096)
    assert tuple(plan) == want
    assert str(plan).startswith("rows x channels vec ")
    assert str(kg.apply_plan(shape, 32, dtype, False, 4096)).startswith("group x chunk vec ")


def test_ragged_apply_plans():
    # 33 channels: no block of at most 512 threads is whole rows of 33
    # element accesses and whole warps, so the column moves
    plan = kg.apply_plan((2, 33, 7, 9), 3, FP32, True, 21)
    _check_apply_plan(plan, (2, 33, 7, 9), 3, FP32, True, 21)
    assert plan.vec == 1 and plan.threads % 33 != 0 and plan.tile_rows <= 63
    # 96 channels in bf16: 12 vectors a row, a block of 288 threads
    plan = kg.apply_plan((1, 96, 24, 40), 8, BF16, True, 100)
    _check_apply_plan(plan, (1, 96, 24, 40), 8, BF16, True, 100)
    assert (plan.vec, plan.threads) == (8, 288)
    # unaligned tensors: element accesses
    assert kg.apply_plan((2, 960, 64, 64), 32, BF16, True, 546, aligned=False).vec == 1
    # a row of more vectors than a block has threads
    plan = kg.apply_plan((1, 8200, 16, 16), 8, FP32, True, 64)
    _check_apply_plan(plan, (1, 8200, 16, 16), 8, FP32, True, 64)
    assert plan.threads == kg.CHUNK_THREADS and plan.tile_rows >= 1
    # the present kernel stays reachable in channels-last memory, and the new
    # one is refused for NCHW memory
    old = kg.apply_plan((2, 960, 64, 64), 32, BF16, True, 546, by_rows=False)
    assert tuple(old) == (False, 2, kg.CHUNK_THREADS, 546)
    with pytest.raises(ValueError, match="channels-last"):
        kg.apply_plan((2, 960, 64, 64), 32, BF16, False, 546, by_rows=True)


# ------------------------------------------------------- GroupNorm stats pass


def _check_stats_plan(plan, shape, groups, dtype, channels_last, rows):
    n, c, h, w = shape
    assert plan.vec in (1, 2, 4, 8) and plan.vec * dtype.itemsize <= 16
    if not plan.by_rows:  # the (sample, group, chunk) kernel
        assert plan.threads == kg.CHUNK_THREADS and plan.cluster == 1
        assert plan.vec == kg.access_width(shape, groups, dtype.itemsize, channels_last, rows)
        return
    assert channels_last
    assert c % plan.vec == 0                          # a vector stays inside a row
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= kg.ROWS_MAX_THREADS
    assert plan.threads % (c // plan.vec) == 0        # a thread's column is fixed
    assert plan.cluster in (1, 2, 4)
    # the column sums, channel sums and group sums fit a block's shared memory
    assert (plan.threads * plan.vec + c + groups) * 8 <= kg.STATS_SMEM_BYTES


@pytest.mark.parametrize("shape,dtype,channels_last", APPLY,
                         ids=[f"{s[1]}x{s[2]}-{str(d)[6:]}-{'cl' if cl else 'nchw'}"
                              for s, d, cl in APPLY])
def test_stats_plans_of_the_large_slabs(shape, dtype, channels_last):
    rows = max(1, 16384 // (shape[1] // 32))
    plan = kg.stats_plan(shape, 32, dtype, channels_last, rows)
    _check_stats_plan(plan, shape, 32, dtype, channels_last, rows)
    n, c, h, w = shape
    # by rows where a group's run is narrower than a sector (C = 128: 8 or 16
    # bytes; C = 960: 60 or 120)
    assert plan.by_rows == (channels_last and c // 32 * dtype.itemsize < 32)
    forced = kg.stats_plan(shape, 32, dtype, True, rows, by_rows=True)
    _check_stats_plan(forced, shape, 32, dtype, True, rows)
    assert forced.vec * dtype.itemsize == 16
    chunks = -(-(h * w) // rows)
    assert n * chunks < kg.SM_COUNT          # one block a chunk would not fill the card
    assert kg.SM_COUNT // 4 < n * chunks * forced.cluster <= kg.SM_COUNT
    # every thread of every block has its least batches of accesses
    share = -(-min(rows, h * w) // forced.cluster)
    assert share * (c // forced.vec) >= kg.STATS_MIN_BATCHES * forced.threads * kg.STATS_BATCH


@pytest.mark.parametrize("shape,dtype,want", [
    ((1, 128, 512, 512), BF16, (True, 8, 512, 2)),
    ((1, 128, 512, 512), FP32, (True, 4, 512, 2)),
    ((2, 960, 64, 64), BF16, (True, 8, 480, 4)),
    ((2, 960, 64, 64), FP32, (True, 4, 480, 4)),
])
def test_plans_of_named_stats_shapes(shape, dtype, want):
    rows = max(1, 16384 // (shape[1] // 32))
    plan = kg.stats_plan(shape, 32, dtype, True, rows, by_rows=True)
    assert tuple(plan) == want
    assert str(plan).startswith("rows x channels vec ")
    old = kg.stats_plan(shape, 32, dtype, True, rows, by_rows=False)
    assert str(old).startswith("group x chunk vec ")
    assert kg.stats_plan(shape, 32, dtype, True, rows) == (plan if shape[1] == 128 else old)
    assert kg.stats_plan(shape, 32, dtype, False, rows) == old._replace(
        vec=kg.access_width(shape, 32, dtype.itemsize, False, rows))


def test_ragged_stats_plans():
    # 33 channels: no block of at most 512 threads is whole rows of 33 element
    # accesses and whole warps: the (sample, group, chunk) kernel stays
    plan = kg.stats_plan((2, 33, 7, 9), 3, FP32, True, 21)
    _check_stats_plan(plan, (2, 33, 7, 9), 3, FP32, True, 21)
    assert not plan.by_rows and plan.vec == 1
    with pytest.raises(ValueError, match="whole rows"):
        kg.stats_plan((2, 33, 7, 9), 3, FP32, True, 21, by_rows=True)
    # 96 channels in bf16: 12 vectors a row, the widest block of whole rows
    # and warps has 480 threads; 960 rows in 10 chunks of 100 do not give two
    # blocks their batches: one block a chunk
    plan = kg.stats_plan((1, 96, 24, 40), 8, BF16, True, 100)
    _check_stats_plan(plan, (1, 96, 24, 40), 8, BF16, True, 100)
    assert tuple(plan) == (True, 8, 480, 1)
    # enough (sample, chunk) pairs for an SM each: no cluster
    assert kg.stats_plan((2, 128, 512, 512), 32, BF16, True, 4096).cluster == 1
    assert kg.stats_plan((1, 128, 256, 256), 32, BF16, True, 4096).cluster == 4
    # unaligned tensors: element accesses, a row of 960 is wider than a block
    plan = kg.stats_plan((2, 960, 64, 64), 32, BF16, True, 546, aligned=False)
    assert not plan.by_rows and plan.vec == 1
    # a row whose sums do not fit shared memory
    assert not kg.stats_plan((1, 4096, 16, 16), 8, FP32, True, 64).by_rows
    # NCHW memory keeps the (sample, group, chunk) kernel; it stays reachable
    # in channels-last memory, and the new one is refused for NCHW memory
    assert tuple(kg.stats_plan((2, 960, 64, 64), 32, BF16, False, 546)) == \
        (False, 2, kg.CHUNK_THREADS, 1)
    old = kg.stats_plan((2, 960, 64, 64), 32, BF16, True, 546, by_rows=False)
    assert tuple(old) == (False, 2, kg.CHUNK_THREADS, 1)
    with pytest.raises(ValueError, match="channels-last"):
        kg.stats_plan((2, 960, 64, 64), 32, BF16, False, 546, by_rows=True)
    # a forced cluster size is taken as it is
    for cluster in (1, 2, 4, 8):
        assert kg.stats_plan((2, 960, 64, 64), 32, BF16, True, 546, by_rows=True,
                             cluster=cluster).cluster == cluster


# -------------------------------------------------------------- the build


def test_editing_a_shared_header_changes_the_library_path(tmp_path, monkeypatch):
    """The headers under csrc/ are hashed with a library's sources, and are
    not handed to nvcc as inputs."""
    for name in ("quant.cu", "hopper.cuh"):
        shutil.copy(build.CSRC / name, tmp_path / name)
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    before = build.library_path("quant", kq.SOURCES)
    assert before == build.library_path("quant", kq.SOURCES)
    with open(tmp_path / "hopper.cuh", "a") as f:
        f.write("// edited\n")
    after = build.library_path("quant", kq.SOURCES)
    assert after != before and after.parent == tmp_path / "build"
    with open(tmp_path / "quant.cu", "a") as f:
        f.write("// edited\n")
    assert build.library_path("quant", kq.SOURCES) != after
    assert all(src.endswith(".cu") for src in kq.SOURCES + kg.SOURCES)
    assert (build.CSRC / "hopper.cuh").exists()


def test_the_first_build_builds_the_registered_libraries_together(monkeypatch):
    """Attention, GroupNorm and LayerNorm are registered: the first library a
    process asks for is built and loaded together with every one of them
    (one call of load_libraries, its nvcc runs started together); a loaded
    library returns at once."""
    asked = []

    def load_libraries(specs):
        asked.append(dict(specs))
        return {name: f"lib{name}" for name in specs}

    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "load_libraries", load_libraries)
    assert build.load_library("quant", kq.SOURCES) == "libquant"
    assert asked == [{"attention": ("attention.cu",), "groupnorm": kg.SOURCES,
                      "layernorm": ("layernorm.cu",), "quant": kq.SOURCES}]
    build._LIBS["groupnorm"] = "loaded"
    assert build.load_library("groupnorm", kg.SOURCES) == "loaded" and len(asked) == 1
