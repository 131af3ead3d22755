"""The launch plans of the int8 matmul and the one-pass GroupNorm kernels.

Which variant, tile, K split, access width and cluster size a call runs is a
pure function of its arguments (`ops/kernels/quant.py:matmul_plan`,
`ops/kernels/groupnorm.py:group_norm_plan`), chosen in Python and passed to
the C entry. Held here, on the CPU, over every main-path shape of the SD-1.5
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
