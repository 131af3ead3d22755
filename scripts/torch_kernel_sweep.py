"""Sweep the launch plans of the PyTorch port's int8 matmul and one-pass
GroupNorm kernels on one NVIDIA card.

    python3 scripts/torch_kernel_sweep.py [quant] [gn]

For every gated GEMM of a 512x512 SD-1.5 step: each tile (x rows by weight
rows) and K split of the wgmma variant forced once, and the mma.sync
variant, held against the plain version (bf16 tolerances of chip_smoke.py),
run twice for equal bytes, and timed on the device; beside them bf16
F.linear and dequantise + F.linear. For every gated one-pass GroupNorm site
(bf16, channels-last): each cluster size forced once, checked the same way
and timed, beside F.group_norm (+ F.silu). The plan that
`matmul_plan` / `group_norm_plan` picks is marked with a star. One line per
shape; the card's name and power limit come last. The plan rules in
ops/kernels/{quant,groupnorm}.py were set from this output (PERF.md).
"""

import os
import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import chip_smoke  # noqa: E402
from stablediffusioneo_tpu_torch.config import sd15_pipeline  # noqa: E402
from stablediffusioneo_tpu_torch.ops.kernels import groupnorm as kg  # noqa: E402
from stablediffusioneo_tpu_torch.ops.kernels import quant as kq  # noqa: E402
from stablediffusioneo_tpu_torch.ops.quant import quantize_weights  # noqa: E402

TILES = ((128, 128), (128, 64), (64, 128), (64, 64))
SPLITS = (1, 2, 4, 8)
CLUSTERS = (1, 2, 4, 8)


def agrees(out, ref):
    err = (out.float() - ref.float()).abs()
    return err.max().item() <= chip_smoke.BF16_TOL[0] and err.mean().item() <= chip_smoke.BF16_TOL[1]


def sweep_quant(cfg, gen):
    for m, k, n in sorted(set(chip_smoke.quant_gated(chip_smoke.quant_sites(cfg, chip_smoke.RES)))):
        w = torch.randn((n, k), generator=gen, device="cuda") * (0.5 / k ** 0.5)
        w_q, scale = quantize_weights(w)
        w_bf16 = w.to(torch.bfloat16)
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        ref = kq.quantized_matmul_plain(x, w_q, scale)
        auto = kq.matmul_plan(m, k, n, torch.bfloat16)
        plans = [kq.Plan("wgmma", tm, bn, split, 4) for tm, bn in TILES for split in SPLITS
                 if -(-k // kq.K_SLICE) // split >= 2]
        cells = []
        for plan in plans + [kq.Plan("mma_sync", 128, 128, 1, 1)]:
            out = kq._launch(x, w_q, scale, plan)
            if not (agrees(out, ref) and torch.equal(out, kq._launch(x, w_q, scale, plan))):
                raise AssertionError(f"{(m, k, n)} {plan} disagrees or differs between runs")
            ms = chip_smoke.device_ms(lambda: kq._launch(x, w_q, scale, plan))
            cells.append(f"{'*' if plan == auto else ''}{plan.variant} {plan.tm}x{plan.bn}/"
                         f"{plan.split} {ms * 1e3:.1f}")
        linear = chip_smoke.device_ms(lambda: F.linear(x, w_bf16))
        dequant = chip_smoke.device_ms(
            lambda: F.linear(x, (w_q.float() * scale[:, None]).to(x.dtype)))
        print(f"quantized_matmul {(m, k, n)} us (variant tile/split): {'; '.join(cells)} | "
              f"bf16 F.linear {linear * 1e3:.1f}, dequantise + F.linear {dequant * 1e3:.1f}",
              flush=True)


def sweep_group_norm(cfg, gen):
    sites = sorted({(shape, swish, groups)
                    for kind, shape, swish, groups in chip_smoke.norm_sites(cfg, chip_smoke.RES)["step"]
                    if kind == "gn" and chip_smoke.gated((kind, shape, swish, groups),
                                                         torch.bfloat16)})
    for shape, swish, groups in sites:
        x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        x = x.contiguous(memory_format=torch.channels_last)
        w = (torch.randn(shape[1], generator=gen, device="cuda") * 0.1 + 1).to(torch.bfloat16)
        b = (torch.randn(shape[1], generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
        eps = 1e-5 if swish else 1e-6
        ref = kg.fused_group_norm_plain(x, w, b, groups, eps, swish)
        auto = kg.group_norm_plan(shape, groups, x.dtype, True)
        cells = []
        for cluster in CLUSTERS:
            plan = kg.group_norm_plan(shape, groups, x.dtype, True, cluster=cluster)
            out = kg.fused_group_norm(x, w, b, groups, eps, swish, plan=plan)
            if not (agrees(out, ref) and torch.equal(
                    out, kg.fused_group_norm(x, w, b, groups, eps, swish, plan=plan))):
                raise AssertionError(f"{shape} {plan} disagrees or differs between runs")
            ms = chip_smoke.device_ms(
                lambda: kg.fused_group_norm(x, w, b, groups, eps, swish, plan=plan))
            cells.append(f"{'*' if plan == auto else ''}cluster {cluster} {ms * 1e3:.1f}")
        library = chip_smoke.device_ms(
            lambda: F.silu(F.group_norm(x, groups, w, b, eps)) if swish
            else F.group_norm(x, groups, w, b, eps))
        print(f"fused_group_norm {shape} swish {swish} vec {auto.vec} us: {'; '.join(cells)} | "
              f"F.group_norm{' + F.silu' if swish else ''} {library * 1e3:.1f}", flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_kernel_sweep: no CUDA device; this script runs on the card only")
    what = sys.argv[1:] or ["quant", "gn"]
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = sd15_pipeline(dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "quant" in what:
        sweep_quant(cfg, gen)
    if "gn" in what:
        sweep_group_norm(cfg, gen)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
