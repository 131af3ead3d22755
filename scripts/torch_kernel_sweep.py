"""Sweep the launch plans of the PyTorch port's int8 matmul, one-pass
GroupNorm, LayerNorm and GroupNorm apply and stats kernels on one NVIDIA card.

    python3 scripts/torch_kernel_sweep.py [quant] [gn] [ln] [apply] [stats] [--root DIR]

--root DIR takes the package (not this script, nor chip_smoke.py) from
another checkout, to time an earlier tree's kernels at the same shapes in
the same call; a LayerNorm or GroupNorm stats kernel that takes no plan is
timed as it is.

For every gated GEMM of a 512x512 SD-1.5 step: each tile (x rows by weight
rows) and K split of the wgmma variant forced once, and the mma.sync
variant, held against the plain version (bf16 tolerances of chip_smoke.py),
run twice for equal bytes, and timed on the device; beside them bf16
F.linear and dequantise + F.linear. For every gated one-pass GroupNorm site
(bf16, channels-last): each cluster size forced once, checked the same way
and timed, beside F.group_norm (+ F.silu). The plan that
`matmul_plan` / `group_norm_plan` picks is marked with a star. One line per
shape. For every gated LayerNorm shape of the 512x512 request and the
1024x1024 hires pass (bf16): every count of threads a row that holds the row
in registers, at blocks of 128, 256 and 512 threads taking 1 to 16 rounds of
rows, and the read-twice walk, checked the same way; the ten
fastest and the plan `layer_norm_plan` picks, beside F.layer_norm. For the
two-pass GroupNorm's apply pass at two large channels-last slabs, bf16 and
fp32: the rows x channels kernel at each block width of whole rows and tiles
for 1 to 8 blocks an SM, and the (sample, group, chunk) kernel, checked
for equal bytes among themselves. For the stats pass at the same slabs: the
rows x channels kernel at each block width of whole rows and each cluster
size (blocks that share a (sample, chunk), adding over distributed shared
memory), the (sample, group, chunk) kernel, and, as a floor for the other way
to fill the card (several blocks a chunk, then a second, ordered add in
another launch), one block for each cluster-sized share of a chunk without any
add; each held to 1e-5 x max |plain| and run twice for equal bytes. The
card's name and power limit come last. The plan rules in
ops/kernels/{quant,groupnorm,layernorm}.py were set from this output (PERF.md).
"""

import os
import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import chip_smoke  # noqa: E402
if "--root" in sys.argv:  # the package of another checkout
    sys.path.insert(0, os.path.abspath(sys.argv.pop(sys.argv.index("--root") + 1)))
    sys.argv.remove("--root")
from stablediffusioneo_tpu_torch.config import sd15_pipeline  # noqa: E402
from stablediffusioneo_tpu_torch.ops.kernels import groupnorm as kg  # noqa: E402
from stablediffusioneo_tpu_torch.ops.kernels import layernorm as kl  # noqa: E402
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


def sweep_layer_norm(cfg, gen):
    for shape in chip_smoke.layer_norm_shapes(cfg):
        x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        c, rows = shape[-1], x.numel() // shape[-1]
        w = (torch.randn(c, generator=gen, device="cuda") * 0.1 + 1).to(torch.bfloat16)
        b = (torch.randn(c, generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
        ref = kl.fused_layer_norm_plain(x, w, b, 1e-5)
        library = chip_smoke.device_ms(lambda: F.layer_norm(x, (c,), w, b, 1e-5))
        if not hasattr(kl, "layer_norm_plan"):  # an earlier tree's kernel: one layout
            if not agrees(kl.fused_layer_norm(x, w, b, 1e-5), ref):
                raise AssertionError(f"{shape} disagrees with the plain version")
            ms = chip_smoke.device_ms(lambda: kl.fused_layer_norm(x, w, b, 1e-5))
            print(f"fused_layer_norm {shape} us (no plans): {ms * 1e3:.2f} | F.layer_norm "
                  f"{library * 1e3:.2f}", flush=True)
            continue
        auto = kl.layer_norm_plan(rows, c, x.dtype, w.dtype)
        nvec = c // auto.vec
        plans = {kl.layer_norm_plan(rows, c, x.dtype, w.dtype, True, tpr, threads, loop)
                 for tpr in kl.row_threads(nvec) if -(-nvec // tpr) <= kl.MAX_VECTORS
                 for threads in (128, 256, 512) if tpr <= threads
                 for loop in (1, 2, 4, 8, 16)}
        plans |= {auto, kl.layer_norm_plan(rows, c, x.dtype, w.dtype, True, 32)._replace(vectors=0)}
        timed = []
        for plan in sorted(plans):
            out = kl.fused_layer_norm(x, w, b, 1e-5, plan=plan)
            if not (agrees(out, ref)
                    and torch.equal(out, kl.fused_layer_norm(x, w, b, 1e-5, plan=plan))):
                raise AssertionError(f"{shape} {plan} disagrees or differs between runs")
            timed.append((chip_smoke.device_ms(
                lambda: kl.fused_layer_norm(x, w, b, 1e-5, plan=plan)), plan))
        timed.sort()
        twice = next(ms for ms, plan in timed if not plan.vectors)
        shown = timed[:10] + [(ms, plan) for ms, plan in timed[10:] if plan == auto]
        cells = [f"{'*' if plan == auto else ''}{plan.threads_per_row}x{plan.rows_par}"
                 f"/{plan.rows_block // plan.rows_par} {ms * 1e3:.2f}" for ms, plan in shown]
        print(f"fused_layer_norm {shape} vec {auto.vec} us (threads a row x rows side by "
              f"side / rounds), {len(timed)} plans: {'; '.join(cells)}; slowest "
              f"{timed[-1][0] * 1e3:.2f}; read twice {twice * 1e3:.2f} | F.layer_norm "
              f"{library * 1e3:.2f}", flush=True)


def sweep_apply(gen):
    for shape in chip_smoke.APPLY_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            x = x.contiguous(memory_format=torch.channels_last)
            c, hw = shape[1], shape[2] * shape[3]
            w = (torch.randn(c, generator=gen, device="cuda") * 0.1 + 1).to(dtype)
            b = (torch.randn(c, generator=gen, device="cuda") * 0.1).to(dtype)
            rows = kg.chunk_rows(x, 32)
            parts = kg.group_norm_stats(x, 32, rows)
            auto = kg.apply_plan(shape, 32, dtype, True, rows)
            old = kg.apply_plan(shape, 32, dtype, True, rows, by_rows=False)
            rv = c // auto.vec
            widths = sorted({t for t in range(rv, kg.ROWS_MAX_THREADS + 1, rv)
                             if t % 32 == 0} | {auto.threads, 256})
            plans = {auto, old}
            for threads in widths:
                batch_rows = -(-threads * kg.APPLY_BATCH // rv)
                for per_sm in (1, 2, 3, 4, 8):
                    tile = -(-hw // (per_sm * kg.SM_COUNT))
                    tile = max(batch_rows, -(-tile // batch_rows) * batch_rows)
                    plans.add(kg.ApplyPlan(True, auto.vec, threads, min(tile, hw)))
            ref = kg.group_norm_apply(x, parts, w, b, rows, 1e-6, True, plan=old)
            if not agrees(ref, kg.group_norm_apply_plain(x, parts, w, b, 1e-6, True)):
                raise AssertionError(f"{shape} {old} disagrees with the plain version")
            cells = []
            for plan in sorted(plans):
                out = kg.group_norm_apply(x, parts, w, b, rows, 1e-6, True, plan=plan)
                if not torch.equal(out, ref):
                    raise AssertionError(f"{shape} {plan}: bytes differ from {old}")
                del out
                ms = chip_smoke.device_ms(
                    lambda: kg.group_norm_apply(x, parts, w, b, rows, 1e-6, True, plan=plan))
                name = (f"{plan.threads}t/{plan.tile_rows}r" if plan.by_rows
                        else "group x chunk")
                cells.append(f"{'*' if plan == auto else ''}{name} {ms * 1e3:.1f}")
            plain_norm = chip_smoke.device_ms(  # what the SiLU's exp and division cost
                lambda: kg.group_norm_apply(x, parts, w, b, rows, 1e-6, False))
            print(f"group_norm_apply {shape} {dtype} vec {auto.vec} us (threads / tile "
                  f"rows): {'; '.join(cells)} | * without SiLU {plain_norm * 1e3:.1f}",
                  flush=True)
            del x, parts, ref
            torch.cuda.empty_cache()


def sweep_stats(gen):
    for shape in chip_smoke.APPLY_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            x = x.contiguous(memory_format=torch.channels_last)
            c, hw = shape[1], shape[2] * shape[3]
            rows = kg.chunk_rows(x, 32)
            ref = kg.group_norm_stats_plain(x, 32, rows)
            tol = chip_smoke.STATS_TOL * ref.abs().max().item()
            bound = x.numel() * x.element_size() / chip_smoke.PEAK_BYTES * 1e6
            if not hasattr(kg, "stats_plan"):  # an earlier tree's kernel: one layout
                if (kg.group_norm_stats(x, 32, rows) - ref).abs().max().item() > tol:
                    raise AssertionError(f"{shape} disagrees with the plain version")
                ms = chip_smoke.device_ms(lambda: kg.group_norm_stats(x, 32, rows))
                print(f"group_norm_stats {shape} {dtype} us (no plans): {ms * 1e3:.1f} | "
                      f"bound {bound:.1f}", flush=True)
                continue
            auto = kg.stats_plan(shape, 32, dtype, True, rows)
            by_rows = kg.stats_plan(shape, 32, dtype, True, rows, by_rows=True)
            rv = c // by_rows.vec
            widths = sorted({t for t in range(rv, kg.ROWS_MAX_THREADS + 1, rv)
                             if t % 32 == 0 and (t * by_rows.vec + c + 32) * 8
                             <= kg.STATS_SMEM_BYTES} | {by_rows.threads})
            widths = [t for t in widths if t >= 128]
            plans = [kg.stats_plan(shape, 32, dtype, True, rows, by_rows=False)]
            plans += [kg.StatsPlan(True, by_rows.vec, threads, cluster)
                      for threads in widths for cluster in (1, 2, 4, 8)]
            cells = []
            for plan in plans:
                out = kg.group_norm_stats(x, 32, rows, plan=plan)
                if (out - ref).abs().max().item() > tol or not torch.equal(
                        out, kg.group_norm_stats(x, 32, rows, plan=plan)):
                    raise AssertionError(f"{shape} {plan} disagrees or differs between runs")
                ms = chip_smoke.device_ms(
                    lambda: kg.group_norm_stats(x, 32, rows, plan=plan))
                name = (f"{plan.threads}t/c{plan.cluster}" if plan.by_rows
                        else "group x chunk")
                cells.append(f"{'*' if plan == auto else ''}{name} {ms * 1e3:.1f}")
            shares = []  # one block a share of a chunk, no add across them
            for cluster in (2, 4, 8):
                share = -(-min(rows, hw) // cluster)
                plan = by_rows._replace(cluster=1)
                ms = chip_smoke.device_ms(
                    lambda: kg.group_norm_stats(x, 32, share, plan=plan))
                shares.append(f"1/{cluster} chunk {ms * 1e3:.1f}")
            print(f"group_norm_stats {shape} {dtype} vec {by_rows.vec} us (threads / "
                  f"cluster): {'; '.join(cells)} | no add: {'; '.join(shares)} | "
                  f"bound {bound:.1f}", flush=True)
            del x, ref
            torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_kernel_sweep: no CUDA device; this script runs on the card only")
    what = sys.argv[1:] or ["quant", "gn", "ln", "apply", "stats"]
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = sd15_pipeline(dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "quant" in what:
        sweep_quant(cfg, gen)
    if "gn" in what:
        sweep_group_norm(cfg, gen)
    if "ln" in what:
        sweep_layer_norm(cfg, gen)
    if "apply" in what:
        sweep_apply(gen)
    if "stats" in what:
        sweep_stats(gen)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
