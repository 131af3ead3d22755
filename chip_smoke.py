"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in the checkout (one nvcc per
source, all started together), then:
  1. kernel phase: each kernel entry against its plain PyTorch version at
     every shape the main paths give it (packed attention at the 512x512
     and 1024x1024 sites, streaming attention at the hires pass's
     (2, 16384, 320) self-attention, split attention at both VAE
     mid-blocks; the one-pass GroupNorm at every gated GroupNorm site, in
     the channels-last memory the networks hold; LayerNorm at the gated
     transformer sites; the int8 matmul at every gated 512x512 GEMM) and
     the two-pass GroupNorm pair at two large slabs, in bf16 and fp32, with
     both timed on the device (torch.profiler's kernel durations over 20
     calls) and eagerly (CUDA events around one call, host launch cost
     included); beside them the row's bound (the least time the card could
     take: see `bound_ms`) and, where one PyTorch call computes the same
     function, that call's device time as a yardstick (library_ms:
     scaled_dot_product_attention, F.group_norm (+ F.silu), F.layer_norm;
     the port itself never calls them); each attention row also names the
     variant of csrc/attention.cu it ran, each int8 matmul and one-pass
     GroupNorm row the plan it ran (variant, tile, K split; access width,
     cluster size), and a bf16 attention or int8 matmul row on another
     variant than the tensor-core one fails the run; the int8 matmul also
     against the flag-off path (dequantise, then cuBLAS) and the
     unquantised bf16 F.linear;
  2. reference phase: one full-width controlled-UNet evaluation at 256x256
     in fp32 on the card (through the kernels) against the same weights on
     the CPU (plain versions), TF32 off; by default, with the fused-norm
     configuration (set_kernels(groupnorm=True, layernorm=True)), and with
     int8 linears (quantised once, the bytes shared by card and CPU) and
     set_kernels(int8_linear=True);
  3. main paths: Canny2ImagePipeline.process at the full SD-1.5 widths in
     bf16, weights drawn from a fixed seed: one warm-up request, then two
     timed requests (20 DDIM steps, scale 9, eta 0, batch 1), counting the
     kernel launches of those two requests; 512x512 by default, with the
     fused-norm configuration, and with int8 linears (quantize_linears=True,
     set_kernels(int8_linear=True)); then the hires fix 512 -> 1024
     (hires_upscale=2.0, hires_denoise=0.7: the last 14 of 20 steps again
     at 1024x1024). Every run adds one traced request (torch.profiler) for
     the device time per request and the part of it spent in this package's
     attention, GroupNorm and int8 matmul kernels.
Launch counts must equal what the UNet, ControlNet, VAE and CLIP plans and
the dispatch gates imply. Any failed check raises, so the script exits
non-zero and prints no result. The last line is {"ok": true, "device":
{...}}; the line before it names the card and its power limit, the one
before that lists the kernels.
"""

import copy
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import zlib

import numpy as np
import torch
import torch.nn.functional as F

CSRC = "stablediffusioneo_tpu_torch/csrc"
PALLAS = "stablediffusioneo_tpu/ops/pallas"
# kernel entry -> (CUDA source, Pallas kernel it replaces as file:line)
KERNELS = {
    "fused_attention_packed": ("attention.cu", "attention.py:125"),
    "fused_attention": ("attention.cu", "attention.py:106"),
    "fused_attention_packed_stream": ("attention.cu", "attention.py:150"),
    "fused_group_norm": ("groupnorm.cu", "groupnorm.py:127"),
    "group_norm_stats": ("groupnorm.cu", "groupnorm.py:173"),
    "group_norm_apply": ("groupnorm.cu", "groupnorm.py:179"),
    "fused_layer_norm": ("layernorm.cu", "layernorm.py:89"),
    "quantized_matmul": ("quant.cu", "quant.py:109"),
}
# the main-path run whose launches the kernels line reports for each kernel
EXERCISED_BY = {"fused_attention_packed": "default", "fused_attention": "default",
                "fused_attention_packed_stream": "hires",
                "quantized_matmul": "int8"}
# Published dense peaks of one H100 SXM, for the bounds: bf16 tensor cores,
# fp32 outside them, device memory; and the special-function units' exp
# rate (16 a clock on each of 132 SMs at the 1.755 GHz boost clock).
PEAK_BF16, PEAK_FP32, PEAK_BYTES = 989e12, 67e12, 3.35e12
PEAK_EXP = 16 * 132 * 1.755e9
NORM_OPS = 8  # fp32 operations per element of a norm: two sums, normalise, affine
BF16_TOL = (2e-2, 2e-3)  # max, mean |d| on standard-normal inputs
FP32_TOL = 1e-4
STATS_TOL = 1e-5  # GroupNorm partial sums, fp32, relative to max |plain|
REF_TOL = 1e-3  # full-width UNet eval, card vs CPU, relative to max |ref|
STEPS, RES, SCALE = 20, 512, 9.0
HIRES_UPSCALE, HIRES_DENOISE = 2.0, 0.7
HIRES_RES = int(round(RES * HIRES_UPSCALE / 64)) * 64
HIRES_T_ENC = max(1, min(STEPS, int(round(HIRES_DENOISE * STEPS))))


def stand_in_tokenizer(texts, max_length=77):
    """Deterministic stand-in for the CLIP BPE tokenizer (its vocabulary is
    not in the repository): BOS 49406, one hashed id below 49406 per word,
    EOS and padding 49407."""
    rows = []
    for t in texts:
        ids = [49406] + [zlib.crc32(w.encode()) % 49406
                         for w in t.replace(",", " ").split()][:max_length - 2]
        rows.append(ids + [49407] * (max_length - len(ids)))
    return np.asarray(rows, np.int64)


def time_ms(fn, warmup=3, reps=20):
    """Eager time of one call, host launch cost included: CUDA events
    around the call, median of reps after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _device_events(fn, attempts=6):
    """The device events of one torch.profiler trace of `fn` (which ends
    synchronised), or None. The profiler now and then returns a trace
    without device events, several times in a row; such a trace is taken
    again after a pause."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if sum(e.device_time for e in events) > 0:
            return events
        time.sleep(0.5 * (attempt + 1))
    return None


def graph_ms(fn, calls=20):
    """Time of one call from CUDA events around a CUDA graph of `calls`
    calls: no host launch cost between the kernels."""
    stream = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with torch.cuda.stream(stream):
        fn()  # warm-up on the capture stream
        stream.synchronize()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(calls):
                fn()
        graph.replay()
        start.record(stream)
        graph.replay()
        end.record(stream)
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def device_ms(fn, calls=20):
    """Device time of one call: the summed durations of the kernels and
    copies that `calls` calls put on the card (torch.profiler), divided by
    calls. Eager timing of a norm of a few microseconds would measure the
    host's launch cost instead. Where the profiler gives no device events at
    all, `graph_ms` times the calls instead, and a line says so."""
    fn()
    torch.cuda.synchronize()

    def many():
        for _ in range(calls):
            fn()

    events = _device_events(many)
    if events is not None:
        return sum(e.device_time for e in events) / 1e3 / calls
    print("device_ms: no device events from the profiler; timing a CUDA graph "
          "of the calls by CUDA events instead", flush=True)
    return graph_ms(fn, calls)


# kernel family -> what its kernels' names hold
FAMILIES = {"attention": "attention_", "group_norm": "gn_", "quantized_matmul": "qmm_"}


def traced_request(fn):
    """Device time of one call of `fn`, ms, the part of it spent in each of
    this package's kernel families, and the count of device operations, from
    one torch.profiler trace; None where the profiler gives no device events."""
    events = _device_events(fn, attempts=3)
    if events is None:
        return None
    total = sum(e.device_time for e in events)
    parts = {family: sum(e.device_time for e in events if mark in e.name) / 1e3
             for family, mark in FAMILIES.items()}
    return total / 1e3, parts, len(events)


# the tensor-core kernels of each library, by what their names hold
TENSOR_CORE_KERNELS = {"attention": ("attention_split512_kernel", "attention_wgmma_kernel"),
                       "quant": ("qmm_wgmma_kernel",)}


def ptxas_report(library, kinds):
    """{kernel kind: (most registers a thread, spill bytes)} of a library's
    tensor-core kernels, from the `ptxas -v` report that the build keeps
    beside the library."""
    report, kind = {}, None
    for line in library.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kind = next((k for k in kinds if k in m.group(1)), None)
        if kind is None:
            continue
        regs, spill = report.get(kind, (0, 0))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs = max(regs, int(m.group(1)))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill += int(m.group(1)) + int(m.group(2))
        report[kind] = (regs, spill)
    return report


def tensor_core_instructions(library):
    """{kernel: count of warpgroup-mma (HGMMA) instructions} in the SASS of
    a built library, by `cuobjdump -sass` from the toolkit that built it;
    None where the tool is missing."""
    from stablediffusioneo_tpu_torch.ops.kernels.build import find_nvcc

    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
        elif name and "HGMMA" in line:
            counts[name] = counts.get(name, 0) + 1
    return counts


# ------------------------------------------------------------- kernel phase


def bound_ms(ops, peak, nbytes):
    """The least time the card could take for one call, ms, and what sets
    it: the larger of ops / peak (the operations the function does on these
    inputs over the card's peak rate for their type) and nbytes /
    PEAK_BYTES (every input read once and every output written once)."""
    by_ops, by_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def attention_work(batch, heads, tq, s, head_dim, itemsize=2):
    """(operations, bytes, exps) of one attention call: 2 products of
    2*Tq*S*d each per head; q and o of Tq rows, k and v of S rows; one exp
    per logit."""
    ops = 4 * batch * heads * tq * s * head_dim
    nbytes = 2 * batch * heads * head_dim * (tq + s) * itemsize
    return ops, nbytes, batch * heads * tq * s


def measure(name, desc, kern, plain, make_inputs, relative=False, others=None,
            ops=0, peak=PEAK_FP32, library=None, variants=None):
    """One row of the kernel phase: in bf16 and fp32, the kernel's output
    against its plain version's on the same inputs, and both times.
    relative: fp32 sums, checked against STATS_TOL x max |plain|.
    others: {name: fn(*inputs)}, further versions timed on the device in
    bf16 (row key f"bf16_{name}_ms"). ops, peak: the operations of one bf16
    call and the peak rate of their type, for the row's bound (the bytes
    are those of the inputs and the output). library: the one PyTorch call
    that computes the same function, timed in bf16 as a yardstick.
    variants: the wrappers' launch counter by variant or plan."""
    row = dict(desc)
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        args = make_inputs(dtype)
        ref = plain(*args).float()
        if variants is not None:
            variants.clear()
        out = kern(*args)
        out_bytes = out.numel() * out.element_size()
        got = out.float()
        del out  # freed before anything else is allocated, as in the timed calls
        err = (got - ref).abs()
        del got
        torch.cuda.synchronize()
        if variants is not None:
            row[f"{tag}_variant"] = "+".join(sorted(map(str, variants)))
        if tag == "bf16":
            nbytes = sum(t.numel() * t.element_size() for t in args) + out_bytes
            row["bound_ms"], row["bound_by"] = bound_ms(ops, peak, nbytes)
        mx, mean = err.max().item(), err.mean().item()
        row[f"{tag}_max_abs_err"], row[f"{tag}_mean_abs_err"] = mx, mean
        if relative:
            row[f"{tag}_max_rel_err"] = rel = mx / ref.abs().max().item()
            ok = rel <= STATS_TOL
        elif tag == "bf16":
            ok = mx <= BF16_TOL[0] and mean <= BF16_TOL[1]
        else:
            ok = mx <= FP32_TOL
        row[f"{tag}_ms"] = device_ms(lambda: kern(*args))
        row[f"{tag}_plain_ms"] = device_ms(lambda: plain(*args))
        row[f"{tag}_eager_ms"] = time_ms(lambda: kern(*args))
        row[f"{tag}_plain_eager_ms"] = time_ms(lambda: plain(*args))
        if tag == "bf16":
            row["library_ms"] = device_ms(lambda: library(*args)) if library else None
            for other, fn in (others or {}).items():
                row[f"bf16_{other}_ms"] = device_ms(lambda: fn(*args))
                print(f"kernel {name} {desc} bf16: device {other} "
                      f"{row[f'bf16_{other}_ms']:.4f} ms", flush=True)
            print(f"kernel {name} {desc} bf16: bound {row['bound_ms']:.4f} ms by "
                  f"{row['bound_by']}, library call "
                  + (f"{row['library_ms']:.4f} ms" if library else "none")
                  + (f", variant {row['bf16_variant']}" if variants is not None else ""),
                  flush=True)
        print(f"kernel {name} {desc} {tag}: max|d| {mx:.3e} mean|d| {mean:.3e}  "
              f"device: kernel {row[f'{tag}_ms']:.4f} ms, plain "
              f"{row[f'{tag}_plain_ms']:.4f} ms; eager call: kernel "
              f"{row[f'{tag}_eager_ms']:.4f} ms, plain {row[f'{tag}_plain_eager_ms']:.4f} ms",
              flush=True)
        if not ok:
            raise AssertionError(f"{name} {desc} {tag} disagrees with its plain "
                                 f"version: {mx}, {mean}")
        del args, ref, err
        torch.cuda.empty_cache()
    return row


def kernel_phase(cfg):
    from stablediffusioneo_tpu_torch.ops.kernels import attention as ka
    from stablediffusioneo_tpu_torch.ops.kernels import groupnorm as kg
    from stablediffusioneo_tpu_torch.ops.kernels import layernorm as kl
    from stablediffusioneo_tpu_torch.ops.kernels import quant as kq
    from stablediffusioneo_tpu_torch.ops.quant import quantize_weights

    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(shape, dtype, scale=1.0, shift=0.0, channels_last=False):
        t = (torch.randn(shape, generator=g, device="cuda") * scale + shift).to(dtype)
        return t.contiguous(memory_format=torch.channels_last) if channels_last else t

    def affine(c, dtype):
        return randn((c,), dtype, 0.1, 1.0), randn((c,), dtype, 0.1)

    results = {name: [] for name in KERNELS}
    for name, q_shape, s, heads in attention_rows(cfg):
        if name == "fused_attention":
            kv_shape = q_shape[:2] + (s, q_shape[3])
            batch, tq, d = q_shape[0], q_shape[2], q_shape[3]
            scale = d ** -0.5
            kern = lambda q, k, v: ka.fused_attention(q, k, v, scale)
            plain = lambda q, k, v: ka.fused_attention_plain(q, k, v, scale)
            library = F.scaled_dot_product_attention
        else:
            kv_shape = (q_shape[0], s, q_shape[2])
            batch, tq, d = q_shape[0], q_shape[1], q_shape[2] // heads
            scale = d ** -0.5
            kern = (lambda q, k, v, e=getattr(ka, name): e(q, k, v, heads, scale))
            plain = (lambda q, k, v, e=getattr(ka, name + "_plain"):
                     e(q, k, v, heads, scale))
            # the library call on the head-split view of the packed tensors
            library = lambda q, k, v: F.scaled_dot_product_attention(
                *(t.view(batch, -1, heads, d).transpose(1, 2) for t in (q, k, v)))
        ops, _, exps = attention_work(batch, heads, tq, s, d)
        row = measure(
            name, {"q": list(q_shape), "s": s, "heads": heads}, kern, plain,
            lambda dt: (randn(q_shape, dt), randn(kv_shape, dt), randn(kv_shape, dt)),
            ops=ops, peak=PEAK_BF16, library=library, variants=ka.variant_launches)
        # a second figure beside the bound: one exp per logit on the
        # special-function units
        row["exp_ms"] = exps / PEAK_EXP * 1e3
        want = "wgmma_split" if d == 512 else "wgmma"  # the tensor-core variants
        if row["bf16_variant"] != want or row["fp32_variant"] != "cuda_core":
            raise AssertionError(f"{name} {q_shape} x {s} ran {row['bf16_variant']} "
                                 f"(bf16) and {row['fp32_variant']} (fp32)")
        results[name].append(row)

    # the int8 matmul at every gated 512x512 GEMM (output std ~0.5)
    for m, k, n in sorted(set(quant_gated(quant_sites(cfg, RES)))):
        w = torch.randn((n, k), generator=g, device="cuda") * (0.5 / k ** 0.5)
        w_q, w_scale = quantize_weights(w)
        w_bf16 = w.to(torch.bfloat16)
        row = measure(
            "quantized_matmul", {"m": m, "k": k, "n": n},
            kq.quantized_matmul, kq.quantized_matmul_plain,
            lambda dt: (randn((m, k), dt), w_q, w_scale),
            ops=2 * m * k * n, peak=PEAK_BF16,
            others={"dequant_linear": lambda x, q, sc: F.linear(
                        x, (q.float() * sc[:, None]).to(x.dtype)),
                    "bf16_linear": lambda x, q, sc: F.linear(x, w_bf16)},
            variants=kq.plan_launches)
        if not (row["bf16_variant"].startswith("wgmma ")
                and row["fp32_variant"].startswith("cuda_core ")):
            raise AssertionError(f"quantized_matmul {(m, k, n)} ran {row['bf16_variant']} "
                                 f"(bf16) and {row['fp32_variant']} (fp32)")
        results["quantized_matmul"].append(row)
        del w, w_q, w_scale, w_bf16

    # the one-pass GroupNorm at every gated main-path site, channels-last
    gn_sites = sorted({(shape, swish, groups)
                       for kind, shape, swish, groups in norm_sites(cfg, RES)["step"]
                       if kind == "gn" and gated((kind, shape, swish, groups),
                                                 torch.bfloat16)})
    for shape, swish, groups in gn_sites:
        eps = 1e-5 if swish else 1e-6
        results["fused_group_norm"].append(measure(
            "fused_group_norm", {"x": list(shape), "groups": groups, "swish": swish},
            lambda x, w, b: kg.fused_group_norm(x, w, b, groups, eps, swish),
            lambda x, w, b: kg.fused_group_norm_plain(x, w, b, groups, eps, swish),
            lambda dt: (randn(shape, dt, channels_last=True), *affine(shape[1], dt)),
            ops=NORM_OPS * math.prod(shape),
            library=lambda x, w, b: (F.silu(F.group_norm(x, groups, w, b, eps)) if swish
                                     else F.group_norm(x, groups, w, b, eps)),
            variants=kg.plan_launches))

    # the two-pass pair, reached only by calling fused_group_norm directly
    for shape in ((1, 128, 512, 512), (2, 960, 64, 64)):
        x32 = randn(shape, torch.float32, channels_last=True)
        rows = kg.chunk_rows(x32, 32)
        desc = {"x": list(shape), "groups": 32, "chunk_rows": rows}
        results["group_norm_stats"].append(measure(
            "group_norm_stats", desc,
            lambda x: kg.group_norm_stats(x, 32, rows),
            lambda x: kg.group_norm_stats_plain(x, 32, rows),
            lambda dt: (x32.to(dt),), relative=True, ops=3 * x32.numel()))

        def apply_inputs(dt):
            x = x32.to(dt)
            return (x, kg.group_norm_stats_plain(x, 32, rows), *affine(shape[1], dt))

        results["group_norm_apply"].append(measure(
            "group_norm_apply", desc,
            lambda x, p, w, b: kg.group_norm_apply(x, p, w, b, rows, 1e-6, True),
            lambda x, p, w, b: kg.group_norm_apply_plain(x, p, w, b, 1e-6, True),
            apply_inputs, ops=NORM_OPS * x32.numel()))
        del x32

    for shape in ((2, 4096, 320), (2, 1024, 640), (2, 256, 1280)):
        results["fused_layer_norm"].append(measure(
            "fused_layer_norm", {"x": list(shape)},
            lambda x, w, b: kl.fused_layer_norm(x, w, b, 1e-5),
            lambda x, w, b: kl.fused_layer_norm_plain(x, w, b, 1e-5),
            lambda dt: (randn(shape, dt), *affine(shape[-1], dt)),
            ops=NORM_OPS * math.prod(shape),
            library=lambda x, w, b: F.layer_norm(x, x.shape[-1:], w, b, 1e-5)))
    return results


# ------------------------------------------------- launches the plans imply


def _transformer_sites(cfg, lat):
    """(channels, latent side) of every transformer block one DDIM step runs:
    the UNet's input, middle and output blocks and the ControlNet's input
    and middle blocks."""
    from stablediffusioneo_tpu_torch.models.unet import decoder_plan, encoder_plan

    ucfg = cfg.unet
    levels = len(ucfg.channel_mult)
    mid = (ucfg.model_channels * ucfg.channel_mult[-1], lat // 2 ** (levels - 1))
    sites = []
    for plan, copies in ((encoder_plan(ucfg), 2), (decoder_plan(ucfg), 1)):
        for d in plan:
            if d["attn"]:
                sites += [(d["cout"], lat // d["ds"])] * (copies * d["depth"])
    return sites + [mid] * (2 * ucfg.depth_for(levels - 1))


def attention_sites(cfg, res, batch=2):
    """Every multi-head attention call of one DDIM step on the CFG batch, as
    (q shape (B, Tq, C), key length, heads): each transformer block runs a
    self- (S = Tq) and a cross-attention (S = the context length)."""
    sites = []
    for c, side in _transformer_sites(cfg, res // cfg.vae.downsample_factor):
        q, heads = (batch, side * side, c), cfg.unet.heads_for(c)
        sites += [(q, side * side, heads), (q, cfg.clip.max_length, heads)]
    return sites


def attention_route(q_shape, s, dtype):
    """The kernel entry multi_head_attention sends a site to, or None."""
    from stablediffusioneo_tpu_torch.ops.attention import stream_attention
    from stablediffusioneo_tpu_torch.ops.dispatch import ATTN_MIN_TQ

    _, tq, c = q_shape
    if tq < ATTN_MIN_TQ:
        return None
    if stream_attention(tq, s, c, dtype):
        return "fused_attention_packed_stream"
    return "fused_attention_packed"


def expected_launches(cfg, res, dtype=torch.bfloat16):
    """Attention launches of one DDIM step by kernel entry, and split
    launches of one decode (the VAE mid-block attends once at latent
    resolution)."""
    from stablediffusioneo_tpu_torch.ops.dispatch import ATTN_MIN_TQ

    step = {"fused_attention_packed": 0, "fused_attention_packed_stream": 0}
    for q_shape, s, _ in attention_sites(cfg, res):
        route = attention_route(q_shape, s, dtype)
        if route:
            step[route] += 1
    lat = res // cfg.vae.downsample_factor
    return step, int(lat * lat >= ATTN_MIN_TQ)


def attention_rows(cfg):
    """(entry, q shape, key length, heads) of every distinct kernel-gated
    attention call of the 512x512 request and of the 1024x1024 hires pass."""
    rows = []
    for res in (RES, HIRES_RES):
        for q_shape, s, heads in attention_sites(cfg, res):
            route = attention_route(q_shape, s, torch.bfloat16)
            if route and (route, q_shape, s, heads) not in rows:
                rows.append((route, q_shape, s, heads))
        lat = res // cfg.vae.downsample_factor
        rows.append(("fused_attention", (1, 1, lat * lat, cfg.vae.ch * cfg.vae.ch_mult[-1]),
                     lat * lat, 1))
    return rows


def quant_sites(cfg, res, batch=2):
    """(M, K, N) of every linear that quantize_linears=True converts, for
    one DDIM step on the CFG batch: the time-embedding MLP and each
    ResBlock's emb projection (M = batch), the GEGLU pair of each
    transformer block (M = batch x tokens)."""
    from stablediffusioneo_tpu_torch.models.unet import decoder_plan, encoder_plan

    ucfg, lat = cfg.unet, res // cfg.vae.downsample_factor
    emb, mc = ucfg.time_embed_dim, ucfg.model_channels
    mid = mc * ucfg.channel_mult[-1]
    couts = [d["cout"] for d in encoder_plan(ucfg) if d["kind"] == "res"] + [mid, mid]
    couts = 2 * couts + [d["cout"] for d in decoder_plan(ucfg)]  # ControlNet, UNet
    sites = [(batch, mc, emb), (batch, emb, emb)] * 2
    sites += [(batch, emb, c) for c in couts]
    for c, side in _transformer_sites(cfg, lat):
        m = batch * side * side
        sites += [(m, c, 8 * c), (m, 4 * c, c)]
    return sites


def quant_gated(sites):
    """The (M, K, N) that the int8_linear gate sends to the kernel."""
    from stablediffusioneo_tpu_torch.ops.kernels.quant import pick_blocks

    return [(m, k, n) for m, k, n in sites if pick_blocks(m, n)]


def _unet_norms(ucfg, lat, batch, decoder):
    """Norm calls of one UNet evaluation (decoder=False: the ControlNet's
    input and middle blocks), in module order."""
    from stablediffusioneo_tpu_torch.models.unet import decoder_plan, encoder_plan

    sites = []

    def res(cin, cout, side):  # ResBlock: in and out GroupNorm+SiLU
        sites.extend(("gn", (batch, c, side, side), True, ucfg.groups)
                     for c in (cin, cout))

    def st(c, depth, side):  # SpatialTransformer: GroupNorm, 3 LayerNorms a block
        sites.append(("gn", (batch, c, side, side), False, ucfg.groups))
        sites.extend([("ln", (batch, side * side, c), False, 0)] * (3 * depth))

    blocks = [d for d in encoder_plan(ucfg) if d["kind"] == "res"]
    levels = len(ucfg.channel_mult)
    for d in blocks:
        res(d["cin"], d["cout"], lat // d["ds"])
        if d["attn"]:
            st(d["cout"], d["depth"], lat // d["ds"])
    ch, side = ucfg.model_channels * ucfg.channel_mult[-1], lat // 2 ** (levels - 1)
    res(ch, ch, side)
    st(ch, ucfg.depth_for(levels - 1), side)
    res(ch, ch, side)
    if decoder:
        for d in decoder_plan(ucfg):
            res(d["cin"], d["cout"], lat // d["ds"])
            if d["attn"]:
                st(d["cout"], d["depth"], lat // d["ds"])
        sites.append(("gn", (batch, ucfg.model_channels, lat, lat), True, ucfg.groups))
    return sites


def _vae_norms(vcfg, lat, batch):
    """Norm calls of one VAE decode, in module order."""
    def gn(c, side, swish=True):
        return ("gn", (batch, c, side, side), swish, vcfg.groups)

    bi, side = vcfg.ch * vcfg.ch_mult[-1], lat
    sites = [gn(bi, side), gn(bi, side), gn(bi, side, False), gn(bi, side), gn(bi, side)]
    for i in reversed(range(len(vcfg.ch_mult))):
        cout = vcfg.ch * vcfg.ch_mult[i]
        for _ in range(vcfg.num_res_blocks + 1):
            sites += [gn(bi, side), gn(cout, side)]
            bi = cout
        if i != 0:
            side *= 2
    return sites + [gn(bi, side)]


def norm_sites(cfg, res, samples=1):
    """Every GroupNorm and LayerNorm call of a request, from the plans, as
    (kind, shape, swish, groups): "step" = one DDIM step (UNet and
    ControlNet on the CFG batch), "decode" = the VAE decode, "prompt" = the
    CLIP tower on the cond and uncond prompts."""
    lat = res // cfg.vae.downsample_factor
    clip = cfg.clip
    return {
        "step": (_unet_norms(cfg.unet, lat, 2 * samples, True)
                 + _unet_norms(cfg.controlnet.unet, lat, 2 * samples, False)),
        "decode": _vae_norms(cfg.vae, lat, samples),
        "prompt": [("ln", (2, clip.max_length, clip.hidden_size), False, 0)]
                  * (2 * clip.num_layers + 1),
    }


def gated(site, dtype):
    """Whether the fused-norm configuration sends this site to a kernel."""
    from stablediffusioneo_tpu_torch.ops.kernels.groupnorm import group_norm_supported
    from stablediffusioneo_tpu_torch.ops.kernels.layernorm import layer_norm_supported

    kind, shape, _, groups = site
    if kind == "gn":
        return group_norm_supported(shape, groups)
    return layer_norm_supported(shape, dtype)


def norm_launches(sites, dtype):
    return {name: sum(1 for s in sites if s[0] == kind and gated(s, dtype))
            for name, kind in (("fused_group_norm", "gn"), ("fused_layer_norm", "ln"))}


def expected_request_launches(cfg, config):
    """Every kernel's launches over the two timed requests of main_path."""
    step, per_decode = expected_launches(cfg, RES)
    want = dict.fromkeys(KERNELS, 0)
    for name, n in step.items():
        want[name] = STEPS * n
    if config == "hires":  # the base pass is not decoded
        hi_step, per_decode = expected_launches(cfg, HIRES_RES)
        for name, n in hi_step.items():
            want[name] += HIRES_T_ENC * n
    want["fused_attention"] = per_decode
    if config == "fused norms":
        sites = norm_sites(cfg, RES)
        step, decode, prompt = (norm_launches(sites[k], torch.bfloat16)
                                for k in ("step", "decode", "prompt"))
        for name in step:
            want[name] = STEPS * step[name] + decode[name] + prompt[name]
    if config == "int8":
        want["quantized_matmul"] = STEPS * len(quant_gated(quant_sites(cfg, RES)))
    return {name: 2 * n for name, n in want.items()}


# ------------------------------------------------------ model-level phases


def build_model(cfg, seed):
    from stablediffusioneo_tpu_torch.models.cldm import ControlLDM, init_weights

    with torch.device("meta"):
        model = ControlLDM(cfg)
    model.to_empty(device="cuda")
    init_weights(model, torch.Generator(device="cuda").manual_seed(seed))
    return model


def reference_phase(model, cfg):
    """Full-width controlled-UNet eval at 256x256 (1024-token level-0 sites
    go through the packed kernel), fp32: card vs CPU, by default, with the
    fused-norm configuration (every gated GroupNorm through the one-pass
    kernel; the LayerNorm gate admits bf16 only), and with int8 linears
    (quantised once on the card, the same bytes copied to the CPU) and the
    int8_linear flag on (every gated GEGLU product through the fp32 kernel)."""
    from stablediffusioneo_tpu_torch.models.controlnet import controlled_unet_apply
    from stablediffusioneo_tpu_torch.ops import dispatch
    from stablediffusioneo_tpu_torch.ops.quant import quantize_linear_modules

    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 32, 32, 4), generator=g)
    hint = (torch.rand((2, 256, 256, 3), generator=g) > 0.8).float()
    ctx = torch.randn((2, 77, 768), generator=g)
    t = torch.tensor([801.0, 801.0])
    scales = [1.0] * 13
    attn = expected_launches(cfg, 256, torch.float32)[0]
    norms = norm_launches(norm_sites(cfg, 256)["step"], torch.float32)
    int8 = copy.deepcopy(model)
    for net in (int8.unet, int8.control_model):
        quantize_linear_modules(net)
    for config, card_model in (("default", model), ("fused norms", model),
                               ("int8", int8)):
        fused = config == "fused norms"
        dispatch.set_kernels(groupnorm=fused, layernorm=fused,
                             int8_linear=config == "int8")
        want = dict.fromkeys(KERNELS, 0)
        want.update(attn)
        if fused:
            want.update(norms)
        if config == "int8":
            want["quantized_matmul"] = len(quant_gated(quant_sites(cfg, 256)))
        outs = {}
        for dev, m in (("cuda", card_model), ("cpu", copy.deepcopy(card_model).cpu())):
            dispatch.reset_launches()
            with torch.no_grad():
                out = controlled_unet_apply(
                    m.unet, m.control_model, x.to(dev), hint.to(dev), t.to(dev),
                    ctx.to(dev), control_scales=scales)
            outs[dev] = out.cpu()
            if dev == "cuda":
                launches = dict(dispatch.launches)
        err = (outs["cuda"] - outs["cpu"]).abs().max().item()
        ref_scale = outs["cpu"].abs().max().item()
        print(f"reference ({config}): full-width controlled UNet 256x256 fp32, "
              f"card vs CPU max|d| {err:.3e} (max|ref| {ref_scale:.3e}), "
              f"launches {launches}", flush=True)
        if not (torch.isfinite(outs["cuda"]).all() and err <= REF_TOL * ref_scale
                and launches == want):
            raise AssertionError(f"reference phase ({config}) failed: {err}, "
                                 f"{launches} (expected {want})")
    dispatch.set_kernels(groupnorm=False, layernorm=False, int8_linear=False)
    del int8
    torch.cuda.empty_cache()


def main_path(model, cfg, config):
    """One warm-up and two timed requests of one configuration: "default",
    "fused norms", "int8" (512x512) or "hires" (512 -> 1024)."""
    from stablediffusioneo_tpu_torch.ops import dispatch
    from stablediffusioneo_tpu_torch.ops.kernels.attention import variant_launches
    from stablediffusioneo_tpu_torch.ops.kernels.groupnorm import plan_launches as gn_plans
    from stablediffusioneo_tpu_torch.ops.kernels.quant import plan_launches as qmm_plans
    from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline

    fused = config == "fused norms"
    dispatch.set_kernels(groupnorm=fused, layernorm=fused,
                         int8_linear=config == "int8")
    pipe = Canny2ImagePipeline(model, stand_in_tokenizer, cfg, device="cuda",
                               quantize_linears=config == "int8")
    rng = np.random.default_rng(0)
    img = np.zeros((RES, RES, 3), np.uint8)
    img[96:416, 128:384] = 200  # a box with edges, plus texture
    img = (img + rng.integers(0, 40, img.shape)).astype(np.uint8)
    kw = dict(num_samples=1, image_resolution=RES, ddim_steps=STEPS,
              scale=SCALE, eta=0.0, strength=1.0)
    res = RES
    if config == "hires":
        kw.update(hires_upscale=HIRES_UPSCALE, hires_denoise=HIRES_DENOISE)
        res = HIRES_RES
    t0 = time.perf_counter()
    pipe.process(img, "a house in the woods", seed=0, **kw)
    print(f"main path ({config}) warm-up request: {time.perf_counter() - t0:.3f} s",
          flush=True)
    torch.cuda.synchronize()
    dispatch.reset_launches()
    for counter in (variant_launches, gn_plans, qmm_plans):
        counter.clear()
    images, latencies = [], []
    for seed in (1, 2):
        t0 = time.perf_counter()
        out = pipe.process(img, "a house in the woods", seed=seed, **kw)
        latencies.append(time.perf_counter() - t0)
        z = pipe.last_latents
        if not (torch.isfinite(z).all() and z.shape == (1, res // 8, res // 8, 4)):
            raise AssertionError(f"final latents are not finite or misshapen: {z.shape}")
        if not (out[1].shape == (res, res, 3) and out[1].dtype == np.uint8
                and out[0].shape == (res, res, 3)):
            raise AssertionError(f"image {out[1].shape} {out[1].dtype}, map {out[0].shape}")
        images.append(out[1])
        print(f"main path ({config}) request seed={seed}: {latencies[-1]:.4f} s "
              f"({pipe.last_timings})", flush=True)
    launches = dict(dispatch.launches)
    want = expected_request_launches(cfg, config)
    print(f"main path ({config}) kernel launches over the 2 requests: {launches} "
          f"(expected from the plans and gates: {want})", flush=True)
    if launches != want:
        raise AssertionError(f"launch counts ({config}) {launches} != {want}")
    # every attention launch of the bf16 main path is a tensor-core variant
    want_variants = {"wgmma": want["fused_attention_packed"]
                     + want["fused_attention_packed_stream"],
                     "wgmma_split": want["fused_attention"]}
    print(f"main path ({config}) attention launches by variant: "
          f"{dict(variant_launches)}", flush=True)
    if {k: v for k, v in variant_launches.items() if v} != \
            {k: v for k, v in want_variants.items() if v}:
        raise AssertionError(f"attention variants ({config}) {dict(variant_launches)} "
                             f"!= {want_variants}")
    # every int8 matmul launch of the bf16 main path is the wgmma variant
    by_plan = {str(plan): n for plan, n in qmm_plans.items()}
    if by_plan or gn_plans:
        print(f"main path ({config}) int8 matmul launches by plan: {by_plan}; "
              f"one-pass GroupNorm launches by plan: "
              f"{ {str(plan): n for plan, n in gn_plans.items()} }", flush=True)
    if (sum(n for plan, n in qmm_plans.items() if plan.variant == "wgmma")
            != want["quantized_matmul"] or sum(qmm_plans.values()) != want["quantized_matmul"]
            or sum(gn_plans.values()) != want["fused_group_norm"]):
        raise AssertionError(f"plans ({config}) {by_plan}, {dict(gn_plans)} do not add up "
                             f"to {want}")
    if np.array_equal(images[0], images[1]):
        raise AssertionError("two seeds gave the same image")
    print(f"image stats ({config}): mean {images[0].mean():.2f} std "
          f"{images[0].std():.2f}; seeds differ in "
          f"{(images[0] != images[1]).mean():.3f} of values", flush=True)
    trace = traced_request(lambda: pipe.process(img, "a house in the woods", seed=3, **kw))
    if trace is None:
        traced = None
        print(f"main path ({config}) traced request: not measured (the profiler gave "
              "no device events)", flush=True)
    else:
        ms, parts, n_ops = trace
        traced = {"device_ms": ms, "device_ops": n_ops,
                  **{f"{family}_ms": part for family, part in parts.items()}}
        print(f"main path ({config}) traced request: device time {ms:.1f} ms in "
              f"{n_ops} device operations; this package's kernels, ms: "
              + ", ".join(f"{family} {part:.1f}" for family, part in parts.items()),
              flush=True)
    pipe.runtime.release()
    dispatch.set_kernels(groupnorm=False, layernorm=False, int8_linear=False)
    return launches, latencies, images[0], traced


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs on the card only")
    from stablediffusioneo_tpu_torch.config import sd15_pipeline
    from stablediffusioneo_tpu_torch.ops.kernels import (
        attention, build, groupnorm, layernorm, quant)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    # fp32 checks need true fp32 products on both sides (cuDNN defaults to TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          "TF32 off for matmul and cuDNN", flush=True)
    t_start = t0 = time.perf_counter()
    build.load_libraries({"attention": attention.SOURCES,
                          "groupnorm": groupnorm.SOURCES,
                          "layernorm": layernorm.SOURCES,
                          "quant": quant.SOURCES})
    print(f"kernel build + load: {time.perf_counter() - t0:.2f} s (nvcc, in "
          f"parallel: {build.build_seconds})", flush=True)
    for name, sources in (("attention", attention.SOURCES), ("quant", quant.SOURCES)):
        kinds = TENSOR_CORE_KERNELS[name]
        library = build.library_path(name, sources)
        regs = ptxas_report(library, kinds)
        print(f"ptxas, tensor-core kernels of the {name} library, (most registers, "
              f"spill bytes): {regs}", flush=True)
        if len(regs) != len(kinds) or any(spill for _, spill in regs.values()):
            raise AssertionError(f"a tensor-core {name} kernel spills or is missing: {regs}")
        hgmma = tensor_core_instructions(library)
        if hgmma is None:
            print("SASS check skipped: no cuobjdump beside nvcc", flush=True)
            continue
        wanted = {kind: {n: c for n, c in hgmma.items() if kind in n} for kind in kinds}
        print(f"SASS of the {name} library, HGMMA (wgmma) instructions per kernel: "
              f"{ {kind: sorted(found.values()) for kind, found in wanted.items()} }",
              flush=True)
        if not all(wanted.values()):
            raise AssertionError(f"a tensor-core {name} kernel has no HGMMA: {hgmma}")

    cfg = sd15_pipeline(dtype="bfloat16")
    kernels = kernel_phase(cfg)
    print(f"kernel phase done at {time.perf_counter() - t_start:.1f} s", flush=True)
    model = build_model(cfg, seed=0)
    reference_phase(model, cfg)
    print(f"reference phase done at {time.perf_counter() - t_start:.1f} s", flush=True)
    runs = {}
    for config in ("default", "fused norms", "int8", "hires"):
        runs[config] = main_path(model, cfg, config)
        print(f"main path ({config}) done at {time.perf_counter() - t_start:.1f} s",
              flush=True)
    latencies = {config: r[1] for config, r in runs.items()}
    base = runs["default"][2].astype(np.int16)
    print(f"request latency, s: {latencies}; seed-1 images against the default's, "
          f"mean |d| of 255: fused norms "
          f"{np.abs(base - runs['fused norms'][2]).mean():.3f}, int8 "
          f"{np.abs(base - runs['int8'][2]).mean():.3f}", flush=True)

    out = []
    for name, (source, replaces) in KERNELS.items():
        rows = kernels[name]
        launches = runs[EXERCISED_BY.get(name, "fused norms")][0]
        by = {kind: sum(r["bound_ms"] for r in rows if r["bound_by"] == kind)
              for kind in ("operations", "bytes")}
        library = [r["library_ms"] for r in rows]
        out.append({
            "name": name, "route": "cuda", "source": f"{CSRC}/{source}",
            "replaces": f"{PALLAS}/{replaces}",
            # the main-path run that exercises the kernel (EXERCISED_BY),
            # two requests
            "launches": launches[name],
            "launches_per_request": launches[name] / 2,
            "max_abs_err": max(r["bf16_max_abs_err"] for r in rows),
            # device time of one call at each main-path (or listed) shape,
            # bf16, summed over the shapes; the bound and the library call's
            # time summed over the same shapes
            "ms": sum(r["bf16_ms"] for r in rows),
            "plain_ms": sum(r["bf16_plain_ms"] for r in rows),
            "bound_ms": sum(by.values()),
            "bound_by": max(by, key=by.get),
            "library_ms": None if None in library else sum(library),
            "shapes": rows,
        })
    print(json.dumps({"kernels": out, "request_s": latencies,
                      "traced": {config: r[3] for config, r in runs.items()}}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
