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
     transformer sites of the 512x512 request and of the 1024x1024 hires
     pass; the int8 matmul at every gated 512x512 GEMM) and
     the two-pass GroupNorm pair at two large slabs (the stats pass also
     with each of its two kernels forced), in bf16 and fp32, with
     both timed on the device (torch.profiler's kernel durations over 20
     calls) and eagerly (CUDA events around one call, host launch cost
     included); beside them the row's bound (the least time the card could
     take: see `bound_ms`) and, where one PyTorch call computes the same
     function, that call's device time as a yardstick (library_ms:
     scaled_dot_product_attention, F.group_norm (+ F.silu), F.layer_norm;
     the port itself never calls them); each attention row also names the
     variant of csrc/attention.cu it ran, each int8 matmul, GroupNorm and
     LayerNorm row the plan it ran (variant, tile, K split; access width,
     cluster size; threads a row, rows a block; tile rows), and a bf16
     attention or int8 matmul row on another variant than the tensor-core
     one fails the run, as does a bf16 LayerNorm row slower than F.layer_norm
     by more than LIBRARY_SPREAD; the int8 matmul also
     against the flag-off path (dequantise, then cuBLAS) and the
     unquantised bf16 F.linear;
  2. reference phase: one full-width controlled-UNet evaluation at 256x256
     in fp32 on the card (through the kernels) against the same weights on
     the CPU (plain versions), TF32 off; by default, with the fused-norm
     configuration (set_kernels(groupnorm=True, layernorm=True)), and with
     int8 linears (quantised once, the bytes shared by card and CPU) and
     set_kernels(int8_linear=True);
  3. main paths: Canny2ImagePipeline.process at the full SD-1.5 widths in
     bf16, weights drawn from a fixed seed, through the runtime's captured
     engines (CUDA graphs): one warm-up request, which captures them (the
     seconds and `report()` are printed), then two timed replayed requests
     (20 DDIM steps, scale 9, eta 0, batch 1), counting the kernel launches
     of those two requests, then one eager request (graphs=False) with the
     first one's seed, whose image must equal the replayed one in bytes;
     512x512 by default, with the fused-norm configuration, and with int8
     linears (quantize_linears=True, set_kernels(int8_linear=True)); then
     the hires fix 512 -> 1024 (hires_upscale=2.0, hires_denoise=0.7: the
     last 14 of 20 steps again at 1024x1024); then the other samplers, each
     a main path of 20 steps: DPM-Solver++(2M) Karras, Euler-a (its step noise
     drawn from the seed), Heun (39 evaluations), and DDIM with token merging
     (tome_ratio=0.5: the 7 level-0 self-attentions of an evaluation at 2048 of
     4096 tokens). Every run adds one traced
     replayed request (torch.profiler) for the device time per request and
     the part of it spent in this package's attention, GroupNorm, LayerNorm
     and int8 matmul kernels, and times one replay of each engine by CUDA
     events. Then three short requests (4 steps) at full width: the default,
     encoder_cache_interval=2 and cfg_rescale=0.7 (finite latents, images
     that differ from the default's); and every other sampler name at 4 steps
     (sampler_variants: a replayed request equal to the eager one in bytes,
     another image than DDIM's, launches as its evaluations say). Then the
     serving path (serving_phase): DiffusionServer over the seeded model as
     the JAX bench's serving row runs it (buckets (1, 4), a 300 ms window,
     warmup(), 4 warm requests, 16 timed ones from 8 client threads, Canny
     hints bit-packed), with img/s, the batch histogram, the mean queue and
     run times, each engine's capture seconds and pool, one traced batch-4
     replay; held: a batch-4 cut, launches as the plans say for each batch,
     the first batch-4 cut equal in bytes to the runtime's own batch-4 call
     of those requests, 3 served rows each nearest its own request's
     process() image (beside the share of pixels off by more than 1 and a
     1-ulp-scale control), one request equal in bytes in two
     other batch-4 compositions and with two batches in flight, one POST
     /generate on localhost, the packed hint engine equal in bytes to the
     uint8 one; and two seeded ControlNets (multi_controlnet_phase: replayed =
     eager in bytes, the UNet's and each net's attention launches);
  4. checkpoint: the seeded model's state dict (bf16, all 1,470 keys of
     control_sd15_canny) written with torch.save to a temporary directory and
     read back by checkpoint.load_controlnet_pipeline onto the card: its size
     and the seconds to write and load it; every key consumed, none orphaned;
     a default request on the loaded model gives the seeded model's image in
     bytes. The phases below run on the loaded model, with a CLIP BPE
     tokenizer read by CLIPTokenizer.from_pretrained from a merges file this
     script writes (48,894 merges of byte-unicode pairs: CLIP's 49,408 ids);
  5. img2img (init_image, denoise_strength=0.75: the last 15 of 20 steps)
     and inpainting (a rectangular mask, 20 steps), by default and with
     fused norms, each as a main path above: the VAE encoder's engine
     (posterior mode) and the loop's init-latent or inpaint variant; two split
     attention launches a request (encode and decode), the encoder's
     GroupNorms with fused norms; encode_image alone: replayed equals eager
     in bytes, and a sample with a fixed eps repeats;
  6. the prompt front end as main paths: long_prompt=True (3 x 77 windows: the
     14 cross-attention sites a step at S = 231), long_prompt="auto" on a
     prompt of two windows (S = 154) and prompt_emphasis=True;
  7. the reference's surface: hackathon(...).initialize(), then one request
     with the 14 positional arguments and 2 samples: 2 images, no map;
  8. SD-2.1 ("sd21 768"): Canny2ImagePipeline.process with
     sd21_pipeline(dtype="bfloat16") (OpenCLIP ViT-H 24x1024 penultimate,
     heads of 64 channels, v-prediction) at 768x768 as a main path above,
     seeded weights: 560 packed attention launches a request (5 and 10
     heads) and one split;
  9. SDXL base txt2img at 1024x1024, 20 DDIM steps, scale 5, batch 1, bf16,
     weights drawn on the card ("sdxl 1024", and "sdxl 1024, fused norms"):
     sdxl_conditioning through both towers from the BPE tokenizer (their
     device time printed apart), then one captured sample+decode Engine
     (runtime/engine.py:sdxl_sample_decode_engine; capture seconds, graph
     nodes, pool bytes, peak memory): a warm-up, two timed replays, one
     eager request equal to the replay in bytes, one traced replay; 2,800
     packed launches (10 and 20 heads) and one split a request;
  10. the seeded SDXL's sgm-layout state dict (bf16, 2,515 keys with the two
     OpenCLIP leftovers) written to a temporary directory (its free bytes
     printed first) and read back by load_sdxl_pipeline onto the card: every
     key consumed or named, none orphaned, the seeded image in bytes.
The kernel phase also takes every attention shape of the SD-2.1 and SDXL
requests (heads of 64 channels; the 768x768 decode's (1, 1, 9216, 512)) and
the gated GroupNorm sites of an SDXL step; each attention row names the
passes that give it.
Launch counts must equal what the UNet, ControlNet, VAE and CLIP plans and
the dispatch gates imply. Any failed check raises, so the script exits
non-zero and prints no result. The last line is {"ok": true, "device":
{...}}; the line before it names the card and its power limit, the one
before that lists the kernels.
"""

import copy
import gc
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# A bf16 LayerNorm row may exceed F.layer_norm's time by this share before the
# run fails. Two runs of one row in one call on one H100 differed by at most
# 2.8% (F.layer_norm at (2, 4096, 640): 17.08 and 16.61 us), runs on different
# cards by up to 8% (the kernel at (2, 4096, 320): 3.47 and 3.77 us).
LIBRARY_SPREAD = 0.10
# large channels-last slabs for the two-pass GroupNorm pair (no dispatch path
# reaches it: the JAX package's gate keeps every SD-1.5 site on one pass)
APPLY_SHAPES = ((1, 128, 512, 512), (2, 960, 64, 64))
STEPS, RES, SCALE = 20, 512, 9.0
HIRES_UPSCALE, HIRES_DENOISE = 2.0, 0.7
HIRES_RES = int(round(RES * HIRES_UPSCALE / 64)) * 64
HIRES_T_ENC = max(1, min(STEPS, int(round(HIRES_DENOISE * STEPS))))
IMG2IMG_STRENGTH = 0.75
IMG2IMG_T_ENC = max(1, min(STEPS, int(round(IMG2IMG_STRENGTH * STEPS))))
TOME_RATIO = 0.5
# the other families: SD-2.1 (ControlNet, v) at 768x768; SDXL base txt2img at
# 1024x1024 with the JAX bench's guidance scale
SD21_RES, SDXL_RES, SDXL_SCALE = 768, 1024, 5.0
PROMPT = "a house in the woods"
# with the smoke's BPE vocabulary (pairs of characters) and WINDOW_TEXTS,
# about 220 tokens (3 windows of 75) and about 100 (2 windows)
LONG_PROMPT = ", ".join([PROMPT] + [f"{w} morning light over the hills"
                                    for w in ("soft", "warm", "pale", "golden", "misty",
                                              "early", "quiet", "clear")])
MID_PROMPT = ", ".join([PROMPT, "soft morning light over the hills",
                        "warm mist on the river", "a red door and a garden",
                        "roses by the old stone wall"])
# the long-prompt runs' a_prompt and n_prompt: short, so that the prompt
# alone sets the windows
WINDOW_TEXTS = {"a_prompt": "best quality", "n_prompt": "lowres, bad anatomy"}
EMPHASIS_PROMPT = "a (house:1.3) in the [woods], ((morning light))"
# main-path runs: kernel flags, process() arguments, prompt, the parts a
# request runs ("init": img2img, "inpaint": a mask, "windows": context windows)
RUNS = {
    "default": {},
    "fused norms": {"norms": True},
    "int8": {"int8": True},
    "hires": {"process": {"hires_upscale": HIRES_UPSCALE, "hires_denoise": HIRES_DENOISE}},
    "img2img": {"init": True},
    "img2img, fused norms": {"init": True, "norms": True},
    "inpaint": {"inpaint": True},
    "inpaint, fused norms": {"inpaint": True, "norms": True},
    "long prompt": {"process": {"long_prompt": True, **WINDOW_TEXTS}, "prompt": LONG_PROMPT,
                    "windows": 3},
    "long prompt, auto": {"process": {"long_prompt": "auto", **WINDOW_TEXTS},
                          "prompt": MID_PROMPT, "windows": 2},
    "emphasis": {"process": {"prompt_emphasis": True}, "prompt": EMPHASIS_PROMPT},
    "dpmpp-karras": {"process": {"sampler": "dpmpp-karras"}},
    "euler-a": {"process": {"sampler": "euler-a"}},
    "heun": {"process": {"sampler": "heun"}},
    "tome 0.5": {"process": {"tome_ratio": TOME_RATIO}},
    "sd21 768": {"family": "sd21", "res": SD21_RES},
    "sdxl 1024": {"family": "sdxl", "res": SDXL_RES},
    "sdxl 1024, fused norms": {"family": "sdxl", "res": SDXL_RES, "norms": True},
}
# the serving phase: the JAX bench's serving row (cli/bench.py:_bench_serving):
# batch buckets, batching window, warm and timed requests, client threads
SERVE_BUCKETS, SERVE_WAIT_MS = (1, 4), 300.0
SERVE_WARM, SERVE_TIMED, SERVE_CLIENTS = 4, 16, 8
SERVE_PROMPTS = ("a bird", "a dog on grass", "an oil painting of a ship", "a red sports car")
# the JAX test's contract between a served row and process() (under this share
# of pixels off by more than 1). At full width on the seeded weights it does
# not hold: a batch-4 row and its batch-1 request differ in ~7-11% of pixels,
# as much as the batch-1 request does from itself with one of x_T's 16,384
# values scaled by 1.01 (this phase and scripts/torch_batch_variance.py, on an
# NVIDIA H100 80GB HBM3 at 700 W). cuDNN takes other convolution algorithms at
# another batch size (the first output that differs is the hint block's
# 128x128 conv), and the untrained nets spread any last-bit change over 20
# steps. So the smoke prints it beside that control, and holds the served rows
# equal in bytes to the runtime's own batch-4 call of the same requests, and
# each served row nearer its own request's process() image than any other's.
SERVE_PIXEL_SHARE = 0.02
# the other sampler names, at 4 steps (sampler_variants)
SAMPLER_VARIANTS = ("plms", "dpmpp", "unipc", "unipc-karras", "euler", "euler-uniform",
                    "euler-a-uniform", "heun-uniform")


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
FAMILIES = {"attention": "attention_", "group_norm": "gn_", "layer_norm": "ln_held_",
            "quantized_matmul": "qmm_"}


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
# every kernel of the norm libraries, held to no spills
NORM_KERNELS = {"groupnorm": ("gn_fused_kernel", "gn_stats_kernel", "gn_stats_rows_kernel",
                              "gn_apply_kernel", "gn_apply_rows_kernel"),
                "layernorm": ("ln_held_kernel", "ln_twice_kernel")}


def ptxas_report(library, kinds):
    """{kernel kind: (most registers a thread, spill bytes)} of a library's
    kernels of these kinds, from the `ptxas -v` report that the build keeps
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
    for (name, q_shape, s, heads), paths in attention_rows(cfg, paths=True).items():
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
            name, {"q": list(q_shape), "s": s, "heads": heads, "paths": paths}, kern, plain,
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

    # the one-pass GroupNorm at every gated main-path site of a step, SD-1.5
    # at 512x512 and SDXL at 1024x1024, channels-last
    gn_sites = sorted({(shape, swish, groups)
                       for pcfg, res in ((cfg, RES), (family_configs()[1], SDXL_RES))
                       for kind, shape, swish, groups in norm_sites(pcfg, res)["step"]
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
    for shape in APPLY_SHAPES:
        x32 = randn(shape, torch.float32, channels_last=True)
        rows = kg.chunk_rows(x32, 32)
        desc = {"x": list(shape), "groups": 32, "chunk_rows": rows}
        # beside the plan stats_plan picks, each of the two kernels forced
        # (bf16): the (sample, group, chunk) kernel is the earlier one
        forced = {name: kg.stats_plan(shape, 32, torch.bfloat16, True, rows, by_rows=by)
                  for name, by in (("group_x_chunk", False), ("rows_x_channels", True))}
        results["group_norm_stats"].append(measure(
            "group_norm_stats", desc,
            lambda x: kg.group_norm_stats(x, 32, rows),
            lambda x: kg.group_norm_stats_plain(x, 32, rows),
            lambda dt: (x32.to(dt),), relative=True, ops=3 * x32.numel(),
            others={name: (lambda x, plan=plan: kg.group_norm_stats(x, 32, rows, plan=plan))
                    for name, plan in forced.items()},
            variants=kg.stats_plan_launches))

        def apply_inputs(dt):
            x = x32.to(dt)
            return (x, kg.group_norm_stats_plain(x, 32, rows), *affine(shape[1], dt))

        results["group_norm_apply"].append(measure(
            "group_norm_apply", desc,
            lambda x, p, w, b: kg.group_norm_apply(x, p, w, b, rows, 1e-6, True),
            lambda x, p, w, b: kg.group_norm_apply_plain(x, p, w, b, 1e-6, True),
            apply_inputs, ops=NORM_OPS * x32.numel(),
            variants=kg.apply_plan_launches))
        del x32

    for shape in layer_norm_shapes(cfg):
        row = measure(
            "fused_layer_norm", {"x": list(shape)},
            lambda x, w, b: kl.fused_layer_norm(x, w, b, 1e-5),
            lambda x, w, b: kl.fused_layer_norm_plain(x, w, b, 1e-5),
            lambda dt: (randn(shape, dt), *affine(shape[-1], dt)),
            ops=NORM_OPS * math.prod(shape),
            library=lambda x, w, b: F.layer_norm(x, x.shape[-1:], w, b, 1e-5),
            variants=kl.plan_launches)
        if row["bf16_ms"] > row["library_ms"] * (1 + LIBRARY_SPREAD):
            raise AssertionError(f"fused_layer_norm {shape} bf16 {row['bf16_ms']:.4f} ms is "
                                 f"slower than F.layer_norm {row['library_ms']:.4f} ms")
        results["fused_layer_norm"].append(row)
    return results


# ------------------------------------------------- launches the plans imply


def has_control(cfg):
    """Whether the family's evaluation runs a ControlNet (SD-1.5, SD-2.1;
    not SDXL base)."""
    return hasattr(cfg, "controlnet")


def text_length(cfg):
    """Tokens of one prompt window: 77."""
    return (cfg.clip if hasattr(cfg, "clip") else cfg.clip_l).max_length


def _transformer_sites(cfg, lat, n_controlnets=1):
    """(channels, latent side) of every transformer block one DDIM step runs:
    the UNet's input, middle and output blocks and, with a ControlNet (or
    n_controlnets of them), their input and middle blocks."""
    from stablediffusioneo_tpu_torch.models.unet import decoder_plan, encoder_plan

    ucfg = cfg.unet
    nets = 1 + n_controlnets if has_control(cfg) else 1
    levels = len(ucfg.channel_mult)
    mid = (ucfg.model_channels * ucfg.channel_mult[-1], lat // 2 ** (levels - 1))
    sites = []
    for plan, copies in ((encoder_plan(ucfg), nets), (decoder_plan(ucfg), 1)):
        for d in plan:
            if d["attn"]:
                sites += [(d["cout"], lat // d["ds"])] * (copies * d["depth"])
    return sites + [mid] * (nets * ucfg.depth_for(levels - 1))


def attention_sites(cfg, res, batch=2, ctx_len=None, tome_ratio=0.0, n_controlnets=1):
    """Every multi-head attention call of one evaluation of the nets on the
    CFG batch, as (q shape (B, Tq, C), key length, heads): each transformer
    block runs a self- (S = Tq) and a cross-attention (S = the context
    length: 77, or a long prompt's windows x 77). tome_ratio > 0: a
    self-attention of at least tome_min_tokens tokens runs on the tokens
    left after merging (ops/tome.py:merge_count)."""
    from stablediffusioneo_tpu_torch.ops.tome import merge_count

    ucfg = cfg.unet
    sites = []
    for c, side in _transformer_sites(cfg, res // cfg.vae.downsample_factor,
                                      n_controlnets):
        n, heads = side * side, cfg.unet.heads_for(c)
        kept = n
        if tome_ratio and n >= ucfg.tome_min_tokens:
            kept = n - merge_count(side, side, tome_ratio, ucfg.tome_sx, ucfg.tome_sy)
        sites += [((batch, kept, c), kept, heads),
                  ((batch, n, c), ctx_len or text_length(cfg), heads)]
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


def expected_launches(cfg, res, dtype=torch.bfloat16, ctx_len=None, tome_ratio=0.0,
                      n_controlnets=1):
    """Attention launches of one evaluation of the nets by kernel entry, and
    split launches of one decode or encode (the VAE mid-block attends once at
    latent resolution)."""
    from stablediffusioneo_tpu_torch.ops.dispatch import ATTN_MIN_TQ

    step = {"fused_attention_packed": 0, "fused_attention_packed_stream": 0}
    for q_shape, s, _ in attention_sites(cfg, res, ctx_len=ctx_len, tome_ratio=tome_ratio,
                                         n_controlnets=n_controlnets):
        route = attention_route(q_shape, s, dtype)
        if route:
            step[route] += 1
    lat = res // cfg.vae.downsample_factor
    return step, int(lat * lat >= ATTN_MIN_TQ)


def family_configs():
    """The SD-2.1 and SDXL-base configurations of the "sd21 768" and "sdxl
    1024" runs, bf16."""
    from stablediffusioneo_tpu_torch.config import sd21_pipeline
    from stablediffusioneo_tpu_torch.models.sdxl import SDXLConfig

    return sd21_pipeline(dtype="bfloat16"), SDXLConfig()


def kernel_passes(cfg):
    """(name, configuration, resolution, context length, ToMe ratio) of each
    pass whose shapes the kernel phase takes: the SD-1.5 (cfg) 512x512
    request, its 1024x1024 hires pass, its long-prompt windows (S = 154,
    231) and token merging (S = 2048 at TOME_RATIO), then the SD-2.1 768x768
    and SDXL 1024x1024 requests."""
    sd21, sdxl = family_configs()
    window = text_length(cfg)
    return ([("sd15 512", cfg, RES, None, 0.0), ("sd15 hires 1024", cfg, HIRES_RES, None, 0.0)]
            + [(f"sd15 512, {n} windows", cfg, RES, n * window, 0.0) for n in (2, 3)]
            + [("sd15 512, tome 0.5", cfg, RES, None, TOME_RATIO),
               ("sd21 768", sd21, SD21_RES, None, 0.0),
               ("sdxl 1024", sdxl, SDXL_RES, None, 0.0)])


def attention_rows(cfg, paths=False):
    """(entry, q shape, key length, heads) of every distinct kernel-gated
    attention call of the kernel_passes (the VAE decode's mid-block of each
    resolution among them); with paths=True also {row: names of the passes
    that give it}."""
    rows = {}
    for name, pcfg, res, ctx_len, tome_ratio in kernel_passes(cfg):
        for q_shape, s, heads in attention_sites(pcfg, res, ctx_len=ctx_len,
                                                 tome_ratio=tome_ratio):
            route = attention_route(q_shape, s, torch.bfloat16)
            if route:
                rows.setdefault((route, q_shape, s, heads), []).append(name)
        lat = res // pcfg.vae.downsample_factor
        row = ("fused_attention", (1, 1, lat * lat, pcfg.vae.ch * pcfg.vae.ch_mult[-1]),
               lat * lat, 1)
        rows.setdefault(row, []).append(name)
    rows = {row: sorted(set(names), key=names.index) for row, names in rows.items()}
    return rows if paths else list(rows)


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


def _vae_encoder_norms(vcfg, res, batch):
    """Norm calls of one VAE encode of a res x res image, in module order:
    two a ResnetBlock, the mid-block's attention norm (no SiLU), norm_out."""
    def gn(c, side, swish=True):
        return ("gn", (batch, c, side, side), swish, vcfg.groups)

    sites, bi, side = [], vcfg.ch, res
    for i, mult in enumerate(vcfg.ch_mult):
        for _ in range(vcfg.num_res_blocks):
            sites += [gn(bi, side), gn(vcfg.ch * mult, side)]
            bi = vcfg.ch * mult
        if i != len(vcfg.ch_mult) - 1:
            side //= 2
    return sites + [gn(bi, side), gn(bi, side), gn(bi, side, False), gn(bi, side),
                    gn(bi, side), gn(bi, side)]


def _tower_norms(clip, pooled=False):
    """LayerNorm calls of one text-tower forward on the cond and uncond
    prompts: two a block it runs (all for "last" or with the pooled output,
    else all but the last) and the final LN where its output takes it."""
    blocks = clip.num_layers if clip.layer == "last" or pooled else clip.num_layers - 1
    finals = int(clip.layer != "penultimate_raw") + int(pooled)
    return [("ln", (2, clip.max_length, clip.hidden_size), False, 0)] * (2 * blocks + finals)


def norm_sites(cfg, res, samples=1):
    """Every GroupNorm and LayerNorm call of a request, from the plans, as
    (kind, shape, swish, groups): "step" = one DDIM step (UNet and, where
    the family has one, ControlNet on the CFG batch), "decode" = the VAE
    decode, "prompt" = the text towers on the cond and uncond prompts (SDXL:
    CLIP-L, then bigG with its pooled output)."""
    lat = res // cfg.vae.downsample_factor
    step = _unet_norms(cfg.unet, lat, 2 * samples, True)
    if has_control(cfg):
        step += _unet_norms(cfg.controlnet.unet, lat, 2 * samples, False)
    prompt = (_tower_norms(cfg.clip) if hasattr(cfg, "clip")
              else _tower_norms(cfg.clip_l) + _tower_norms(cfg.clip_g, pooled=True))
    return {"step": step, "decode": _vae_norms(cfg.vae, lat, samples), "prompt": prompt}


def layer_norm_shapes(cfg):
    """The distinct kernel-gated LayerNorm shapes of a step of the 512x512
    request, then those of the 1024x1024 hires pass and of the SDXL
    1024x1024 request (the same widths: 640 and 1280 at 4096 and 1024
    tokens)."""
    shapes = []
    for pcfg, res in ((cfg, RES), (cfg, HIRES_RES), (family_configs()[1], SDXL_RES)):
        for site in norm_sites(pcfg, res)["step"]:
            if site[0] == "ln" and gated(site, torch.bfloat16) and site[1] not in shapes:
                shapes.append(site[1])
    return shapes


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


def sampler_evals(sampler, steps):
    """Evaluations of the nets (ControlNet + UNet on the CFG batch) that a
    sampler's loop of `steps` steps runs: PLMS one more, Heun 2N - 1 (its
    last step is a plain Euler step), the others one a step."""
    from stablediffusioneo_tpu_torch.runtime.engine import _canon_sampler

    return {"plms": steps + 1, "heun": 2 * steps - 1}.get(_canon_sampler(sampler), steps)


def run_res(config):
    """The resolution a request of this run is made at (the hires run's
    first pass)."""
    return RUNS[config].get("res", RES)


def run_evals(config):
    """Evaluations of the nets a request of this run takes."""
    spec = RUNS[config]
    return sampler_evals(spec.get("process", {}).get("sampler", "ddim"),
                         IMG2IMG_T_ENC if spec.get("init") else STEPS)


def expected_layer_norm_plans(cfg, config):
    """LayerNorm launches over the two timed requests of main_path, by the
    plan each gated site's shape gives (bf16 rows and weights, aligned)."""
    from stablediffusioneo_tpu_torch.ops.kernels.layernorm import layer_norm_plan

    want = {}
    if not RUNS[config].get("norms"):
        return want
    for part, times in (("step", run_evals(config)), ("decode", 1), ("prompt", 1)):
        for site in norm_sites(cfg, run_res(config))[part]:
            if site[0] == "ln" and gated(site, torch.bfloat16):
                plan = layer_norm_plan(math.prod(site[1][:-1]), site[1][-1],
                                       torch.bfloat16, torch.bfloat16)
                want[plan] = want.get(plan, 0) + 2 * times
    return want


def run_ctx_len(cfg, config):
    return RUNS[config].get("windows", 1) * text_length(cfg)


def expected_request_launches(cfg, config):
    """Every kernel's launches over the two timed requests of main_path, and
    the attention launches by key length."""
    spec, steps = RUNS[config], run_evals(config)
    ctx_len = run_ctx_len(cfg, config)
    tome_ratio = spec.get("process", {}).get("tome_ratio", 0.0)
    want = dict.fromkeys(KERNELS, 0)
    passes = [(run_res(config), steps)] + ([(HIRES_RES, HIRES_T_ENC)] if config == "hires"
                                           else [])
    by_key = {}
    for res, n_steps in passes:  # the hires base pass is not decoded
        step, per_decode = expected_launches(cfg, res, ctx_len=ctx_len, tome_ratio=tome_ratio)
        for name, n in step.items():
            want[name] += n_steps * n
        for q_shape, s, _ in attention_sites(cfg, res, ctx_len=ctx_len, tome_ratio=tome_ratio):
            if attention_route(q_shape, s, torch.bfloat16):
                by_key[s] = by_key.get(s, 0) + 2 * n_steps
    encodes = int(bool(spec.get("init") or spec.get("inpaint")))
    want["fused_attention"] = per_decode * (1 + encodes)  # the encoder's mid-block too
    if spec.get("norms"):
        sites = norm_sites(cfg, run_res(config))
        step, decode, prompt = (norm_launches(sites[k], torch.bfloat16)
                                for k in ("step", "decode", "prompt"))
        encode = norm_launches(_vae_encoder_norms(cfg.vae, RES, 1), torch.bfloat16)
        for name in step:
            want[name] = steps * step[name] + decode[name] + prompt[name] \
                + encodes * encode[name]
    if spec.get("int8"):
        want["quantized_matmul"] = steps * len(quant_gated(quant_sites(cfg, RES)))
    lat = passes[-1][0] // cfg.vae.downsample_factor  # the decoded pass
    by_key[lat * lat] = by_key.get(lat * lat, 0) + 2 * want["fused_attention"]
    return {name: 2 * n for name, n in want.items()}, by_key


# ------------------------------------------------------ model-level phases


def build_model(cfg, seed, n_controlnets=1):
    from stablediffusioneo_tpu_torch.models.cldm import ControlLDM, init_weights

    with torch.device("meta"):
        model = ControlLDM(cfg, n_controlnets)
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


def engine_replay_ms(rt):
    """{engine name: ms} of one replay of each captured engine of a runtime on
    its static buffers, by CUDA events around the replay: device time with
    no host launch cost, and no profiler."""
    out = {}
    for eng in rt._engines.values():
        if not eng.compiled:
            continue
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        eng.replay()
        end.record()
        torch.cuda.synchronize()
        out[eng.name] = start.elapsed_time(end)
    return out


def smoke_image():
    rng = np.random.default_rng(0)
    img = np.zeros((RES, RES, 3), np.uint8)
    img[96:416, 128:384] = 200  # a box with edges, plus texture
    return (img + rng.integers(0, 40, img.shape)).astype(np.uint8)


def smoke_source():
    """The img2img and inpaint source: a colour gradient with a bright disc."""
    yy, xx = np.mgrid[0:RES, 0:RES] / RES
    img = np.stack([200 * xx, 160 * yy, 120 * (1 - xx)], axis=-1)
    img[(xx - 0.6) ** 2 + (yy - 0.4) ** 2 < 0.04] = 240
    return img.astype(np.uint8)


def smoke_mask():
    """A rectangular inpaint mask: 255 where the request regenerates."""
    mask = np.zeros((RES, RES), np.uint8)
    mask[128:384, 160:448] = 255
    return mask


def run_kwargs(config):
    """process() keyword arguments of one main-path run, images included."""
    spec = RUNS[config]
    kw = dict(num_samples=1, image_resolution=run_res(config), ddim_steps=STEPS,
              scale=SCALE, eta=0.0, strength=1.0, **spec.get("process", {}))
    if spec.get("init"):
        kw.update(init_image=smoke_source(), denoise_strength=IMG2IMG_STRENGTH)
    if spec.get("inpaint"):
        kw.update(inpaint_image=smoke_source(), inpaint_mask=smoke_mask())
    return kw


def main_path(model, cfg, config, tokenizer=stand_in_tokenizer):
    """One warm-up request (it captures the engines), two timed replayed
    requests, one eager request and one traced replayed request of one
    configuration of RUNS: "default", "fused norms", "int8" (512x512),
    "hires" (512 -> 1024), img2img, inpainting and the prompt front end."""
    from stablediffusioneo_tpu_torch.ops import dispatch
    from stablediffusioneo_tpu_torch.ops.kernels.attention import (
        key_length_launches,
        variant_launches,
    )
    from stablediffusioneo_tpu_torch.ops.kernels.groupnorm import apply_plan_launches
    from stablediffusioneo_tpu_torch.ops.kernels.groupnorm import plan_launches as gn_plans
    from stablediffusioneo_tpu_torch.ops.kernels.layernorm import plan_launches as ln_plans
    from stablediffusioneo_tpu_torch.ops.kernels.quant import plan_launches as qmm_plans
    from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline

    spec = RUNS[config]
    fused, int8 = bool(spec.get("norms")), bool(spec.get("int8"))
    dispatch.set_kernels(groupnorm=fused, layernorm=fused, int8_linear=int8)
    pipe = Canny2ImagePipeline(model, tokenizer, cfg, device="cuda",
                               quantize_linears=int8)
    rt = pipe.runtime
    if not rt.capturing:
        raise AssertionError("the runtime does not capture its engines on the card")
    img = smoke_image()
    kw = run_kwargs(config)
    prompt = spec.get("prompt", PROMPT)
    res = HIRES_RES if config == "hires" else run_res(config)
    t0 = time.perf_counter()
    pipe.process(img, prompt, seed=0, **kw)
    engines = {e.name: e.get_engine_infor() for e in rt._engines.values()}
    print(f"main path ({config}) warm-up request, capturing {len(engines)} engines: "
          f"{time.perf_counter() - t0:.3f} s, of which captures "
          f"{sum(i['compile_seconds'] for i in engines.values()):.3f} s\n"
          + rt.report(), flush=True)
    if not all(i["compiled"] for i in engines.values()):
        raise AssertionError(f"an engine was not captured: {engines}")
    torch.cuda.synchronize()
    dispatch.reset_launches()
    for counter in (variant_launches, gn_plans, qmm_plans, ln_plans, apply_plan_launches,
                    key_length_launches):
        counter.clear()
    images, latencies = [], []
    for seed in (1, 2):
        t0 = time.perf_counter()
        out = pipe.process(img, prompt, seed=seed, **kw)
        latencies.append(time.perf_counter() - t0)
        z = pipe.last_latents
        if not (torch.isfinite(z).all() and z.shape == (1, res // 8, res // 8, 4)):
            raise AssertionError(f"final latents are not finite or misshapen: {z.shape}")
        if not (out[1].shape == (res, res, 3) and out[1].dtype == np.uint8
                and out[0].shape == (res, res, 3)):
            raise AssertionError(f"image {out[1].shape} {out[1].dtype}, map {out[0].shape}")
        images.append(out[1])
        print(f"main path ({config}) replayed request seed={seed}: {latencies[-1]:.4f} s "
              f"({pipe.last_timings})", flush=True)
    launches = dict(dispatch.launches)
    plans = [dict(c) for c in (variant_launches, qmm_plans, gn_plans, ln_plans,
                               apply_plan_launches)]
    key_lengths = {s: n for s, n in key_length_launches.items() if n}
    if len(rt._engines) != len(engines):
        raise AssertionError("a timed request built another engine: " + rt.report())
    # the eager loop on the first request's seed: the same kernels in the same
    # order, launched from the host one by one
    rt.graphs = False
    t0 = time.perf_counter()
    eager = pipe.process(img, prompt, seed=1, **kw)
    eager_latency = time.perf_counter() - t0
    rt.graphs = None
    differ = int((eager[1] != images[0]).sum())
    print(f"main path ({config}) eager request seed=1: {eager_latency:.4f} s "
          f"({pipe.last_timings}); bytes that differ from the replayed image: {differ} "
          f"of {images[0].size}", flush=True)
    if differ:
        raise AssertionError(f"the replayed image ({config}) differs from the eager one in "
                             f"{differ} bytes")
    want, want_keys = expected_request_launches(cfg, config)
    want_keys = {s: n for s, n in want_keys.items() if n}
    print(f"main path ({config}) kernel launches over the 2 replayed requests: {launches} "
          f"(expected from the plans and gates: {want}); attention launches by key "
          f"length: {key_lengths} (expected {want_keys})", flush=True)
    if launches != want or key_lengths != want_keys:
        raise AssertionError(f"launch counts ({config}) {launches}, {key_lengths} != "
                             f"{want}, {want_keys}")
    variants, qmm, gn, ln, apply_plans = plans
    # every attention launch of the bf16 main path is a tensor-core variant
    want_variants = {"wgmma": want["fused_attention_packed"]
                     + want["fused_attention_packed_stream"],
                     "wgmma_split": want["fused_attention"]}
    print(f"main path ({config}) attention launches by variant: {variants}", flush=True)
    if {k: v for k, v in variants.items() if v} != \
            {k: v for k, v in want_variants.items() if v}:
        raise AssertionError(f"attention variants ({config}) {variants} != {want_variants}")
    # every int8 matmul launch of the bf16 main path is the wgmma variant
    by_plan = {str(plan): n for plan, n in qmm.items()}
    if by_plan or gn or ln:
        print(f"main path ({config}) int8 matmul launches by plan: {by_plan}; "
              f"one-pass GroupNorm launches by plan: "
              f"{ {str(plan): n for plan, n in gn.items()} }; "
              f"LayerNorm launches by plan: "
              f"{ {str(plan): n for plan, n in ln.items()} }", flush=True)
    if (sum(n for plan, n in qmm.items() if plan.variant == "wgmma")
            != want["quantized_matmul"] or sum(qmm.values()) != want["quantized_matmul"]
            or sum(gn.values()) != want["fused_group_norm"]
            or sum(ln.values()) != want["fused_layer_norm"]
            or ln != expected_layer_norm_plans(cfg, config)
            or sum(apply_plans.values()) != want["group_norm_apply"]):
        raise AssertionError(f"plans ({config}) {by_plan}, {gn}, {ln}, "
                             f"{apply_plans} do not add up to {want}")
    if np.array_equal(images[0], images[1]):
        raise AssertionError("two seeds gave the same image")
    print(f"image stats ({config}): mean {images[0].mean():.2f} std "
          f"{images[0].std():.2f}; seeds differ in "
          f"{(images[0] != images[1]).mean():.3f} of values", flush=True)
    graph_nodes = sum(i["device_ops"] for i in engines.values())
    trace = traced_request(lambda: pipe.process(img, prompt, seed=3, **kw))
    if trace is None:
        traced = None
        print(f"main path ({config}) traced replayed request: not measured (the profiler "
              "gave no device events)", flush=True)
    else:
        ms, parts, n_ops = trace
        traced = {"device_ms": ms, "device_ops": n_ops,
                  **{f"{family}_ms": part for family, part in parts.items()}}
        print(f"main path ({config}) traced replayed request: device time {ms:.1f} ms in "
              f"{n_ops} device operations (the engines' graphs hold {graph_nodes} nodes: "
              f"the profiler {'sees' if n_ops >= graph_nodes else 'does not see all'} "
              "graph nodes); this package's kernels, ms: "
              + ", ".join(f"{family} {part:.1f}" for family, part in parts.items()),
              flush=True)
    replays = engine_replay_ms(rt)
    print(f"main path ({config}) one replay of each engine by CUDA events, ms: "
          + ", ".join(f"{n} {ms:.1f}" for n, ms in replays.items()), flush=True)
    pipe.runtime.release()
    dispatch.set_kernels(groupnorm=False, layernorm=False, int8_linear=False)
    return {"launches": launches, "key_lengths": key_lengths, "latencies": latencies,
            "eager_latency": eager_latency, "image": images[0], "traced": traced,
            "engines": engines, "replay_ms": replays}


def build_sdxl(seed):
    """SDXL base at full width (2.57 B UNet parameters), its weights drawn on
    the card from a seed (models/cldm.py:init_weights), in bf16."""
    from stablediffusioneo_tpu_torch.models.cldm import init_weights
    from stablediffusioneo_tpu_torch.models.sdxl import SDXL

    with torch.device("meta"):
        model = SDXL(family_configs()[1])
    model.to_empty(device="cuda")
    init_weights(model, torch.Generator(device="cuda").manual_seed(seed))
    return model.to(torch.bfloat16).eval().requires_grad_(False)


def sdxl_ids(tokenizer):
    """Both towers' ids (sdxl_tokenize) of the prompt and the empty prompt,
    on the card."""
    from stablediffusioneo_tpu_torch.models.sdxl import sdxl_tokenize

    return [torch.as_tensor(a, dtype=torch.long, device="cuda")
            for a in sdxl_tokenize(tokenizer, [PROMPT, ""])]


def sdxl_request(model, eng, ids, seed):
    """One SDXL request: both towers' conditioning of the prompt and the
    empty prompt (eagerly, outside the engine, as the JAX bench), then the
    sample+decode engine on x_T drawn from the seed. Returns the image on the
    host and the latents."""
    from stablediffusioneo_tpu_torch.models.sdxl import sdxl_conditioning

    with torch.no_grad():
        ctx, y = sdxl_conditioning(model, ids[0], ids[1], (SDXL_RES, SDXL_RES))
    lat = SDXL_RES // model.cfg.vae.downsample_factor
    x = torch.randn((1, lat, lat, 4), generator=torch.Generator(device="cuda").manual_seed(seed),
                    device="cuda").to(torch.bfloat16)
    img, z = eng(x, ctx[:1], ctx[1:], y[:1], y[1:],
                 torch.full((1,), SDXL_SCALE, device="cuda"))
    return img[0].cpu().numpy(), z


def sdxl_path(model, config, tokenizer):
    """SDXL base txt2img at 1024x1024, 20 DDIM steps, scale 5, batch 1, as a
    main path: the text towers timed apart; the sample+decode engine captured
    (a warm-up request), two timed replayed requests, one eager request
    (capture=False) with the first one's seed whose image must equal the
    replayed one in bytes, one traced replayed request; launches held to the
    plans (140 packed attention launches an evaluation, one split a
    decode), every attention launch on a tensor-core variant."""
    from stablediffusioneo_tpu_torch.models.sdxl import sdxl_conditioning
    from stablediffusioneo_tpu_torch.ops import dispatch
    from stablediffusioneo_tpu_torch.ops.kernels.attention import (
        key_length_launches,
        variant_launches,
    )
    from stablediffusioneo_tpu_torch.ops.kernels.groupnorm import plan_launches as gn_plans
    from stablediffusioneo_tpu_torch.ops.kernels.layernorm import plan_launches as ln_plans
    from stablediffusioneo_tpu_torch.runtime.engine import sdxl_sample_decode_engine

    cfg = model.cfg
    fused = bool(RUNS[config].get("norms"))
    dispatch.set_kernels(groupnorm=fused, layernorm=fused)
    ids = sdxl_ids(tokenizer)
    with torch.no_grad():
        towers_ms = device_ms(lambda: sdxl_conditioning(model, ids[0], ids[1],
                                                        (SDXL_RES, SDXL_RES)), calls=5)
    print(f"sdxl ({config}) text towers (CLIP-L penultimate + bigG with its pooled "
          f"output, cond and uncond as one batch of 2): device {towers_ms:.3f} ms",
          flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = sdxl_sample_decode_engine(model, STEPS, 1, SDXL_RES, SDXL_RES)
    sdxl_request(model, eng, ids, 0)
    warm_s = time.perf_counter() - t0
    info = eng.get_engine_infor()
    peak = torch.cuda.max_memory_allocated()
    print(f"sdxl ({config}) warm-up request: {warm_s:.3f} s, of which the capture "
          f"{info['compile_seconds']:.3f} s; graph nodes {info['device_ops']}, graph pool "
          f"{info['memory']['pool_bytes']} bytes, peak memory allocated {peak} bytes",
          flush=True)
    if not eng.compiled:
        raise AssertionError("the SDXL engine was not captured")
    torch.cuda.synchronize()
    dispatch.reset_launches()
    for counter in (variant_launches, gn_plans, ln_plans, key_length_launches):
        counter.clear()
    images, latencies = [], []
    for seed in (1, 2):
        t0 = time.perf_counter()
        img, z = sdxl_request(model, eng, ids, seed)
        latencies.append(time.perf_counter() - t0)
        lat = SDXL_RES // cfg.vae.downsample_factor
        if not (torch.isfinite(z).all() and z.shape == (1, lat, lat, 4)
                and img.shape == (SDXL_RES, SDXL_RES, 3) and img.dtype == np.uint8):
            raise AssertionError(f"sdxl latents {tuple(z.shape)} not finite or image "
                                 f"{img.shape} {img.dtype}")
        images.append(img)
        print(f"sdxl ({config}) replayed request seed={seed}: {latencies[-1]:.4f} s; max |z| "
              f"{z.abs().max().item():.3f}", flush=True)
    launches = dict(dispatch.launches)
    variants, gn, ln = dict(variant_launches), dict(gn_plans), dict(ln_plans)
    key_lengths = {s: n for s, n in key_length_launches.items() if n}
    eager_eng = sdxl_sample_decode_engine(model, STEPS, 1, SDXL_RES, SDXL_RES, capture=False)
    t0 = time.perf_counter()
    eager = sdxl_request(model, eager_eng, ids, 1)[0]
    eager_latency = time.perf_counter() - t0
    differ = int((eager != images[0]).sum())
    print(f"sdxl ({config}) eager request seed=1: {eager_latency:.4f} s; bytes that differ "
          f"from the replayed image: {differ} of {eager.size}", flush=True)
    if differ:
        raise AssertionError(f"the replayed SDXL image ({config}) differs from the eager "
                             f"one in {differ} bytes")
    want, want_keys = expected_request_launches(cfg, config)
    want_keys = {s: n for s, n in want_keys.items() if n}
    print(f"sdxl ({config}) kernel launches over the 2 replayed requests: {launches} "
          f"(expected {want}); by key length {key_lengths} (expected {want_keys}); by "
          f"variant {variants}; GroupNorm plans { {str(p): n for p, n in gn.items()} }; "
          f"LayerNorm plans { {str(p): n for p, n in ln.items()} }", flush=True)
    want_variants = {"wgmma": want["fused_attention_packed"],
                     "wgmma_split": want["fused_attention"]}
    if (launches != want or key_lengths != want_keys
            or {k: v for k, v in variants.items() if v}
            != {k: v for k, v in want_variants.items() if v}
            or sum(gn.values()) != want["fused_group_norm"]
            or ln != expected_layer_norm_plans(cfg, config)):
        raise AssertionError(f"sdxl launches ({config}) {launches}, {key_lengths}, "
                             f"{variants}, {gn}, {ln} != {want}, {want_keys}")
    if np.array_equal(images[0], images[1]):
        raise AssertionError("two seeds gave the same SDXL image")
    print(f"sdxl image stats ({config}): mean {images[0].mean():.2f} std "
          f"{images[0].std():.2f}", flush=True)
    trace = traced_request(lambda: sdxl_request(model, eng, ids, 3))
    traced = None
    if trace is None:
        print(f"sdxl ({config}) traced replayed request: not measured (the profiler gave "
              "no device events)", flush=True)
    else:
        ms, parts, n_ops = trace
        traced = {"device_ms": ms, "device_ops": n_ops,
                  **{f"{family}_ms": part for family, part in parts.items()}}
        print(f"sdxl ({config}) traced replayed request (text towers included): device "
              f"time {ms:.1f} ms in {n_ops} device operations; this package's kernels, ms: "
              + ", ".join(f"{family} {part:.1f}" for family, part in parts.items()),
              flush=True)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    eng.replay()
    end.record()
    torch.cuda.synchronize()
    replays = {eng.name: start.elapsed_time(end)}
    print(f"sdxl ({config}) one replay of the engine by CUDA events: {replays} ms", flush=True)
    dispatch.set_kernels(groupnorm=False, layernorm=False)
    del eng, eager_eng
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "key_lengths": key_lengths, "latencies": latencies,
            "eager_latency": eager_latency, "image": images[0], "traced": traced,
            "engines": {f"sdxl+decode_{STEPS}x1x{SDXL_RES}x{SDXL_RES}": info},
            "replay_ms": replays, "text_towers_ms": towers_ms, "peak_bytes": peak,
            "warm_s": warm_s}


def sdxl_checkpoint_phase(model, tokenizer, want_image):
    """The seeded SDXL's state dict in sgm's layout (bf16; with the two
    OpenCLIP leftovers a real file carries, 2,515 keys) written with
    torch.save to a temporary directory and read back by load_sdxl_pipeline
    onto the card: free bytes there first, seconds and bytes, every key
    consumed or named, none orphaned; a request on the loaded model gives
    `want_image` (the seeded model's) in bytes. A full disk fails the run."""
    from stablediffusioneo_tpu_torch.checkpoint import load_sdxl_pipeline
    from stablediffusioneo_tpu_torch.runtime.engine import sdxl_sample_decode_engine

    sd = dict(model.state_dict())
    t = model.cfg.clip_g.max_length
    sd["conditioner.embedders.1.model.attn_mask"] = torch.full(
        (t, t), float("-inf"), device="cuda").triu(1)
    sd["conditioner.embedders.1.model.logit_scale"] = torch.tensor(4.6052, device="cuda")
    with tempfile.TemporaryDirectory() as directory:
        free = shutil.disk_usage(directory).free
        print(f"sdxl checkpoint: {free} bytes free where the file is written", flush=True)
        path = os.path.join(directory, "sd_xl_base_seeded.pth")
        t0 = time.perf_counter()
        torch.save(sd, path)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        loaded = load_sdxl_pipeline(path, model.cfg, device="cuda",
                                    dtype=next(model.parameters()).dtype)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    report = loaded.load_report
    devices = {t.device.type for t in loaded.state_dict().values()}
    print(f"sdxl checkpoint: {len(sd)} keys, {size} bytes written in {save_s:.2f} s, loaded "
          f"onto the card in {load_s:.2f} s; consumed {len(report.consumed)}, ignored "
          f"{sorted(report.ignored)}, orphans {len(report.orphans)}", flush=True)
    held = len(loaded.state_dict())  # 2,513 at full width: sdxl_base less its 2 leftovers
    if not (len(sd) == held + 2 and len(report.consumed) == held and len(report.ignored) == 2
            and report.complete and devices == {"cuda"}):
        raise AssertionError(f"sdxl checkpoint load: {len(report.consumed)} consumed, "
                             f"{report.problems()}, devices {devices}")
    del sd
    eng = sdxl_sample_decode_engine(loaded, STEPS, 1, SDXL_RES, SDXL_RES)
    out = sdxl_request(loaded, eng, sdxl_ids(tokenizer), 1)[0]
    differ = int((out != want_image).sum())
    print(f"sdxl checkpoint: the loaded model's request seed=1 differs from the seeded "
          f"model's image in {differ} bytes", flush=True)
    if differ:
        raise AssertionError(f"the loaded SDXL gives another image ({differ} bytes)")
    del eng, loaded
    gc.collect()
    torch.cuda.empty_cache()
    return {"bytes": size, "save_s": save_s, "load_s": load_s, "free_bytes": free}


def loop_variants(model, cfg, steps=4):
    """Three short requests at full width through captured engines: the
    default loop, the encoder-cached loop and the rescaled guidance. The
    variants' latents are finite and their images differ from the default's."""
    from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline

    pipe = Canny2ImagePipeline(model, stand_in_tokenizer, cfg, device="cuda")
    img = smoke_image()
    kw = dict(num_samples=1, image_resolution=RES, ddim_steps=steps, scale=SCALE,
              eta=0.0, seed=1)
    base = pipe.process(img, PROMPT, **kw)[1]
    for variant in ({"encoder_cache_interval": 2}, {"cfg_rescale": 0.7}):
        out = pipe.process(img, PROMPT, **kw, **variant)[1]
        z = pipe.last_latents
        apart = float((out != base).mean())
        print(f"loop variant {variant}: {steps} steps, {pipe.last_timings['total_ms']:.0f} "
              f"ms with its capture; latents finite {bool(torch.isfinite(z).all())}, max |z| "
              f"{z.abs().max().item():.3f}; image differs from the default's in "
              f"{apart:.3f} of values", flush=True)
        if not (torch.isfinite(z).all() and out.shape == (RES, RES, 3) and apart > 0):
            raise AssertionError(f"loop variant {variant} failed")
    print(pipe.runtime.report(), flush=True)
    if not all(e.compiled for e in pipe.runtime._engines.values()):
        raise AssertionError("a loop variant's engine was not captured")
    pipe.runtime.release()


def sampler_variants(model, cfg, steps=4):
    """Every sampler name that no main-path run takes (SAMPLER_VARIANTS), at
    full width through captured engines, after a DDIM request of as many
    steps: for each, a request that captures its engine, one replayed request
    and one eager request (graphs=False) with the same seed. The replayed
    latents are finite, its image equals the eager one in bytes and differs
    from DDIM's, and its attention launches are its evaluations' (packed)
    and one decode's (split). Returns {sampler: replayed request seconds}."""
    from stablediffusioneo_tpu_torch.ops import dispatch
    from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline

    pipe = Canny2ImagePipeline(model, stand_in_tokenizer, cfg, device="cuda")
    img = smoke_image()
    kw = dict(num_samples=1, image_resolution=RES, ddim_steps=steps, scale=SCALE,
              eta=0.0, seed=1)
    ddim = pipe.process(img, PROMPT, **kw)[1]
    per_eval, per_decode = expected_launches(cfg, RES)
    latencies = {}
    for sampler in SAMPLER_VARIANTS:
        pipe.process(img, PROMPT, sampler=sampler, **kw)  # captures
        dispatch.reset_launches()
        t0 = time.perf_counter()
        out = pipe.process(img, PROMPT, sampler=sampler, **kw)[1]
        latencies[sampler] = time.perf_counter() - t0
        launches = {k: v for k, v in dispatch.launches.items() if v}
        z = pipe.last_latents
        pipe.runtime.graphs = False
        eager = pipe.process(img, PROMPT, sampler=sampler, **kw)[1]
        pipe.runtime.graphs = None
        evals = sampler_evals(sampler, steps)
        want = {"fused_attention_packed": evals * per_eval["fused_attention_packed"],
                "fused_attention": per_decode}
        differ = int((eager != out).sum())
        apart = float((out != ddim).mean())
        print(f"sampler {sampler}: {steps} steps, {evals} evaluations, replayed request "
              f"{latencies[sampler]:.4f} s; latents finite {bool(torch.isfinite(z).all())}, "
              f"max |z| {z.abs().max().item():.3f}; bytes that differ from the eager image "
              f"{differ}; image differs from DDIM's in {apart:.3f} of values; launches "
              f"{launches} (expected {want})", flush=True)
        if not (torch.isfinite(z).all() and differ == 0 and apart > 0 and launches == want):
            raise AssertionError(f"sampler variant {sampler} failed")
    print(pipe.runtime.report(), flush=True)
    # k[-2]: built while capturing (the eager requests' engines are not)
    if not all(e.compiled for k, e in pipe.runtime._engines.items() if k[-2]):
        raise AssertionError("a sampler variant's engine was not captured")
    pipe.runtime.release()
    return latencies


def bpe_tokenizer(directory):
    """A CLIPTokenizer read by from_pretrained(directory) from a merges file
    written there in the OpenAI format: 48,894 distinct merges of byte-unicode
    character pairs (a seeded choice), so 256 + 256 + 48,894 + 2 = 49,408 ids,
    CLIP's vocabulary size. The real vocabulary is not in the repository."""
    from stablediffusioneo_tpu_torch.models.tokenizer import CLIPTokenizer, bytes_to_unicode

    chars = list(bytes_to_unicode().values())
    pairs = list(itertools.product(chars, chars + [c + "</w>" for c in chars]))
    order = np.random.default_rng(0).permutation(len(pairs))[:48894]
    with open(os.path.join(directory, "bpe_simple_vocab_16e6.txt"), "w",
              encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(" ".join(pairs[i]) for i in order))
    tok = CLIPTokenizer.from_pretrained(directory)
    if len(tok.encoder) != 49408 or tok.eot != 49407:
        raise AssertionError(f"the smoke's vocabulary has {len(tok.encoder)} ids")
    return tok


def checkpoint_phase(model, cfg, want_image):
    """The seeded model's state dict through a file and
    load_controlnet_pipeline onto the card; a default request on the loaded
    model must give `want_image` (the seeded model's) in bytes."""
    from stablediffusioneo_tpu_torch.checkpoint import load_controlnet_pipeline
    from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline

    with tempfile.TemporaryDirectory() as directory:
        path = os.path.join(directory, "control_sd15_seeded.pth")
        t0 = time.perf_counter()
        torch.save(model.state_dict(), path)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        loaded = load_controlnet_pipeline(path, cfg, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    report = loaded.load_report
    dtypes = sorted({str(t.dtype) for t in model.state_dict().values()})
    print(f"checkpoint: {len(model.state_dict())} keys ({', '.join(dtypes)}), "
          f"{size / 1e9:.3f} GB written in {save_s:.2f} s, loaded onto the card in "
          f"{load_s:.2f} s; consumed {len(report.consumed)}, ignored "
          f"{len(report.ignored)}, orphans {len(report.orphans)}", flush=True)
    devices = {t.device.type for t in loaded.state_dict().values()}
    if not (len(report.consumed) == 1470 and report.complete and devices == {"cuda"}):
        raise AssertionError(f"checkpoint load: {len(report.consumed)} keys consumed, "
                             f"{report.problems()}, devices {devices}")
    pipe = Canny2ImagePipeline(loaded, stand_in_tokenizer, cfg, device="cuda")
    out = pipe.process(smoke_image(), PROMPT, seed=1, **run_kwargs("default"))[1]
    differ = int((out != want_image).sum())
    print(f"checkpoint: the loaded model's default request seed=1 differs from the "
          f"seeded model's image in {differ} bytes", flush=True)
    if differ:
        raise AssertionError(f"the loaded checkpoint gives another image ({differ} bytes)")
    pipe.runtime.release()
    return loaded, {"bytes": size, "save_s": save_s, "load_s": load_s}


def encode_phase(model, cfg):
    """encode_image at 512x512 on its own: after a first call that captures,
    two replays of the deterministic engine against the eager one (equal
    bytes, one split attention launch each), and a sampled encode with a
    fixed eps twice (equal bytes)."""
    from stablediffusioneo_tpu_torch.ops import dispatch
    from stablediffusioneo_tpu_torch.runtime.engine import CNSDRuntime

    rt = CNSDRuntime(model, cfg, device="cuda")
    img = torch.from_numpy(smoke_source()[None].astype(np.float32) / 127.5 - 1.0)
    rt.encode_image(img, deterministic=True)  # captures
    dispatch.reset_launches()
    replayed = [rt.encode_image(img, deterministic=True) for _ in range(2)]
    split = dispatch.launches["fused_attention"]
    rt.graphs = False
    eager = rt.encode_image(img, deterministic=True)
    rt.graphs = None
    f = cfg.vae.downsample_factor
    eps = torch.randn((1, RES // f, RES // f, 4), generator=torch.Generator(
        device="cuda").manual_seed(5), device="cuda")
    sampled = [rt.encode_image(img, eps=eps) for _ in range(2)]
    ms = engine_replay_ms(rt)
    print(f"encode_image 512x512: replayed = eager in bytes "
          f"{torch.equal(replayed[1], eager)}; sampled twice equal "
          f"{torch.equal(*sampled)}, equal to the mode {torch.equal(sampled[0], eager)}; "
          f"latents {tuple(eager.shape)} {eager.dtype}, "
          f"max |z| {eager.abs().max().item():.3f}; split attention launches over the 2 "
          f"replays {split}; one replay of each engine, ms: {ms}", flush=True)
    if not (torch.equal(replayed[0], eager) and torch.equal(replayed[1], eager)
            and torch.equal(*sampled) and torch.isfinite(eager).all() and split == 2):
        raise AssertionError("encode_image: replay, eager or sample disagree")
    rt.release()
    return ms


def hackathon_phase(model, cfg, tokenizer):
    """The reference's surface: initialize(), then one request with the 14
    positional arguments and two samples: two images, and no map."""
    from stablediffusioneo_tpu_torch.pipeline.hackathon import hackathon

    h = hackathon(model, tokenizer, cfg, device="cuda")
    t0 = time.perf_counter()
    h.initialize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = h.process(smoke_image(), PROMPT, "best quality, extremely detailed",
                    "lowres, bad anatomy", 2, RES, STEPS, False, 1.0, SCALE, 4, 0.0,
                    100, 200)
    request_s = time.perf_counter() - t0
    print(f"hackathon: initialize() {init_s:.2f} s, one 2-sample request with its "
          f"capture {request_s:.2f} s: {len(out)} images "
          f"{[(o.shape, str(o.dtype)) for o in out]}", flush=True)
    if not (len(out) == 2 and all(o.shape == (RES, RES, 3) and o.dtype == np.uint8
                                  for o in out) and not np.array_equal(out[0], out[1])):
        raise AssertionError("hackathon.process did not return 2 distinct images")
    h.pipe.runtime.release()
    return {"initialize_s": init_s, "request_s": request_s}


def serve_request(i, **kw):
    """Request i of the serving phase, as the JAX bench makes it: a noise
    image (dense Canny edges), one of four prompts, its own seed, scale 7-11,
    strength 0.8-1.1."""
    from stablediffusioneo_tpu_torch.serving import GenRequest

    image = (np.random.default_rng(i).random((RES, RES, 3)) * 255).astype(np.uint8)
    fields = dict(prompt=SERVE_PROMPTS[i % len(SERVE_PROMPTS)], image_resolution=RES,
                  ddim_steps=STEPS, seed=1000 + i, scale=7.0 + (i % 5),
                  strength=0.8 + 0.1 * (i % 4))
    return GenRequest(image=image, **{**fields, **kw})


def pixel_share(a, b):
    """The share of pixels of two uint8 images that differ by more than 1."""
    return float((np.abs(a.astype(np.int16) - b.astype(np.int16)) > 1).mean())


def served(server, pool, ids, timeout=600):
    """Submit requests `ids` from the client threads at once; their images."""
    futures = list(pool.map(lambda i: server.submit(serve_request(i)), ids))
    return [f.result(timeout=timeout)[1] for f in futures]


def in_order(server, seeds, timeout=600):
    """Submit the requests of `seeds` from this thread, one after another (so
    they arrive, and are cut, in this order); their images."""
    futures = [server.submit(serve_request(seed - 1000)) for seed in seeds]
    return [f.result(timeout=timeout)[1] for f in futures]


def serving_phase(model, cfg, card):
    """DiffusionServer at full width (SD-1.5 + ControlNet canny, 512x512, 20
    DDIM steps, bf16, seeded weights), the JAX bench's serving row: buckets
    (1, 4), a 300 ms window, warmup() of both buckets, 4 warm requests, then
    16 timed requests from 8 client threads. Held: at least two batch-4 cuts
    (the in-flight check below replays two of them); launches as the plans
    imply (560 packed + 1 split a batch, whatever its size); the first batch-4
    cut equal in bytes to sample_decode(seeds=) of its four requests called
    directly; 3 batch-4 rows each nearer process() of its own request (batch
    1) than of the two others (the share of pixels off by more than 1 printed
    beside the JAX test's 2% and beside process() against itself with one x_T
    value scaled by 1.01: see SERVE_PIXEL_SHARE); one request in two other
    batch-4 compositions equal in bytes; two batches in flight (the first
    fetch held until the second batch is enqueued) giving each row its bytes;
    a request that needs a new engine, captured while a batch is computed and
    fetched; one POST /generate on localhost answered with a 512x512 PNG; then the
    bit-packed hint engine's image equal in bytes to the uint8 engine's on the
    same Canny map."""
    import base64
    import threading
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    import cv2

    from stablediffusioneo_tpu_torch.ops import dispatch
    from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline
    from stablediffusioneo_tpu_torch.serving import DiffusionServer, make_http_server

    pipe = Canny2ImagePipeline(model, stand_in_tokenizer, cfg, device="cuda")
    rt = pipe.runtime
    server = DiffusionServer(pipe, batch_buckets=SERVE_BUCKETS,
                             max_wait_ms=SERVE_WAIT_MS).start()
    compositions = []  # the seeds of every batch dispatched, in order
    dispatch_batch = server._dispatch_batch

    def recorded(batch):
        compositions.append([p.seed for p in batch])
        dispatch_batch(batch)

    server._dispatch_batch = recorded
    t0 = time.perf_counter()
    server.warmup(resolutions=(RES,), steps=STEPS)
    warm_s = time.perf_counter() - t0
    engines = {name: {"capture_s": e["compile_seconds"],
                      "pool_mb": e["memory"]["pool_bytes"] / 1e6,
                      "device_ops": e["device_ops"]}
               for name, e in server.stats.snapshot()["engines"].items()}
    print(f"serving [{card}]: warmup() captured {len(engines)} engines in {warm_s:.2f} s: "
          + "; ".join(f"{n} {e['capture_s']:.2f} s, pool {e['pool_mb']:.0f} MB"
                      for n, e in engines.items()), flush=True)
    pool = ThreadPoolExecutor(max_workers=SERVE_CLIENTS)
    served(server, pool, range(SERVE_WARM))
    server.drain()
    server.stats.reset()
    compositions.clear()
    n_engines = len(rt._engines)
    dispatch.reset_launches()
    t0 = time.perf_counter()
    images = served(server, pool, range(SERVE_TIMED))
    elapsed = time.perf_counter() - t0
    server.drain()
    launches = {k: v for k, v in dispatch.launches.items() if v}
    st = server.stats.snapshot()
    timed = {seed: img for seed, img in zip(range(1000, 1000 + SERVE_TIMED), images)}
    timed_cuts = [list(batch) for batch in compositions]
    in_b4 = [seed for batch in timed_cuts if len(batch) == 4 for seed in batch]
    per_eval, per_decode = expected_launches(cfg, RES)
    want = {k: v for k, v in (("fused_attention_packed", st["batches"] * STEPS
                                * per_eval["fused_attention_packed"]),
                               ("fused_attention", st["batches"] * per_decode)) if v}
    img_s = SERVE_TIMED / elapsed
    print(f"serving [{card}]: {SERVE_TIMED} requests from {SERVE_CLIENTS} clients in "
          f"{elapsed:.3f} s: {img_s:.4f} img/s; batch_hist {st['batch_hist']}, mean queue "
          f"{st['mean_queue_ms']:.1f} ms, mean batch run {st['mean_batch_run_ms']:.1f} ms; "
          f"compositions {compositions}; launches {launches} (expected {want})", flush=True)
    if not (st["batch_hist"].get(4, 0) >= 2 and launches == want and st["errors"] == 0
            and len(rt._engines) == n_engines):
        raise AssertionError(f"serving: {st}, launches {launches} != {want}, or an engine "
                             "was captured during the timed requests")
    # the first timed batch-4 cut through the runtime directly, without the
    # server (the same host work, one CLIP call, sample_decode with the seeds):
    # the served rows must be equal in bytes
    from stablediffusioneo_tpu_torch.annotators.util import HWC3, resize_image

    first_b4 = next(batch for batch in timed_cuts if len(batch) == 4)
    reqs = [serve_request(seed - 1000) for seed in first_b4]
    hints = [pipe._hint(resize_image(HWC3(r.image), RES), r.low_threshold,
                        r.high_threshold, 1)[1][0] for r in reqs]
    pairs = [stand_in_tokenizer([r.prompt + ", " + r.a_prompt, r.n_prompt]) for r in reqs]
    ctx = rt.encode_prompt(np.concatenate([np.stack([p[0] for p in pairs]),
                                           np.stack([p[1] for p in pairs])]))
    direct = rt.sample_decode(STEPS, None, np.stack(hints), ctx[:4], ctx[4:],
                              seeds=[r.seed for r in reqs],
                              guidance_scale=np.asarray([r.scale for r in reqs], np.float32),
                              strength=np.asarray([r.strength for r in reqs], np.float32)
                              ).cpu().numpy()
    direct_equal = [bool(np.array_equal(direct[i], timed[seed]))
                    for i, seed in enumerate(first_b4)]
    # three batch-4 rows against process() of the same request at batch 1, with
    # the control: that request with one x_T value scaled by 1.01
    refs, offs, control = {}, {}, {}
    for seed in in_b4[:3]:
        r = serve_request(seed - 1000)
        kw = dict(num_samples=1, image_resolution=RES, ddim_steps=STEPS, seed=r.seed,
                  scale=r.scale, strength=r.strength)
        refs[seed] = pipe.process(r.image, r.prompt, **kw)[1]
        offs[seed] = pixel_share(refs[seed], timed[seed])
        x_T = torch.randn((1, RES // 8, RES // 8, 4), device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(r.seed))
        x_T[0, RES // 16, RES // 16, 0] *= 1.01
        control[seed] = pixel_share(refs[seed], pipe.process(r.image, r.prompt, x_T=x_T, **kw)[1])
    nearest = {seed: min(refs, key=lambda other: pixel_share(timed[seed], refs[other])) == seed
               for seed in refs}
    print(f"serving [{card}]: the first batch-4 cut {first_b4} through the runtime directly: "
          f"served rows equal in bytes {direct_equal}; batch-4 rows against process() at "
          f"batch 1, share of pixels off by more than 1: {offs} (the JAX test's contract, "
          f"< {SERVE_PIXEL_SHARE}: {max(offs.values()) < SERVE_PIXEL_SHARE}); control, "
          f"process() against itself with one x_T value scaled by 1.01: {control}; each "
          f"served row nearest its own request's process() image: {nearest}", flush=True)
    # one request in two other batch-4 compositions, and two batches in flight;
    # submitted from this thread one after another, so that each row keeps the
    # position it had in the timed batch it is held against
    timed_b4 = [batch for batch in timed_cuts if len(batch) == 4]
    target = timed_b4[0][0]
    again = []
    for mates in ((1100, 1101, 1102), (1103, 1104, 1105)):
        compositions.clear()
        again.append(in_order(server, (target,) + mates)[0])
        if compositions != [[target, *mates]]:
            raise AssertionError(f"serving: not one batch-4 cut: {compositions}")
    both, fetch = threading.Event(), server._fetch

    def held(images_dev, ready):
        both.wait(timeout=120)  # until the second batch is enqueued
        return fetch(images_dev, ready)

    def counted(batch):
        recorded(batch)
        if server._fetching >= 2:
            both.set()

    server._fetch, server._dispatch_batch = held, counted
    compositions.clear()
    pair = timed_b4[0] + timed_b4[1]
    inflight = in_order(server, pair)
    server._fetch, server._dispatch_batch = fetch, recorded
    overlap = {seed: bool(np.array_equal(img, timed[seed]))
               for seed, img in zip(pair, inflight)}
    if compositions != [timed_b4[0], timed_b4[1]]:
        raise AssertionError(f"serving: the two batches were cut as {compositions}")
    print(f"serving [{card}]: request seed {target} in two other batch-4 "
          f"compositions equal in bytes to its timed image: "
          f"{[bool(np.array_equal(a, timed[target])) for a in again]}; two batches "
          f"in flight ({compositions}, the second enqueued before the first fetch: "
          f"{both.is_set()}), rows equal to their timed bytes: {overlap}", flush=True)
    if not (all(direct_equal) and len(nearest) == 3 and all(nearest.values())
            and all(np.array_equal(a, timed[target]) for a in again)
            and both.is_set() and all(overlap.values())):
        raise AssertionError("serving: a served row disagrees")
    # a request that needs a new engine (4 steps) behind a batch-4 cut still
    # being computed and fetched: its capture waits for that fetch
    # (runtime.capture_guard), and both come back
    n_engines = len(rt._engines)
    first = [server.submit(serve_request(i)) for i in range(4)]
    late = server.submit(serve_request(4, ddim_steps=4))
    waited = [f.result(timeout=600)[1] for f in first + [late]]
    new = {e.name: e.get_engine_infor() for e in list(rt._engines.values())[n_engines:]}
    print(f"serving [{card}]: a 4-step request behind a batch-4 cut: engines captured "
          f"during traffic, s: { {n: i.get('compile_seconds') for n, i in new.items()} }; "
          f"images {len(waited)}", flush=True)
    if not (new and all(i["compiled"] for i in new.values()) and len(waited) == 5):
        raise AssertionError("serving: the capture during traffic failed")
    # the HTTP API on localhost
    httpd = make_http_server(server, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    r = serve_request(7)
    ok, png = cv2.imencode(".png", cv2.cvtColor(r.image, cv2.COLOR_RGB2BGR))
    body = json.dumps({"image_b64": base64.b64encode(png.tobytes()).decode(),
                       "prompt": r.prompt, "image_resolution": RES, "ddim_steps": STEPS,
                       "seed": r.seed, "scale": r.scale, "strength": r.strength}).encode()
    t0 = time.perf_counter()
    with urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/generate", data=body),
            timeout=300) as resp:
        answer = json.loads(resp.read())
    http_s = time.perf_counter() - t0
    httpd.shutdown()
    httpd.server_close()
    got = cv2.cvtColor(cv2.imdecode(np.frombuffer(base64.b64decode(answer["image_b64"]),
                                                  np.uint8), cv2.IMREAD_COLOR),
                       cv2.COLOR_BGR2RGB)
    print(f"serving [{card}]: POST /generate answered in {http_s:.3f} s "
          f"(server-side {answer['ms']:.1f} ms): PNG {got.shape} {got.dtype}", flush=True)
    if got.shape != (RES, RES, 3):
        raise AssertionError(f"POST /generate gave {got.shape}")
    server.stop()
    # one traced replay of the batch-4 engine, and one replay of each by events
    eng4 = rt.sample_decode_engine(STEPS, 4, RES, RES, hint_u8="packed")
    trace = traced_request(eng4.replay)
    replays = engine_replay_ms(rt)
    print(f"serving [{card}]: traced batch-4 replay "
          + ("not measured (no device events)" if trace is None else
             f"{trace[0]:.1f} ms of device time in {trace[2]} device operations, "
             f"attention {trace[1]['attention']:.1f} ms")
          + "; one replay of each engine by CUDA events, ms: "
          + ", ".join(f"{n} {ms:.1f}" for n, ms in replays.items()), flush=True)
    # the bit-packed engine against the uint8 one on the same Canny map
    raw = pipe._annotate(serve_request(0).image, 100, 200)[1]
    u8 = np.repeat(raw[None, ..., None], 3, axis=-1)
    packed = np.packbits(raw > 0, axis=-1)[None]
    ctx = rt.encode_prompt(stand_in_tokenizer([PROMPT, "lowres"]))
    x_T = torch.randn((1, RES // 8, RES // 8, 4), device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(2))
    by_variant = [rt.sample_decode(STEPS, x_T, h, ctx[:1], ctx[1:]).cpu().numpy()
                  for h in (packed, u8)]
    packed_equal = bool(np.array_equal(*by_variant))
    print(f"serving [{card}]: bit-packed hint engine ({packed.nbytes} bytes uploaded) "
          f"against the uint8 engine ({u8.nbytes} bytes) on one Canny map: equal bytes "
          f"{packed_equal}", flush=True)
    if not packed_equal:
        raise AssertionError("the packed and uint8 hint engines disagree")
    pool.shutdown()
    rt.release()
    return {"img_per_s": img_s, "elapsed_s": elapsed, "batch_hist": st["batch_hist"],
            "mean_queue_ms": st["mean_queue_ms"],
            "mean_batch_run_ms": st["mean_batch_run_ms"], "warmup_s": warm_s,
            "engines": engines, "launches": launches, "pixel_share_off": offs,
            "pixel_share_off_control": control, "direct_equal": direct_equal,
            "traced_b4_device_ms": None if trace is None else trace[0],
            "engine_replay_ms": replays, "http_s": http_s}


def multi_controlnet_phase(cfg, card):
    """Two seeded ControlNets at full width (512x512, 20 steps, bf16): a
    request that captures, a replayed one, an eager one (graphs=False) equal
    to it in bytes; attention launches as the plans imply, each net's share
    counted (the UNet's, and each ControlNet's 8 an evaluation)."""
    from stablediffusioneo_tpu_torch.annotators.canny import CannyDetector
    from stablediffusioneo_tpu_torch.ops import dispatch
    from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline

    model = build_model(cfg, seed=3, n_controlnets=2)
    canny = CannyDetector()
    pipe = Canny2ImagePipeline(model, stand_in_tokenizer, cfg, device="cuda",
                               annotator=[canny, lambda img, lo, hi: canny(img, lo // 2,
                                                                           hi // 2)])
    img = smoke_image()
    kw = dict(num_samples=1, image_resolution=RES, ddim_steps=STEPS, scale=SCALE, seed=1,
              strength=(1.0, 0.6))
    t0 = time.perf_counter()
    pipe.process(img, PROMPT, **kw)
    warm_s = time.perf_counter() - t0
    dispatch.reset_launches()
    t0 = time.perf_counter()
    out = pipe.process(img, PROMPT, **kw)[1]
    replay_s = time.perf_counter() - t0
    launches = {k: v for k, v in dispatch.launches.items() if v}
    pipe.runtime.graphs = False
    eager = pipe.process(img, PROMPT, **kw)[1]
    pipe.runtime.graphs = None
    one = expected_launches(cfg, RES, n_controlnets=0)[0]["fused_attention_packed"]
    two = expected_launches(cfg, RES, n_controlnets=2)[0]["fused_attention_packed"]
    per_net = (two - one) // 2
    want = {k: v for k, v in (("fused_attention_packed", STEPS * two),
                               ("fused_attention", expected_launches(cfg, RES)[1])) if v}
    differ = int((out != eager).sum())
    print(f"multi-ControlNet [{card}]: 2 nets, strengths (1.0, 0.6), {STEPS} steps "
          f"{RES}x{RES}: warm-up request {warm_s:.2f} s with its capture, replayed "
          f"{replay_s:.4f} s; bytes that differ from the eager image {differ}; launches "
          f"{launches} (expected {want}: the UNet {STEPS * one}, each ControlNet "
          f"{STEPS * per_net} packed); {pipe.runtime.report()}", flush=True)
    if differ or launches != want or not out.any():
        raise AssertionError("multi-ControlNet: replay and eager disagree, or launches")
    pipe.runtime.release()
    del model
    return {"warm_s": warm_s, "replay_s": replay_s, "launches": launches,
            "unet_packed": STEPS * one, "controlnet_packed_each": STEPS * per_net}


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

    for name, sources in (("groupnorm", groupnorm.SOURCES), ("layernorm", layernorm.SOURCES)):
        kinds = NORM_KERNELS[name]
        regs = ptxas_report(build.library_path(name, sources), kinds)
        print(f"ptxas, kernels of the {name} library, (most registers, spill bytes): {regs}",
              flush=True)
        if len(regs) != len(kinds) or any(spill for _, spill in regs.values()):
            raise AssertionError(f"a {name} kernel spills or is missing: {regs}")

    cfg = sd15_pipeline(dtype="bfloat16")
    kernels = kernel_phase(cfg)
    print(f"kernel phase done at {time.perf_counter() - t_start:.1f} s", flush=True)
    model = build_model(cfg, seed=0)
    reference_phase(model, cfg)
    print(f"reference phase done at {time.perf_counter() - t_start:.1f} s", flush=True)
    runs = {}
    for config in ("default", "fused norms", "int8", "hires", "dpmpp-karras", "euler-a",
                   "heun", "tome 0.5"):
        runs[config] = main_path(model, cfg, config)
        print(f"main path ({config}) done at {time.perf_counter() - t_start:.1f} s",
              flush=True)
    loop_variants(model, cfg)
    print(f"loop variants done at {time.perf_counter() - t_start:.1f} s", flush=True)
    variants_s = sampler_variants(model, cfg)
    print(f"sampler variants done at {time.perf_counter() - t_start:.1f} s", flush=True)
    serving = serving_phase(model, cfg, card)
    print(f"serving phase done at {time.perf_counter() - t_start:.1f} s", flush=True)
    multi = multi_controlnet_phase(cfg, card)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"multi-ControlNet phase done at {time.perf_counter() - t_start:.1f} s", flush=True)
    loaded, checkpoint = checkpoint_phase(model, cfg, runs["default"]["image"])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    print(f"checkpoint phase done at {time.perf_counter() - t_start:.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as directory:
        tokenizer = bpe_tokenizer(directory)
    encode_ms = encode_phase(loaded, cfg)
    for config in ("img2img", "img2img, fused norms", "inpaint", "inpaint, fused norms",
                   "long prompt", "long prompt, auto", "emphasis"):
        if RUNS[config].get("windows"):
            from stablediffusioneo_tpu_torch.models.text_encoding import needed_windows

            texts = [RUNS[config]["prompt"] + ", " + WINDOW_TEXTS["a_prompt"],
                     WINDOW_TEXTS["n_prompt"]]
            if needed_windows(tokenizer, texts) != RUNS[config]["windows"]:
                raise AssertionError(f"{config}: the prompt needs "
                                     f"{needed_windows(tokenizer, texts)} windows")
        runs[config] = main_path(loaded, cfg, config, tokenizer)
        print(f"main path ({config}) done at {time.perf_counter() - t_start:.1f} s",
              flush=True)
    hack = hackathon_phase(loaded, cfg, tokenizer)
    print(f"hackathon phase done at {time.perf_counter() - t_start:.1f} s", flush=True)
    del loaded
    gc.collect()
    torch.cuda.empty_cache()
    sd21_cfg, _ = family_configs()
    model = build_model(sd21_cfg, seed=0)
    runs["sd21 768"] = main_path(model, sd21_cfg, "sd21 768")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    print(f"main path (sd21 768) done at {time.perf_counter() - t_start:.1f} s", flush=True)
    model = build_sdxl(seed=0)
    for config in ("sdxl 1024", "sdxl 1024, fused norms"):
        runs[config] = sdxl_path(model, config, tokenizer)
        print(f"main path ({config}) done at {time.perf_counter() - t_start:.1f} s",
              flush=True)
    sdxl_checkpoint = sdxl_checkpoint_phase(model, tokenizer, runs["sdxl 1024"]["image"])
    del model
    print(f"sdxl checkpoint phase done at {time.perf_counter() - t_start:.1f} s", flush=True)
    latencies = {config: r["latencies"] for config, r in runs.items()}
    eager = {config: r["eager_latency"] for config, r in runs.items()}
    base = runs["default"]["image"].astype(np.int16)
    print(f"replayed request latency, s: {latencies}; eager request latency, s: {eager}; "
          f"seed-1 images against the default's, mean |d| of 255: fused norms "
          f"{np.abs(base - runs['fused norms']['image']).mean():.3f}, int8 "
          f"{np.abs(base - runs['int8']['image']).mean():.3f}", flush=True)

    out = []
    for name, (source, replaces) in KERNELS.items():
        rows = kernels[name]
        launches = runs[EXERCISED_BY.get(name, "fused norms")]["launches"]
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
            # every main-path run's launches of it, two requests each
            "launches_by_path": {**{config: r["launches"][name] for config, r in runs.items()},
                                 "serving": serving["launches"].get(name, 0),
                                 "multi-ControlNet": multi["launches"].get(name, 0)},
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
    sdxl = {config: {k: runs[config][k] for k in ("text_towers_ms", "peak_bytes", "warm_s")}
            for config in ("sdxl 1024", "sdxl 1024, fused norms")}
    print(json.dumps({"kernels": out, "request_s": latencies, "eager_request_s": eager,
                      "checkpoint": checkpoint, "hackathon": hack,
                      "sdxl": sdxl, "sdxl_checkpoint": sdxl_checkpoint,
                      "sampler_variants_request_s": variants_s,
                      "serving": serving, "multi_controlnet": multi,
                      "encode_image_replay_ms": encode_ms,
                      "key_lengths": {config: r["key_lengths"] for config, r in runs.items()},
                      "traced": {config: r["traced"] for config, r in runs.items()},
                      "engines": {config: r["engines"] for config, r in runs.items()},
                      "engine_replay_ms": {config: r["replay_ms"]
                                           for config, r in runs.items()}}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
