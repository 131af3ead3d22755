"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in the checkout, then:
  1. kernel phase: each kernel entry against its plain PyTorch version at
     every shape the 512x512 main path gives it, in bf16 and fp32, with
     both timed by CUDA events (median of 20 after warm-up);
  2. reference phase: one full-width controlled-UNet evaluation at 256x256
     in fp32 on the card (through the kernel) against the same weights on
     the CPU (plain attention), TF32 off;
  3. main path: Canny2ImagePipeline.process at the full SD-1.5 widths in
     bf16, weights drawn from a fixed seed: one warm-up request, then two
     timed requests (512x512, 20 DDIM steps, scale 9, eta 0, batch 1),
     counting the kernel launches of those two requests.
Any failed check raises, so the script exits non-zero and prints no result.
The last line is {"ok": true, "device": {...}}; the line before it names
the card and its power limit, the one before that lists the kernels.
"""

import copy
import json
import statistics
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

KERNEL_SOURCE = "stablediffusioneo_tpu_torch/csrc/attention.cu"
PALLAS = "stablediffusioneo_tpu/ops/pallas/attention.py"
BF16_TOL = (2e-2, 2e-3)  # max, mean |d| on standard-normal inputs
FP32_TOL = 1e-4
REF_TOL = 1e-3  # full-width UNet eval, card vs CPU, relative to max |ref|
STEPS, RES, SCALE = 20, 512, 9.0


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


def kernel_phase():
    from stablediffusioneo_tpu_torch.ops.kernels import attention as ka

    g = torch.Generator(device="cuda").manual_seed(0)
    cases = [
        ("fused_attention_packed", (2, 4096, 320), 4096, 8),
        ("fused_attention_packed", (2, 4096, 320), 77, 8),
        ("fused_attention_packed", (2, 1024, 640), 1024, 8),
        ("fused_attention_packed", (2, 1024, 640), 77, 8),
        ("fused_attention", (1, 1, 4096, 512), 4096, 1),
    ]
    results = {}
    for name, q_shape, s, heads in cases:
        if name == "fused_attention_packed":
            kv_shape = (q_shape[0], s, q_shape[2])
            scale = (q_shape[2] // heads) ** -0.5
            kern = lambda q, k, v: ka.fused_attention_packed(q, k, v, heads, scale)
            plain = lambda q, k, v: ka.fused_attention_packed_plain(q, k, v, heads, scale)
        else:
            kv_shape = q_shape[:2] + (s, q_shape[3])
            scale = q_shape[3] ** -0.5
            kern = lambda q, k, v: ka.fused_attention(q, k, v, scale)
            plain = lambda q, k, v: ka.fused_attention_plain(q, k, v, scale)
        row = {"q": list(q_shape), "s": s, "heads": heads}
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn(q_shape, generator=g, device="cuda").to(dtype)
            k = torch.randn(kv_shape, generator=g, device="cuda").to(dtype)
            v = torch.randn(kv_shape, generator=g, device="cuda").to(dtype)
            err = (kern(q, k, v).float() - plain(q, k, v).float()).abs()
            torch.cuda.synchronize()
            mx, mean = err.max().item(), err.mean().item()
            tag = "bf16" if dtype == torch.bfloat16 else "fp32"
            ok = (mx <= BF16_TOL[0] and mean <= BF16_TOL[1] if tag == "bf16"
                  else mx <= FP32_TOL)
            row[f"{tag}_max_abs_err"], row[f"{tag}_mean_abs_err"] = mx, mean
            row[f"{tag}_ms"] = time_ms(lambda: kern(q, k, v))
            row[f"{tag}_plain_ms"] = time_ms(lambda: plain(q, k, v))
            print(f"kernel {name} q={q_shape} S={s} {tag}: max|d| {mx:.3e} "
                  f"mean|d| {mean:.3e}  kernel {row[f'{tag}_ms']:.4f} ms  "
                  f"plain {row[f'{tag}_plain_ms']:.4f} ms", flush=True)
            if not ok:
                raise AssertionError(f"{name} {q_shape} S={s} {tag} disagrees "
                                     f"with its plain version: {mx}, {mean}")
            del q, k, v, err
            torch.cuda.empty_cache()
        results.setdefault(name, []).append(row)
    return results


def build_model(cfg, seed):
    from stablediffusioneo_tpu_torch.models.cldm import ControlLDM, init_weights

    with torch.device("meta"):
        model = ControlLDM(cfg)
    model.to_empty(device="cuda")
    init_weights(model, torch.Generator(device="cuda").manual_seed(seed))
    return model


def reference_phase(model, cfg):
    """Full-width controlled-UNet eval at 256x256 (1024-token level-0 sites
    go through the packed kernel), fp32: card vs CPU."""
    from stablediffusioneo_tpu_torch.models.controlnet import controlled_unet_apply
    from stablediffusioneo_tpu_torch.ops import dispatch

    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 32, 32, 4), generator=g)
    hint = (torch.rand((2, 256, 256, 3), generator=g) > 0.8).float()
    ctx = torch.randn((2, 77, 768), generator=g)
    t = torch.tensor([801.0, 801.0])
    scales = [1.0] * 13
    outs = {}
    for dev, m in (("cuda", model), ("cpu", copy.deepcopy(model).cpu())):
        dispatch.reset_launches()
        with torch.no_grad():
            out = controlled_unet_apply(
                m.unet, m.control_model, x.to(dev), hint.to(dev), t.to(dev),
                ctx.to(dev), control_scales=scales)
        outs[dev] = out.cpu()
        if dev == "cuda":
            launches = dispatch.launches["fused_attention_packed"]
        del m
    err = (outs["cuda"] - outs["cpu"]).abs().max().item()
    ref_scale = outs["cpu"].abs().max().item()
    print(f"reference: full-width controlled UNet 256x256 fp32, card vs CPU "
          f"max|d| {err:.3e} (max|ref| {ref_scale:.3e}), packed launches "
          f"{launches}", flush=True)
    if not (torch.isfinite(outs["cuda"]).all() and err <= REF_TOL * ref_scale
            and launches == expected_launches(cfg, 256)[0]):
        raise AssertionError(f"reference phase failed: {err}, {launches}")


def expected_launches(cfg, res):
    """Packed launches per DDIM step and split launches per decode, from the
    UNet plans: each transformer block of a site with >= ATTN_MIN_TQ tokens
    runs self- and cross-attention once each over the whole CFG batch (UNet:
    input, middle and output blocks; ControlNet: input and middle blocks);
    the VAE mid-block attends once at latent resolution."""
    from stablediffusioneo_tpu_torch.models.unet import decoder_plan, encoder_plan
    from stablediffusioneo_tpu_torch.ops.dispatch import ATTN_MIN_TQ

    ucfg, lat = cfg.unet, res // cfg.vae.downsample_factor

    def blocks(plan):
        return sum(d["depth"] for d in plan
                   if d["attn"] and (lat // d["ds"]) ** 2 >= ATTN_MIN_TQ)

    levels = len(ucfg.channel_mult)
    mid = (ucfg.depth_for(levels - 1)
           if (lat // 2 ** (levels - 1)) ** 2 >= ATTN_MIN_TQ else 0)
    enc = blocks(encoder_plan(ucfg))
    packed = 2 * (2 * enc + blocks(decoder_plan(ucfg)) + 2 * mid)
    return packed, int(lat * lat >= ATTN_MIN_TQ)


def main_path(model, cfg):
    from stablediffusioneo_tpu_torch.ops import dispatch
    from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline

    pipe = Canny2ImagePipeline(model, stand_in_tokenizer, cfg, device="cuda")
    rng = np.random.default_rng(0)
    img = np.zeros((RES, RES, 3), np.uint8)
    img[96:416, 128:384] = 200  # a box with edges, plus texture
    img = (img + rng.integers(0, 40, img.shape)).astype(np.uint8)
    kw = dict(num_samples=1, image_resolution=RES, ddim_steps=STEPS,
              scale=SCALE, eta=0.0, strength=1.0)
    t0 = time.perf_counter()
    pipe.process(img, "a house in the woods", seed=0, **kw)
    print(f"main path warm-up request: {time.perf_counter() - t0:.3f} s",
          flush=True)
    per_step, per_decode = expected_launches(cfg, RES)
    torch.cuda.synchronize()
    dispatch.reset_launches()
    images, latencies = [], []
    for seed in (1, 2):
        t0 = time.perf_counter()
        out = pipe.process(img, "a house in the woods", seed=seed, **kw)
        latencies.append(time.perf_counter() - t0)
        z = pipe.last_latents
        if not (torch.isfinite(z).all() and z.shape == (1, RES // 8, RES // 8, 4)):
            raise AssertionError("final latents are not finite or misshapen")
        if not (out[1].shape == (RES, RES, 3) and out[1].dtype == np.uint8):
            raise AssertionError(f"image {out[1].shape} {out[1].dtype}")
        images.append(out[1])
        print(f"main path request seed={seed}: {latencies[-1]:.4f} s "
              f"({pipe.last_timings})", flush=True)
    launches = dict(dispatch.launches)
    want = {"fused_attention_packed": 2 * STEPS * per_step,
            "fused_attention": 2 * per_decode}
    print(f"kernel launches over the 2 requests: {launches} (expected {want}: "
          f"{per_step} packed per step, {per_decode} split per decode)",
          flush=True)
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if np.array_equal(images[0], images[1]):
        raise AssertionError("two seeds gave the same image")
    print(f"image stats: mean {images[0].mean():.2f} std {images[0].std():.2f}; "
          f"seeds differ in {(images[0] != images[1]).mean():.3f} of values",
          flush=True)
    pipe.runtime.release()
    return launches, latencies


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs on the card only")
    from stablediffusioneo_tpu.config import sd15_pipeline
    from stablediffusioneo_tpu_torch.ops.kernels import build
    from stablediffusioneo_tpu_torch.ops.kernels.attention import SOURCES

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    # fp32 checks need true fp32 products on both sides (cuDNN defaults to TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          "TF32 off for matmul and cuDNN", flush=True)
    t0 = time.perf_counter()
    build.load_library("attention", SOURCES)
    print(f"kernel build + load: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.build_seconds.get('attention', 0.0):.2f} s)", flush=True)

    kernels = kernel_phase()
    cfg = sd15_pipeline(dtype="bfloat16")
    model = build_model(cfg, seed=0)
    reference_phase(model, cfg)
    launches, latencies = main_path(model, cfg)

    out = []
    for name, line in (("fused_attention_packed", 125), ("fused_attention", 106)):
        rows = kernels[name]
        out.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": f"{PALLAS}:{line}", "launches": launches[name],
            "max_abs_err": max(r["bf16_max_abs_err"] for r in rows),
            # one call at each main-path shape, bf16
            "ms": sum(r["bf16_ms"] for r in rows),
            "plain_ms": sum(r["bf16_plain_ms"] for r in rows),
            "shapes": rows,
        })
    print(json.dumps({"kernels": out, "request_s": latencies}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
