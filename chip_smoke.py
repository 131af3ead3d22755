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
     512x512 by default (every norm call held to a kernel route: on the card
     the norms reach their kernels whatever the flags, ops/norms.py) and with
     int8 linears (quantize_linears=True, set_kernels(int8_linear=True)); then
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
     and inpainting (a rectangular mask, 20 steps), each as a main path
     above: the VAE encoder's engine (posterior mode) and the loop's
     init-latent or inpaint variant; two split attention launches a request
     (encode and decode), the encoder's GroupNorms on the kernels;
     encode_image alone: replayed equals eager in bytes, and a sample with a
     fixed eps repeats;
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
     weights drawn on the card ("sdxl 1024"):
     sdxl_conditioning through both towers from the BPE tokenizer (their
     device time printed apart), then one captured sample+decode Engine
     (runtime/engine.py:sdxl_sample_decode_engine; capture seconds, graph
     nodes, pool bytes, peak memory): a warm-up, two timed replays, one
     eager request equal to the replay in bytes, one traced replay; 2,800
     packed launches (10 and 20 heads) and one split a request;
  10. the seeded SDXL's sgm-layout state dict (bf16, 2,515 keys with the two
     OpenCLIP leftovers) written to a temporary directory (its free bytes
     printed first) and read back by load_sdxl_pipeline onto the card: every
     key consumed or named, none orphaned, the seeded image in bytes;
  11. adapters, on the loaded SD-1.5 model after the phases that expect its
     own image: LoRA (lora_phase: a seeded rank-8 adapter for the UNet, the
     ControlNet and CLIP each through an sdeo-lora-v1 file; scale 0 gives the
     base image in bytes; merged at alpha / rank into the engines captured
     before, which replay it with no new capture: another image, replay =
     eager in bytes, 560 + 1 launches), then textual inversion
     (textual_inversion_phase: a concept made of a two-token word's rows gives
     the word's image in bytes, a random one another image; only the CLIP
     engines are evicted and captured again);
  12. the 9-channel inpainting model (sd15_inpaint_pipeline(), seeded) at
     512x512, 20 steps, scale 9, as a main path over encoder_engine and
     concat_sample_decode_engine (captured_path: 400 packed + 2 split a
     request: no ControlNet), then its sd-v1-5-inpainting-layout file through
     load_inpaint_pipeline (every key consumed or named, the same image);
  13. the SDXL refiner (SDXLRefinerConfig(), seeded): one fp32 UNet
     evaluation at 256x256, card vs CPU within REF_TOL (refiner_reference),
     then in bf16 the base -> refiner handoff at 1024x1024 on the "sdxl 1024"
     run's latents, t_enc 4 of 20, scale 5, as a main path over
     sdxl_refine_decode_engine (320 packed + 1 split a request), then its
     sgm-layout file through load_sdxl_refiner_pipeline (free bytes first;
     every key consumed or named, the same image). Then SD 3.5 Medium
     (sd3_phase): the packed attention at its joint site (2, 4429, 1536) x
     4429 and image-only site (2, 4096, 1536), q and k through rms_norm, and
     #7 without affine at (2, 4096, 1536) and (2, 333, 1536), each timed
     against its plain version with its bound; then the seeded full-width
     model in bf16 (weights drawn on the card): the towers' conditioning,
     sd3_sample_decode_engine at 1024x1024, 40 steps, scale 4.5, captured
     by a warm-up; two replayed requests, their launches held to sd3_plan
     (1,480 packed + 1 split, 3,840 #7 launches and 4,880 plain RMSNorm
     calls a request, every norm call by route); one eager request equal to
     the replay in bytes.
  14. the annotator nets at full width in fp32 (annotator_reference, after
     the reference phase): DPT-L at 512x512 (24 split launches), the
     DPT-hybrid at 384x384, HED at 512x512, the OpenPose body net at
     368x368, MLSD and UniFormer + UperNet at 512x512 (8 split launches at
     (1, 5, 1024, 64)), card vs CPU within REF_TOL; then, on the loaded SD-1.5
     model after hackathon, the JAX bench's annotators row (annotators_phase:
     Canny, HED, MiDaS DPT-L and OpenPose with seeded weights, a warm and two
     timed process() each at 512x512, 20 steps: p50, preprocess_ms, the worst
     p50, the detector's weights and peak; 560 + 1 launches a request, MiDaS
     24 split more; Canny's map on the bit-packed hint engine, the others' on
     the uint8 one); then MLSD and UniFormer the same way (detector_file_phase:
     seeded weights through files under the upstream names, all 344 / 398
     keys; MLSD's binary map on the bit-packed engine, UniFormer's on the
     uint8 one with 8 split launches a detection), the scoring harness
     (scoring_phase: the FID Inception tower from a seeded pt_inception file,
     470 keys, fp32, card vs CPU; ScoreHarness over the replayed process() at
     256x256 against self-consistency goldens: every PD 0, and above 0 at
     another seed), the JAX bench's yolo row (yolo_phase: YOLOv5s from a
     seeded file, fp32 card vs CPU at 320x320, then bf16 as load_yolov5 gives
     it on the card: a 720x1280 image letterboxed to 1120x1120, top 300 on
     the device, PostProcessor(0.99, 0.45), p50 and img/s of 8 requests, the
     predictions held to the fp32 net on the CPU) and the native preprocessing library
     (native_phase: built from native/preproc.cpp, Canny and the resize held
     to cv2);
  15. SD-2.0 depth2img (depth2img_phase, after the 9-channel model): the
     seeded sd2_depth_pipeline() model's 512-depth-ema-layout file through
     load_depth2img_pipeline, then on the loaded model the 512x512 request
     (the MiDaS tower at 384x384, depth_to_concat, concat_sample_decode_engine:
     400 + 1 launches) as a main path over captured_path, the tower's time
     apart, the seeded model's image equal in bytes.
  16. training (training_phase, last: the runtime of its user path casts the
     model to bf16): ControlNet fine-tuning on a fresh seeded SD-1.5 +
     ControlNet. One fp32 step at 256x256 b1, card vs CPU, every ControlNet
     gradient within TRAIN_REF_TOL and the level-0 attention projections'
     non-zero (train_reference); the JAX bench's train row (AdamW lr 1e-5,
     bf16, its seeded batch; a first step apart, then 6 steps each closed by
     float(loss): p50, steps/s, samples/s, peak memory, one traced step with
     the attention kernels', the attention backward's and AdamW's device
     time) at 256x256 b8, 512x512 b2 and 512x512 b2 with remat, packed
     launches a step as train_attention_launches says (14, 28, 48); one
     step's gradients with and without remat (and twice without: the
     spread); LoRA rank 8 on the ControlNet, 2 steps (base weights equal in
     bytes, every factor moved); a resume (save after step 1, restore, step
     2) against two uninterrupted runs; then the user's path:
     controlnet_batches over a stand-in loader (no dataset is in the
     repository; the script prints whether PIL and libpng's headers are
     there) with the runtime's captured CLIP and encoder engines, 2 steps of
     train() with EMA and a metrics file.
  17. the checkpoint tools (after the native library, on the loaded SD-1.5
     model's machine): the offline drill (drill_phase: every family of
     testing/offline_drill.py at full width, files synthesized from the
     packaged key universes (the sd15 .pth of 5.7 GB, the SDXL .safetensors
     of 13.9 GB), manifest verify, strict load, one bf16 inference on the
     card at DRILL_RES; #1 and #2 launched on sd15 and sdxl as the plans
     say; then a drill file pinned into a copy of the manifest verifies and,
     one byte flipped, is rejected on its sha256), sdeo-readiness-torch's
     flow on the drill's sd15 file (readiness_phase: --verify-manifest over
     the checkpoint and the smoke vocabulary's vocab.json / merges.txt, the
     card's bf16 run against the port's fp32 CPU run at READINESS_RES,
     READINESS_STEPS steps, each PD and the mean against READINESS_PD_LIMIT,
     the final latents within READINESS_LATENT_TOL of the reference's; the
     card in fp32 within READINESS_FP32_TOL, a request without the ControlNet
     or with another prompt outside it; then --dry-run), T5 v1.1-large
     (t5_phase: fp32 card vs CPU within REF_TOL with and without a padding
     mask, the bf16 p50, clip_t5_encode) and sdeo-smoke-torch
     (smoke_cli_phase: the CLIP engine captured over seeded SD-1.5
     weights). unet_reference holds SD-2.1's UNet + ControlNet
     (256x256, before its main path) and SDXL base's UNet (512x512, drawn
     apart in fp32) to the CPU in fp32 within REF_TOL.
  18. the parallel layer (parallel_phase, last; parallel/mesh.py,
     parallel/pipeline.py): ranks spawned on the one card. Two over gloo
     (NCCL takes one rank a device; the collectives staged through pinned
     host memory, engines eager), each path's launch counts from 0 and each
     rank's launches, by kernel and by attention call (batch, heads, Tq, S,
     head dim), held to the plan (mesh_plan): (a) SD-1.5 + ControlNet at
     full width through process(): fp32 at PARALLEL_RES, PARALLEL_STEPS
     steps at dp=2 (batch 2), tp=2 and sp=2 (batch 1), and at tp=2 and sp=2
     with the fused norms on (the one-pass GroupNorm under tp, the stats and
     apply pair with the partial sums all-reduced under sp, LayerNorm on a
     rank's tokens), the latents within PARALLEL_TOL of the same request
     unsharded on the card, and each fault of PARALLEL_FAULTS (a skipped
     row-parallel all-reduce, zeroed halo rows) planted in a rank's model
     outside it; then bf16 at 512x512, 20 steps, fused norms, at tp=2 and
     sp=2 against the unsharded image (the share of pixels off by more than
     1 at most PARALLEL_PIXEL_SLACK x that of a 1.01-scaled-x_T control);
     (b) CLIP ViT-L (12 layers) and T5 v1.1-large at pp=2 against the
     sequential towers within PP_TOL, fp32, (2, 77), T5 with and without a
     padding mask; (c) one full-width fp32 ControlNet train step at dp=2,
     tp=2 and dp=2 with FSDP against the single-process step (loss and
     AdamW's first moments within REF_TOL, the parameters' moves within
     TRAIN_MOVE_TOL of the step's, each rank on its slices); then (d) one
     rank over NCCL: a mesh runtime with graphs=True captures its engines
     with the collectives of its size-1 dp and tp axes inside, and its
     replayed request equals the eager one in bytes. The kernel phase also
     holds the rank-local kernel calls of these requests (parallel_rows):
     those of the bf16 512x512 ones as timed rows (attention at half the
     heads or half the queries, LayerNorm at half the tokens, the GroupNorm
     stats and apply pair at the largest and smallest of a rank's rows),
     the rest against their plain versions untimed (check_calls).
The kernel phase also takes every attention shape of the SD-2.1, SDXL,
SDXL-refiner and depth2img requests (heads of 64 channels; the 768x768
decode's (1, 1, 9216, 512)), the MiDaS ViTs' split sites at 512x512 ((1,
16, 1025, 64) and (1, 12, 1025, 64), q / k / v as views of one qkv
projection), UniFormer's stage-3 site at a 512x512 detection ((1, 5, 1024,
64), the same views) and the gated GroupNorm sites of an SDXL step; each attention
row names the passes that give it. After it, attention_grad_phase holds each
attention entry's autograd Function (kernel forward, the port's copy of the
JAX backward) against autograd through its plain version at the training
shapes (GRAD_ROWS, GRAD_TOL), bf16 and fp32, both timed.
Launch counts must equal what the UNet, ControlNet, VAE and CLIP plans and
the dispatch gates imply. Any failed check raises, so the script exits
non-zero and prints no result. The last line is {"ok": true, "device":
{...}}; the line before it names the card and its power limit, the one
before that lists the kernels.
"""

import collections
import contextlib
import copy
import dataclasses
import gc
import io
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
# two large channels-last slabs of the two-pass GroupNorm pair (the VAE
# decoder's last level, SD-1.5's decoder at 64x64x960), at which the kernel
# phase forces each of the pair's two stats kernels too
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
# the SDXL base -> refiner handoff: the refiner takes the last 4 of the 20
# steps (the 0.8 handoff), scale 5, aesthetic scores 6.0 (cond) / 2.5 (uncond)
REFINER_T_ENC, REFINER_SCORES = 4, (6.0, 2.5)
# the LoRA phase's adapters (rank 8, alpha 8: merged at alpha / rank = 1.0;
# b drawn N(0, LORA_B_STD^2)), and the textual-inversion phase's concepts
LORA_RANK, LORA_ALPHA, LORA_B_STD = 8, 8.0, 0.01
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
    "int8": {"int8": True},
    "hires": {"process": {"hires_upscale": HIRES_UPSCALE, "hires_denoise": HIRES_DENOISE}},
    "img2img": {"init": True},
    "inpaint": {"inpaint": True},
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
# the annotators phase: the JAX bench's annotators row (cli/bench.py:
# _bench_annotators): one full process() a family on the loaded SD-1.5 +
# ControlNet model at 512x512, 20 steps, scale 9, seed 1, "a bird", the image
# from default_rng(2946901); seeded detector weights
ANNOTATOR_FAMILIES = ("canny", "hed", "midas", "openpose")
ANNOTATOR_PROMPT, ANNOTATOR_IMAGE_SEED = "a bird", 2946901
# the MiDaS ViTs: DPT-L (16 heads) and the DPT-hybrid (12 heads) of 64
# channels, hooked 16-pixel patches plus the class token
VIT_HEADS = {"dpt_large": 16, "dpt_hybrid": 12}
VIT_BLOCKS = {"dpt_large": 24, "dpt_hybrid": 12}
# UniFormer-S's stage 3 (width 320, heads of 64, 8 blocks) at 1/16 of the
# detection's side: 1,024 tokens at 512x512, at the split kernel's gate
UNIFORMER_HEADS, UNIFORMER_SA_BLOCKS = 5, 8
# the card-vs-CPU fp32 check of the annotator nets at full width: (net,
# input side)
ANNOTATOR_REFERENCE = (("dpt_large", 512), ("dpt_hybrid", 384), ("hed", 512),
                       ("openpose_body", 368), ("mlsd_large", 512), ("uniformer", 512))
# MLSD and UniFormer on the loaded SD-1.5 model (detector_file_phase): seeded
# weights written under the upstream file names and read back by ckpt_path;
# MLSD at the reference's default value threshold, 0.1, and the least
# distance threshold its slider takes, 0.01 (gradio_hough2image.py): the
# seeded net's displacements stay under 0.1 pixel, so at the default
# distance threshold it finds no segment. Its map is binary, so process()
# bit-packs it
FILE_DETECTORS = {"mlsd": ("mlsd_large", "mlsd_large_512_fp32.pth"),
                  "uniformer": ("uniformer", "upernet_global_small.pth")}
MLSD_THRESHOLDS = (0.1, 0.01)
# the JAX bench's yolo row (cli/bench.py:_bench_yolo): a 720x1280 image from
# default_rng(0) letterboxed to 1120x1120, the top 300 rows by objectness on
# the device, PostProcessor(0.99, 0.45), 1 warm-up and 8 timed requests; the
# fp32 card-vs-CPU check at 320x320
YOLO_SIDE, YOLO_TOPK, YOLO_CONF, YOLO_IOU = 1120, 300, 0.99, 0.45
YOLO_IMAGE, YOLO_TIMED, YOLO_REF_SIDE = (720, 1280), 8, 320
# the timed request's bf16 net (load_yolov5's default on the card) against
# the fp32 net on the CPU, boxes and scores each relative to its own
# max |ref|: bf16 rounds each of the ~60 convs' outputs to 8 bits (about
# 4e-3 each), the decode and top-k stay fp32
YOLO_BF16_TOL = 1e-2
# the scoring run (cli/score.py's flow): fixture scenes at 256x256, 20 steps,
# the CLI's seed, against self-consistency goldens
SCORE_RES, SCORE_IMAGES, SCORE_SEED = 256, 2, 2946901
# the checkpoint tools: the offline drill's sd15 / sdxl sample side and steps
# (512: SDXL's level-1 sites then hold 1,024 tokens and reach the packed
# kernel); sdeo-readiness-torch on the drill's sd15 file; T5's timed calls;
# the full-width fp32 references' sides (SD-2.1's level-0 sites hold 1,024
# tokens at 256, SDXL base's level-1 sites at 512)
DRILL_RES, DRILL_STEPS = 512, 1
READINESS_RES, READINESS_STEPS, READINESS_N, READINESS_PD_LIMIT = 256, 4, 2, 10.0
# the drill's N(0, 0.02) weights decode to near-flat images whose PD stays
# ~6e-4 whatever the card did, and the nets move the latents by less than
# their bf16 rounding. So the final latents, max |dz| / max |z_ref| against
# the CPU's fp32 run, are held twice: card bf16 (read 0.0049-0.0050), then
# card fp32 (read 2.4e-7-3.2e-7), where a request without the ControlNet
# (3.0e-3) or with another prompt (3.1e-5) must land outside the bound
# (readings on an H100 80GB HBM3 at 700 W, PERF.md)
READINESS_LATENT_TOL, READINESS_FP32_TOL = 1e-2, 3e-6
T5_CALLS = 20
REFERENCE_RES, SDXL_REF_RES = 256, 512
# the training phase: the JAX bench's train row (cli/bench.py:_bench_train):
# AdamW lr 1e-5, bf16, x0 / hint / ctx from default_rng(2946901), one step
# timed apart, then TRAIN_STEPS timed steps each closed by float(loss); at
# (resolution, batch) 256x256 b8 (the row's default) and 512x512 b2 (its
# latency configuration), the last also with remat on
TRAIN_SEED, TRAIN_LR, TRAIN_STEPS = 2946901, 1e-5, 6
TRAIN_RUNS = {"train 256 b8": (256, 8, False), "train 512 b2": (512, 2, False),
              "train 512 b2, remat": (512, 2, True)}
# the attention entries' gradients on the card: (entry, q shape, key length,
# heads) at the training sites: the 256x256 level-0 sites at batch 8, the
# 512x512 level-0 self-attention (chunked backward) and level-1 one at batch
# 2 (d = 40 and 80), the streaming entry and the VAE encoder's mid-block
GRAD_ROWS = (("fused_attention_packed", (8, 1024, 320), 1024, 8),
             ("fused_attention_packed", (8, 1024, 320), 77, 8),
             ("fused_attention_packed", (2, 4096, 320), 4096, 8),
             ("fused_attention_packed", (2, 1024, 640), 1024, 8),
             ("fused_attention_packed_stream", (2, 4096, 320), 4096, 8),
             ("fused_attention", (1, 1, 4096, 512), 4096, 1))
# kernel Function against autograd through the plain version, per gradient
# tensor, max |d| over max |plain gradient|: fp32 differ in summation order
# (and the chunked recurrence); bf16 by the kernel's and the plain version's
# roundings of the forward (BF16_TOL's 2e-2 on standard-normal outputs)
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# full-width fp32 train-step gradients, card vs CPU, per ControlNet tensor,
# max |d| over max |CPU gradient| of the tensor
TRAIN_REF_TOL = 1e-3
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
TENSOR_CORE_KERNELS = {"attention": ("attention_split512_kernel", "attention_wgmma_kernel",
                                     "attention_ws_kernel"),
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
    timed, checked = parallel_rows(cfg)
    rows = {**attention_rows(cfg, paths=True), **family_attention_rows(cfg),
            **{attention_row(*entry): paths for entry, paths in timed.items()
               if entry[0].startswith("fused_att")}}
    for (name, q_shape, s, heads), paths in rows.items():
        make = lambda dt: (randn(q_shape, dt), randn(kv_shape, dt), randn(kv_shape, dt))
        if name == "fused_attention" and heads > 1:
            # a MiDaS ViT block's q, k, v: (B, H, T, d) views of the one qkv
            # projection (B, T, 3, H, d), token stride 3C, as models run them
            batch, tq, d = q_shape[0], q_shape[2], q_shape[3]
            scale = d ** -0.5
            kern = lambda q, k, v: ka.fused_attention(q, k, v, scale)
            plain = lambda q, k, v: ka.fused_attention_plain(q, k, v, scale)
            wgmma = lambda q, k, v: ka._split_launch(q, k, v, scale, "wgmma")
            library = F.scaled_dot_product_attention
            make = (lambda dt, b=batch, t=tq, h=heads, dd=d: tuple(
                randn((b, t, 3, h, dd), dt).permute(2, 0, 3, 1, 4).unbind(0)))
        elif name == "fused_attention":
            kv_shape = q_shape[:2] + (s, q_shape[3])
            batch, tq, d = q_shape[0], q_shape[2], q_shape[3]
            scale = d ** -0.5
            kern = lambda q, k, v: ka.fused_attention(q, k, v, scale)
            plain = lambda q, k, v: ka.fused_attention_plain(q, k, v, scale)
            wgmma = lambda q, k, v: ka._split_launch(q, k, v, scale, "wgmma")
            library = F.scaled_dot_product_attention
        else:
            kv_shape = (q_shape[0], s, q_shape[2])
            batch, tq, d = q_shape[0], q_shape[1], q_shape[2] // heads
            scale = d ** -0.5
            kern = (lambda q, k, v, e=getattr(ka, name): e(q, k, v, heads, scale))
            plain = (lambda q, k, v, e=getattr(ka, name + "_plain"):
                     e(q, k, v, heads, scale))
            wgmma = lambda q, k, v: ka._packed_launch(q, k, v, heads, scale, name, "wgmma")
            # the library call on the head-split view of the packed tensors
            library = lambda q, k, v: F.scaled_dot_product_attention(
                *(t.view(batch, -1, heads, d).transpose(1, 2) for t in (q, k, v)))
        ops, _, exps = attention_work(batch, heads, tq, s, d)
        want = site_variant(d, s)  # the tensor-core variants
        row = measure(
            name, {"q": list(q_shape), "s": s, "heads": heads, "paths": paths}, kern, plain,
            make, ops=ops, peak=PEAK_BF16, library=library, variants=ka.variant_launches,
            # the wgmma variant's time beside the warp-specialised one's
            others={"wgmma": wgmma} if want == "wgmma_ws" else None)
        # a second figure beside the bound: one exp per logit on the
        # special-function units
        row["exp_ms"] = exps / PEAK_EXP * 1e3
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
    for shape, groups, swish in group_norm_rows(cfg):
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

    # the two-pass pair at every site of a step and a decode that the card's
    # rule sends to it (card_norm_rows: SD-1.5 at 512x512, SDXL at
    # 1024x1024), and at the largest and the smallest of a rank's rows of
    # the GroupNorm sites under sp=2 (the rest of them are checked below,
    # untimed); a stats row a slab, an apply row a slab and SiLU, the apply
    # row timing the whole pair and F.group_norm(+SiLU) beside it
    pairs = sorted({call[0] for (name, call) in timed if name == "group_norm_stats"},
                   key=math.prod)
    for entry in list(timed):
        if entry[0].startswith("group_norm_") and pairs and entry[1][0] not in (
                pairs[0], pairs[-1]):
            checked.setdefault(entry, []).extend(timed.pop(entry))
    pair_rows = list(dict.fromkeys(card_norm_rows(cfg)["pair"]
                                   + [(shape, 32, True) for shape in pairs[:1] + pairs[-1:]]))
    stats_done = set()
    for shape, groups, swish in pair_rows:
        x32 = randn(shape, torch.float32, channels_last=True)
        rows = kg.chunk_rows(x32, groups)
        desc = {"x": list(shape), "groups": groups, "chunk_rows": rows}
        if shape in pairs:
            desc["paths"] = sorted({p for (name, call), paths in timed.items()
                                    if call[0] == shape for p in paths})
        if (shape, groups) not in stats_done:
            stats_done.add((shape, groups))
            # beside the plan stats_plan picks, each of the two kernels forced
            # (bf16): the (sample, group, chunk) kernel is the earlier one
            forced = {name: kg.stats_plan(shape, groups, torch.bfloat16, True, rows, by_rows=by)
                      for name, by in (("group_x_chunk", False), ("rows_x_channels", True))
                      if shape in APPLY_SHAPES}
            results["group_norm_stats"].append(measure(
                "group_norm_stats", desc,
                lambda x: kg.group_norm_stats(x, groups, rows),
                lambda x: kg.group_norm_stats_plain(x, groups, rows),
                lambda dt: (x32.to(dt),), relative=True, ops=3 * x32.numel(),
                others={name: (lambda x, plan=plan: kg.group_norm_stats(x, groups, rows,
                                                                        plan=plan))
                        for name, plan in forced.items()},
                variants=kg.stats_plan_launches))

        def apply_inputs(dt):
            x = x32.to(dt)
            return (x, kg.group_norm_stats_plain(x, groups, rows), *affine(shape[1], dt))

        def library(x, p, w, b):
            y = F.group_norm(x, groups, w, b, 1e-6)
            return F.silu(y) if swish else y

        results["group_norm_apply"].append(measure(
            "group_norm_apply", {**desc, "swish": swish},
            lambda x, p, w, b: kg.group_norm_apply(x, p, w, b, rows, 1e-6, swish),
            lambda x, p, w, b: kg.group_norm_apply_plain(x, p, w, b, 1e-6, swish),
            apply_inputs, ops=NORM_OPS * x32.numel(), library=library,
            others={"pair": lambda x, p, w, b: kg.group_norm_apply(
                x, kg.group_norm_stats(x, groups, rows), w, b, rows, 1e-6, swish)},
            variants=kg.apply_plan_launches))
        del x32

    # the LayerNorm at every shape the card's rule sends to it (the gated
    # shapes first: those, and a rank's tokens, may not be slower than
    # F.layer_norm; the narrower prompt and 8x8 rows are timed beside it)
    parallel_ln = [call[0] for (name, call) in timed if name == "fused_layer_norm"]
    gated_ln = layer_norm_shapes(cfg)
    for shape in list(dict.fromkeys(gated_ln + card_norm_rows(cfg)["ln"] + parallel_ln)):
        row = measure(
            "fused_layer_norm", {"x": list(shape)},
            lambda x, w, b: kl.fused_layer_norm(x, w, b, 1e-5),
            lambda x, w, b: kl.fused_layer_norm_plain(x, w, b, 1e-5),
            lambda dt: (randn(shape, dt), *affine(shape[-1], dt)),
            ops=NORM_OPS * math.prod(shape),
            library=lambda x, w, b: F.layer_norm(x, x.shape[-1:], w, b, 1e-5),
            variants=kl.plan_launches)
        if shape in parallel_ln:  # a rank's tokens under sp=2
            row["paths"] = timed[("fused_layer_norm", (shape, 0, False))]
        row["gated"] = shape in gated_ln or shape in parallel_ln
        if row["gated"] and row["bf16_ms"] > row["library_ms"] * (1 + LIBRARY_SPREAD):
            raise AssertionError(f"fused_layer_norm {shape} bf16 {row['bf16_ms']:.4f} ms is "
                                 f"slower than F.layer_norm {row['library_ms']:.4f} ms")
        results["fused_layer_norm"].append(row)
    unexpected = [e for e in timed if e[0] in ("fused_group_norm", "quantized_matmul")]
    if unexpected:
        raise AssertionError(f"parallel rows without a timed row: {unexpected}")
    results["checked"] = check_calls(checked, randn, affine)
    return results


def check_calls(calls, randn, affine):
    """Each kernel call of `calls` ({(entry, call): paths}, parallel_rows'
    form) against its plain version on the same inputs, bf16 and fp32, with
    the kernel phase's tolerances, untimed: {entry: [rows]}."""
    from stablediffusioneo_tpu_torch.ops.kernels import attention as ka
    from stablediffusioneo_tpu_torch.ops.kernels import groupnorm as kg
    from stablediffusioneo_tpu_torch.ops.kernels import layernorm as kl

    out = {}
    for (name, call), paths in sorted(calls.items(), key=str):
        row = {"call": list(call) if name.startswith("fused_att") else
               [list(call[0]), call[1], call[2]], "paths": paths}
        for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
            if name.startswith("fused_att"):
                b, h, tq, s, d = call
                scale = d ** -0.5
                if name == "fused_attention":
                    args = (randn((b, h, tq, d), dtype), *(randn((b, h, s, d), dtype)
                                                           for _ in range(2)))
                    kern = lambda q, k, v: ka.fused_attention(q, k, v, scale)
                    plain = lambda q, k, v: ka.fused_attention_plain(q, k, v, scale)
                else:
                    args = (randn((b, tq, h * d), dtype), *(randn((b, s, h * d), dtype)
                                                            for _ in range(2)))
                    kern = lambda q, k, v, e=getattr(ka, name): e(q, k, v, h, scale)
                    plain = (lambda q, k, v, e=getattr(ka, name + "_plain"):
                             e(q, k, v, h, scale))
            else:
                shape, groups, swish = call
                x = randn(shape, dtype, channels_last=len(shape) == 4)
                if name == "fused_layer_norm":
                    args = (x, *affine(shape[-1], dtype))
                    kern = lambda x, w, b: kl.fused_layer_norm(x, w, b, 1e-5)
                    plain = lambda x, w, b: kl.fused_layer_norm_plain(x, w, b, 1e-5)
                elif name == "fused_group_norm":
                    args = (x, *affine(shape[1], dtype))
                    kern = lambda x, w, b: kg.fused_group_norm(x, w, b, groups, 1e-5, swish)
                    plain = lambda x, w, b: kg.fused_group_norm_plain(x, w, b, groups, 1e-5,
                                                                      swish)
                elif name == "group_norm_stats":
                    rows = kg.chunk_rows(x, groups)
                    args = (x,)
                    kern = lambda x: kg.group_norm_stats(x, groups, rows)
                    plain = lambda x: kg.group_norm_stats_plain(x, groups, rows)
                else:
                    rows = kg.chunk_rows(x, groups)
                    args = (x, kg.group_norm_stats_plain(x, groups, rows), *affine(shape[1], dtype))
                    kern = lambda x, p, w, b: kg.group_norm_apply(x, p, w, b, rows, 1e-5, swish)
                    plain = lambda x, p, w, b: kg.group_norm_apply_plain(x, p, w, b, 1e-5, swish)
            ref = plain(*args).float()
            err = (kern(*args).float() - ref).abs()
            mx, mean = err.max().item(), err.mean().item()
            row[f"{tag}_max_abs_err"], row[f"{tag}_mean_abs_err"] = mx, mean
            if name == "group_norm_stats":
                ok = mx / ref.abs().max().item() <= STATS_TOL
            elif tag == "bf16":
                ok = mx <= BF16_TOL[0] and mean <= BF16_TOL[1]
            else:
                ok = mx <= FP32_TOL
            if not ok:
                raise AssertionError(f"{name} {call} {tag} disagrees with its plain version: "
                                     f"{mx}, {mean}")
        out.setdefault(name, []).append(row)
    print(f"rank-local kernel calls of the parallel phase checked against their plain "
          f"versions, untimed: { {n: len(r) for n, r in out.items()} }", flush=True)
    return out


def attention_grad_phase():
    """Each attention entry under autograd at the GRAD_ROWS shapes, bf16 and
    fp32: its torch.autograd.Function (the kernel forward, the port's copy
    of the JAX backward) against autograd through its plain version on the
    same inputs and cotangent; q, k, v gradients within GRAD_TOL, the
    forward launching the kernel once a call; both forward+backward timed
    by CUDA events (host launch cost included)."""
    from stablediffusioneo_tpu_torch.ops import dispatch
    from stablediffusioneo_tpu_torch.ops.kernels import attention as ka

    g = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for name, q_shape, s, heads in GRAD_ROWS:
        kv_shape = q_shape[:-2] + (s, q_shape[-1]) if name == "fused_attention" \
            else (q_shape[0], s, q_shape[2])
        d = q_shape[-1] if name == "fused_attention" else q_shape[2] // heads
        scale = d ** -0.5
        if name == "fused_attention":
            kern = lambda q, k, v: ka.fused_attention(q, k, v, scale)
            plain = lambda q, k, v: ka.fused_attention_plain(q, k, v, scale)
        else:
            kern = lambda q, k, v, e=getattr(ka, name): e(q, k, v, heads, scale)
            plain = lambda q, k, v, e=getattr(ka, name + "_plain"): e(q, k, v, heads, scale)
        row = {"entry": name, "q": list(q_shape), "s": s, "heads": heads,
               "chunked": ka._chunked(s)}
        for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
            inputs = [torch.randn(shape, generator=g, device="cuda").to(dtype)
                      for shape in (q_shape, kv_shape, kv_shape)]
            cot = torch.randn(q_shape, generator=g, device="cuda").to(dtype)

            def grads(fn):
                xs = [t.detach().requires_grad_() for t in inputs]
                return torch.autograd.grad(fn(*xs), xs, cot)

            dispatch.reset_launches()
            got = grads(kern)
            launched = dispatch.launches[name]
            want = grads(plain)
            errs = [((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                    for a, b in zip(got, want)]
            row[f"{tag}_max_rel_err"] = max(errs)
            row[f"{tag}_ms"] = time_ms(lambda: grads(kern), warmup=2, reps=5)
            row[f"{tag}_plain_ms"] = time_ms(lambda: grads(plain), warmup=2, reps=5)
            print(f"attention grads {name} {q_shape} x {s} {tag}: dq/dk/dv max |d| / max "
                  f"|plain| {', '.join(f'{e:.2e}' for e in errs)}; forward+backward: kernel "
                  f"Function {row[f'{tag}_ms']:.3f} ms, plain autograd "
                  f"{row[f'{tag}_plain_ms']:.3f} ms; launches {launched}", flush=True)
            if launched != 1 or max(errs) > GRAD_TOL[dtype] or not all(
                    torch.isfinite(t).all() for t in got):
                raise AssertionError(f"attention grads {name} {q_shape} x {s} {tag}: {errs}, "
                                     f"{launched} launches")
            del inputs, cot, got, want
            torch.cuda.empty_cache()
        rows.append(row)
    return rows


# ------------------------------------------------- launches the plans imply


def has_control(cfg):
    """Whether the family's evaluation runs a ControlNet (SD-1.5, SD-2.1;
    not SDXL base)."""
    return hasattr(cfg, "controlnet")


def text_length(cfg):
    """Tokens of one prompt window: 77."""
    return next(getattr(cfg, t) for t in ("clip", "clip_l", "clip_g")
                if hasattr(cfg, t)).max_length


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


def site_variant(d, s):
    """The variant of csrc/attention.cu a bf16 call of head dim d over s keys
    runs on aligned views (ops/kernels/attention.py:attention_variant)."""
    from stablediffusioneo_tpu_torch.ops.kernels.attention import attention_variant

    return attention_variant(torch.bfloat16, d, s, s, True)


def add_variant(want, variant, n):
    """Adds n launches of `variant` to the count `want` (no entry for 0)."""
    if n:
        want[variant] = want.get(variant, 0) + n
    return want


def packed_variants(cfg, res, evals, ctx_len=None, tome_ratio=0.0, n_controlnets=1):
    """Packed and streaming attention launches of `evals` evaluations of the
    nets, by the variant each site runs in bf16."""
    want = {}
    for q_shape, s, heads in attention_sites(cfg, res, ctx_len=ctx_len, tome_ratio=tome_ratio,
                                             n_controlnets=n_controlnets):
        if attention_route(q_shape, s, torch.bfloat16):
            add_variant(want, site_variant(q_shape[2] // heads, s), evals)
    return want


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


def refiner_config():
    """The SDXL refiner's configuration of the "sdxl refiner 1024" run."""
    from stablediffusioneo_tpu_torch.models.sdxl import SDXLRefinerConfig

    return SDXLRefinerConfig()


def kernel_passes(cfg):
    """(name, configuration, resolution, context length, ToMe ratio) of each
    pass whose shapes the kernel phase takes: the SD-1.5 (cfg) 512x512
    request, its 1024x1024 hires pass, its long-prompt windows (S = 154,
    231) and token merging (S = 2048 at TOME_RATIO), then the SD-2.1 768x768,
    SDXL 1024x1024 and SDXL-refiner 1024x1024 requests (the 9-channel
    inpainting request takes the 512x512 request's shapes)."""
    sd21, sdxl = family_configs()
    window = text_length(cfg)
    return ([("sd15 512", cfg, RES, None, 0.0), ("sd15 hires 1024", cfg, HIRES_RES, None, 0.0)]
            + [(f"sd15 512, {n} windows", cfg, RES, n * window, 0.0) for n in (2, 3)]
            + [("sd15 512, tome 0.5", cfg, RES, None, TOME_RATIO),
               ("sd21 768", sd21, SD21_RES, None, 0.0),
               ("sdxl 1024", sdxl, SDXL_RES, None, 0.0),
               ("sdxl refiner 1024", refiner_config(), SDXL_RES, None, 0.0)])


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


def vit_tokens(res):
    """Tokens of a MiDaS ViT at a res x res input: 16-pixel patches and the
    class token (1,025 at 512x512, 577 at 384x384)."""
    return (res // 16) ** 2 + 1


def family_attention_rows(cfg):
    """{(entry, q shape, key length, heads): pass names} of the kernel-gated
    attention calls of the depth2img request (sd2_depth_pipeline at 512x512:
    the UNet alone, heads of 64 channels) and of the MiDaS ViTs at 512x512
    (split entry, head dim 64: DPT-L in the annotators row, the DPT-hybrid
    as MidasDetector(model_type="dpt_hybrid") runs it; at depth2img's 384x384
    its 577 tokens stay under the gate) and of UniFormer-S's stage 3 at a
    512x512 detection ((1, 5, 1024, 64), q / k / v views of its qkv
    projection as in the ViTs), where attention_rows(cfg) does not hold them
    already."""
    from stablediffusioneo_tpu_torch.config import sd2_depth_pipeline
    from stablediffusioneo_tpu_torch.ops.dispatch import ATTN_MIN_TQ

    have, rows = set(attention_rows(cfg)), {}
    depth = sd2_depth_pipeline()
    for q_shape, s, heads in attention_sites(depth, RES, n_controlnets=0):
        route = attention_route(q_shape, s, torch.bfloat16)
        if route and (route, q_shape, s, heads) not in have:
            rows.setdefault((route, q_shape, s, heads), ["depth2img 512"])
    for kind, path in (("dpt_large", "annotators:midas"),
                       ("dpt_hybrid", "midas dpt_hybrid 512")):
        t, h = vit_tokens(RES), VIT_HEADS[kind]
        if t >= ATTN_MIN_TQ:
            rows[("fused_attention", (1, h, t, 64), t, h)] = [path]
    t = uniformer_tokens(RES)
    if t >= ATTN_MIN_TQ:
        rows[("fused_attention", (1, UNIFORMER_HEADS, t, 64), t, UNIFORMER_HEADS)] = [
            "annotators:uniformer"]
    return rows


def mesh_sites(cfg, res, dtype, mesh, samples=1, norms=False):
    """Every kernel call one rank of a two-rank mesh makes in one process()
    request of `samples` images at res x res (x_T handed in: no encode), by
    the gates and the partition algebra the port applies (ops/attention.py,
    ops/norms.py): {"step": [(entry, call)], "decode": [...]}, "step" one
    evaluation of the nets on the rank's CFG batch. mesh: {"dp": 2},
    {"tp": 2} or {"sp": 2}. An attention call is (batch, heads, Tq, S, head
    dim) as the kernel launches it (tp: half the heads; sp: half the
    queries, where the algebra keeps them split, against the whole K/V),
    a norm call its input shape (and groups, swish): under sp, with the flag
    on (`norms`), a GroupNorm whose whole image's slab the kernel gate admits
    is a stats and an apply call on the rank's rows; elsewhere the card's
    rule (ops/norms.py) sends every norm to a kernel, flags or not, a
    LayerNorm on the rank's tokens; "prompt" is the text tower's
    LayerNorms."""
    from stablediffusioneo_tpu_torch.ops.attention import packed_partition
    from stablediffusioneo_tpu_torch.ops.dispatch import ATTN_MIN_TQ
    from stablediffusioneo_tpu_torch.ops.kernels.groupnorm import group_norm_supported

    dp, tp, sp = (mesh.get(k, 1) for k in ("dp", "tp", "sp"))
    local = samples // dp if samples % dp == 0 else samples
    item = torch.finfo(dtype).bits // 8

    def split_queries(b, tq, s, c, heads, nc=1):
        return (sp > 1 and tq % 128 == 0
                and packed_partition(b, tq, s, c, heads, item, ntq=sp, nc=nc)[1] > 1)

    out = {"step": [], "decode": [], "prompt": []}
    for (b, tq, c), s, heads in attention_sites(cfg, res, batch=2 * local):
        route = attention_route((b, tq, c), s, dtype)
        if route is None:
            continue
        d, lh = c // heads, heads // tp if heads % tp == 0 else heads
        ltq = tq // sp if split_queries(b, tq, s, c, heads, tp) else tq
        out["step"].append((route, (b, lh, ltq, s, d)))
    lat = res // cfg.vae.downsample_factor
    c = cfg.vae.ch * cfg.vae.ch_mult[-1]
    if lat * lat >= ATTN_MIN_TQ:
        t = lat * lat
        out["decode"].append(("fused_attention", (local, 1, t // sp if split_queries(
            local, t, t, c, 1) else t, t, c)))
    sites = norm_sites(cfg, res, samples=local)
    for part in ("step", "decode", "prompt"):
        for kind, shape, swish, groups in sites[part]:
            if kind == "gn" and sp > 1:
                if norms and group_norm_supported(shape, groups):
                    rows = (shape[0], shape[1], shape[2] // sp, shape[3])
                    out[part] += [("group_norm_stats", (rows, groups, swish)),
                                  ("group_norm_apply", (rows, groups, swish))]
            elif kind == "gn":
                out[part] += [(name, (shape, groups, swish))
                              for name in card_norm_entries((kind, shape, swish, groups))]
            else:
                tokens = (shape[0], shape[1] // sp, shape[2]) if part != "prompt" else shape
                out[part] += [(name, (tokens, 0, False))
                              for name in card_norm_entries((kind, tokens, swish, groups))]
    return out


def mesh_plan(cfg, res, steps, dtype, mesh, samples=1, norms=False):
    """(launches by kernel, attention launches by call) of one rank in one
    such request: `steps` evaluations and one decode."""
    sites = mesh_sites(cfg, res, dtype, mesh, samples, norms)
    calls = [c for c in sites["step"] for _ in range(steps)] + sites["decode"] + sites["prompt"]
    kernels = collections.Counter(name for name, _ in calls)
    shapes = collections.Counter(call for name, call in calls if name.startswith("fused_att"))
    return dict(kernels), dict(shapes)


def group_norm_rows(cfg):
    """(shape, groups, swish) of every gated GroupNorm site of a step, SD-1.5
    at 512x512 and SDXL at 1024x1024: the one-pass kernel's rows."""
    return sorted({(shape, groups, swish)
                   for pcfg, res in ((cfg, RES), (family_configs()[1], SDXL_RES))
                   for kind, shape, swish, groups in norm_sites(pcfg, res)["step"]
                   if kind == "gn" and gated((kind, shape, swish, groups), torch.bfloat16)})


def card_norm_rows(cfg):
    """The kernel phase's norm rows that the card's rule gives: {"pair":
    [(shape, groups, swish)] of every GroupNorm site of a step and a decode
    that goes to the stats + apply pair, SD-1.5 (cfg) at 512x512 and SDXL at
    1024x1024; "ln": [shape] of every LayerNorm site of a step and the
    prompt, those and SD-1.5's 1024x1024 hires pass}, each once, in site
    order."""
    out = {"pair": [], "ln": []}
    for pcfg, res, hires in ((cfg, RES, False), (cfg, HIRES_RES, True),
                             (family_configs()[1], SDXL_RES, False)):
        sites = norm_sites(pcfg, res)
        for site in sites["step"] + sites["decode"] + sites["prompt"]:
            kind, shape, swish, groups = site
            entries = card_norm_entries(site)
            if entries == ("fused_layer_norm",) and shape not in out["ln"]:
                out["ln"].append(shape)
            elif len(entries) == 2 and not hires and (shape, groups, swish) not in out["pair"]:
                out["pair"].append((shape, groups, swish))
    return out


def attention_row(name, call):
    """The kernel phase's row key (entry, q shape, key length, heads) of an
    attention call (batch, heads, Tq, S, head dim)."""
    b, heads, tq, s, d = call
    if name == "fused_attention":
        return name, (b, heads, tq, d), s, heads
    return name, (b, tq, heads * d), s, heads


def parallel_rows(cfg):
    """The rank-local kernel calls of parallel_phase's requests that the
    other passes do not give, {(entry, call): paths}: those of the bf16
    512x512 requests at tp=2 and sp=2 (fused norms on; timed rows), and
    those of the fp32 256x256 requests (checked against the plain versions,
    untimed)."""
    have = (set(attention_rows(cfg)) | set(family_attention_rows(cfg))
            | {("fused_layer_norm", (shape, 0, False)) for shape in layer_norm_shapes(cfg)}
            | {("fused_group_norm", site) for site in group_norm_rows(cfg)})
    timed, checked = {}, {}
    for rows, dtype, res, runs in ((timed, torch.bfloat16, RES, PARALLEL_BF16_RUNS),
                                   (checked, torch.float32, PARALLEL_RES, PARALLEL_FP32_RUNS)):
        for name, norms in runs:
            mesh = {name[:2]: int(name[3:])}
            sites = mesh_sites(cfg, res, dtype, mesh, 2 if "dp" in mesh else 1, norms)
            path = f"parallel {name}{', fused norms' if norms else ''} {str(dtype)[6:]}"
            for entry in sites["step"] + sites["decode"]:
                key = attention_row(*entry) if entry[0].startswith("fused_att") else entry
                if key in have or (rows is checked and entry in timed):
                    continue
                if path not in rows.setdefault(entry, []):
                    rows[entry].append(path)
    return timed, checked


def uniformer_tokens(res):
    """Tokens of UniFormer-S's stage 3 at a res x res detection (1/16 of the
    side: 1,024 at 512x512)."""
    return (res // 16) ** 2


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


NORM_ENTRIES = ("fused_group_norm", "group_norm_stats", "group_norm_apply", "fused_layer_norm")


def card_norm_entries(site):
    """The kernel entries a norm site launches on the card outside autograd,
    whatever the flags (ops/norms.py's rule; a site of the port's nets is
    contiguous bf16 or fp32, which the rule treats alike): one-pass
    GroupNorm, the stats + apply pair, or the LayerNorm."""
    from stablediffusioneo_tpu_torch.ops.norms import group_norm_route, layer_norm_route

    kind, shape, _, groups = site
    if kind == "gn":
        route = group_norm_route(shape, groups, torch.bfloat16, "contiguous", "cuda", False)
    else:
        route = layer_norm_route(shape, torch.bfloat16, "contiguous", "cuda", False)
    return {"one_pass": ("fused_group_norm",), "pair": ("group_norm_stats", "group_norm_apply"),
            "kernel": ("fused_layer_norm",)}.get(route, ())


def card_norm_launches(sites, times=1):
    """Launches of each norm entry of `times` runs of these sites on the card."""
    out = dict.fromkeys(NORM_ENTRIES, 0)
    for site in sites:
        for name in card_norm_entries(site):
            out[name] += times
    return out


def routes_on_kernels(routes):
    """Whether every norm call counted (ops/norms.py:route_counts) reached a
    kernel: none ran plain."""
    return bool(routes) and all(route in ("one_pass", "pair", "kernel") for _, route in routes)


def add_norms(want, *parts):
    """`want` (launches by kernel) with the norm entries' launches of these
    (sites, times) parts on the card added in place; returned."""
    for sites, times in parts:
        for name, n in card_norm_launches(sites, times).items():
            if n:
                want[name] = want.get(name, 0) + n
    return want


def _vit_norms(dim, blocks, tokens):
    """A MiDaS ViT's LayerNorms: two a block on (1, tokens, dim)."""
    return [("ln", (1, tokens, dim), False, 0)] * (2 * blocks)


def _resnetv2_norms(side):
    """The DPT-hybrid's ResNetV2 GroupNorms (annotators/midas_hybrid.py) on a
    side x side input: the stem's at 1/2, then each pre-activation
    bottleneck's three (the first block of stages 2 and 3 strides in its 3x3
    conv, between its second and third norm)."""
    from stablediffusioneo_tpu_torch.annotators.midas_hybrid import (
        GN_GROUPS,
        STAGE_BLOCKS,
        STAGE_MID,
        STAGE_OUT,
    )

    def gn(c, s):
        return ("gn", (1, c, s, s), False, GN_GROUPS)

    sites, cin, s = [gn(64, side // 2)], 64, side // 4
    for si, (n, cout, mid) in enumerate(zip(STAGE_BLOCKS, STAGE_OUT, STAGE_MID)):
        for bi in range(n):
            out = s // 2 if bi == 0 and si > 0 else s
            sites += [gn(cin if bi == 0 else cout, s), gn(mid, s), gn(mid, out)]
            s = out
        cin = cout
    return sites


def annotator_norms(kind, side):
    """The norm calls of one detection of an annotator net (batch 1) on a
    side x side input: the MiDaS ViTs' LayerNorms (and the hybrid's
    ResNetV2 GroupNorms), UniFormer-S's four patch-embedding LayerNorms and
    its SA blocks' two each; the other nets have none (BatchNorms)."""
    from stablediffusioneo_tpu_torch.annotators.uniformer import DEPTHS, DIMS

    if kind == "dpt_large":
        return _vit_norms(1024, VIT_BLOCKS[kind], vit_tokens(side))
    if kind == "dpt_hybrid":
        return _resnetv2_norms(side) + _vit_norms(768, VIT_BLOCKS[kind], vit_tokens(side))
    if kind == "uniformer":
        sites = []
        for si, (depth, dim) in enumerate(zip(DEPTHS, DIMS)):
            g = side // 2 ** (si + 2)
            sites.append(("ln", (1, g, g, dim), False, 0))
            if si >= 2:  # the SA stages
                sites += [("ln", (1, g * g, dim), False, 0)] * (2 * depth)
        return sites
    return []


def train_norms(cfg, res, batch):
    """The norm calls of one ControlNet train step that run outside
    autograd: the frozen UNet's encoder and middle block, which see no input
    that requires grad (the ControlNet's and the UNet decoder's norms run
    under grad, plain)."""
    return _unet_norms(cfg.unet, res // cfg.vae.downsample_factor, batch, False)


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


def request_passes(config):
    """(resolution, evaluations of the nets) of each sampling pass of a
    request of this run: the hires run's base pass, then its hires pass."""
    passes = [(run_res(config), run_evals(config))]
    return passes + ([(HIRES_RES, HIRES_T_ENC)] if config == "hires" else [])


def request_norm_parts(cfg, config):
    """(norm sites, times a request runs them) of a request of this run: each
    pass's evaluations, the decode of the last pass, the prompt (one tower
    call, the context windows as its batch), the encoder where the request
    encodes an image."""
    spec = RUNS[config]
    parts = [(norm_sites(cfg, res)["step"], evals) for res, evals in request_passes(config)]
    windows = spec.get("windows", 1)
    prompt = [(kind, (shape[0] * windows, *shape[1:]), swish, groups)
              for kind, shape, swish, groups in norm_sites(cfg, run_res(config))["prompt"]]
    parts += [(norm_sites(cfg, request_passes(config)[-1][0])["decode"], 1), (prompt, 1)]
    if spec.get("init") or spec.get("inpaint"):
        parts.append((_vae_encoder_norms(cfg.vae, RES, 1), 1))
    return parts


def expected_layer_norm_plans(cfg, config):
    """LayerNorm launches over the two timed requests of main_path, by the
    plan each site's shape gives (bf16 rows and weights, aligned): on the
    card every LayerNorm of the request reaches the kernel. None for the ToMe
    run, whose merged level-0 rows the sites do not list."""
    from stablediffusioneo_tpu_torch.ops.kernels.layernorm import layer_norm_plan

    if RUNS[config].get("process", {}).get("tome_ratio"):
        return None
    want = {}
    for sites, times in request_norm_parts(cfg, config):
        for site in sites:
            if card_norm_entries(site) == ("fused_layer_norm",):
                plan = layer_norm_plan(math.prod(site[1][:-1]), site[1][-1],
                                       torch.bfloat16, torch.bfloat16)
                want[plan] = want.get(plan, 0) + 2 * times
    return want


def run_ctx_len(cfg, config):
    return RUNS[config].get("windows", 1) * text_length(cfg)


def expected_request_variants(cfg, config, split):
    """Attention launches by variant over the two timed requests of
    main_path: every pass's packed sites, and `split` launches of the VAE's
    mid-block (head dim 512)."""
    tome_ratio = RUNS[config].get("process", {}).get("tome_ratio", 0.0)
    want = {}
    for res, n_steps in request_passes(config):
        for variant, n in packed_variants(cfg, res, n_steps, ctx_len=run_ctx_len(cfg, config),
                                          tome_ratio=tome_ratio).items():
            add_variant(want, variant, 2 * n)
    return add_variant(want, site_variant(512, 1), split)


def expected_request_launches(cfg, config):
    """Every kernel's launches over the two timed requests of main_path, and
    the attention launches by key length."""
    spec, steps = RUNS[config], run_evals(config)
    ctx_len = run_ctx_len(cfg, config)
    tome_ratio = spec.get("process", {}).get("tome_ratio", 0.0)
    want = dict.fromkeys(KERNELS, 0)
    passes = request_passes(config)
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
    for sites, times in request_norm_parts(cfg, config):
        for name, n in card_norm_launches(sites, times).items():
            want[name] += n
    if spec.get("int8"):
        want["quantized_matmul"] = steps * len(quant_gated(quant_sites(cfg, RES)))
    lat = passes[-1][0] // cfg.vae.downsample_factor  # the decoded pass
    by_key[lat * lat] = by_key.get(lat * lat, 0) + 2 * want["fused_attention"]
    return {name: 2 * n for name, n in want.items()}, by_key


# ------------------------------------------------------ model-level phases


def build_model(cfg, seed, n_controlnets=1):
    """A ControlLDM of `cfg` with seeded weights on the card, fp32 (the
    runtime casts it to cfg.dtype in place)."""
    from stablediffusioneo_tpu_torch.models.cldm import ControlLDM, seeded

    return seeded(lambda: ControlLDM(cfg, n_controlnets),
                  torch.Generator(device="cuda").manual_seed(seed))


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
    # the card's rule: every norm on a kernel, whatever the flags
    norms = card_norm_launches(norm_sites(cfg, 256)["step"])
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
    configuration of RUNS: "default", "int8" (512x512),
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
    from stablediffusioneo_tpu_torch.ops.norms import route_counts
    from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline

    spec = RUNS[config]
    int8 = bool(spec.get("int8"))
    dispatch.set_kernels(int8_linear=int8)
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
                    key_length_launches, route_counts):
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
    routes = dict(route_counts)
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
    want_ln = expected_layer_norm_plans(cfg, config)
    print(f"main path ({config}) norm calls by (norm, route): {routes}", flush=True)
    # every attention launch of the bf16 main path is a tensor-core variant
    want_variants = expected_request_variants(cfg, config, want["fused_attention"])
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
            or want_ln not in (None, ln)
            or sum(apply_plans.values()) != want["group_norm_apply"]
            or not routes_on_kernels(routes)):
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
    dispatch.set_kernels(int8_linear=False)
    return {"launches": launches, "key_lengths": key_lengths, "latencies": latencies,
            "eager_latency": eager_latency, "image": images[0], "traced": traced,
            "engines": engines, "replay_ms": replays}


def build_sdxl(seed):
    """SDXL base at full width (2.57 B UNet parameters), its weights drawn on
    the card from a seed, in bf16."""
    from stablediffusioneo_tpu_torch.models.cldm import seeded
    from stablediffusioneo_tpu_torch.models.sdxl import SDXL

    model = seeded(lambda: SDXL(family_configs()[1]),
                   torch.Generator(device="cuda").manual_seed(seed))
    return model.to(torch.bfloat16)


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
    from stablediffusioneo_tpu_torch.ops.norms import route_counts
    from stablediffusioneo_tpu_torch.runtime.engine import sdxl_sample_decode_engine

    cfg = model.cfg
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
    for counter in (variant_launches, gn_plans, ln_plans, key_length_launches, route_counts):
        counter.clear()
    images, latents, latencies = [], [], []
    for seed in (1, 2):
        t0 = time.perf_counter()
        img, z = sdxl_request(model, eng, ids, seed)
        latencies.append(time.perf_counter() - t0)
        latents.append(z.clone())
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
    routes = dict(route_counts)
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
          f"LayerNorm plans { {str(p): n for p, n in ln.items()} }; norm calls by (norm, "
          f"route) {routes}", flush=True)
    want_variants = expected_request_variants(cfg, config, want["fused_attention"])
    if (launches != want or key_lengths != want_keys
            or {k: v for k, v in variants.items() if v}
            != {k: v for k, v in want_variants.items() if v}
            or sum(gn.values()) != want["fused_group_norm"]
            or ln != expected_layer_norm_plans(cfg, config)
            or not routes_on_kernels(routes)):
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
    del eng, eager_eng
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "key_lengths": key_lengths, "latencies": latencies,
            "eager_latency": eager_latency, "image": images[0], "traced": traced,
            "engines": {f"sdxl+decode_{STEPS}x1x{SDXL_RES}x{SDXL_RES}": info},
            "replay_ms": replays, "text_towers_ms": towers_ms, "peak_bytes": peak,
            "warm_s": warm_s, "latents": latents[0]}


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
    and one decode's (split), its norm kernels' those of its evaluations,
    decode and prompt. Returns {sampler: replayed request seconds}."""
    from stablediffusioneo_tpu_torch.ops import dispatch
    from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline

    pipe = Canny2ImagePipeline(model, stand_in_tokenizer, cfg, device="cuda")
    img = smoke_image()
    kw = dict(num_samples=1, image_resolution=RES, ddim_steps=steps, scale=SCALE,
              eta=0.0, seed=1)
    ddim = pipe.process(img, PROMPT, **kw)[1]
    per_eval, per_decode = expected_launches(cfg, RES)
    sites = norm_sites(cfg, RES)
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
        want = add_norms({"fused_attention_packed": evals * per_eval["fused_attention_packed"],
                          "fused_attention": per_decode},
                         (sites["step"], evals), (sites["decode"], 1), (sites["prompt"], 1))
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
    imply (560 packed + 1 split a batch, whatever its size, and the norm
    kernels of its evaluations, decode and CLIP call); the first batch-4
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
    # a batch's norms: its evaluations, its decode and its one CLIP call (the
    # kernels' plan follows a sample's slab, not the batch)
    sites = norm_sites(cfg, RES)
    add_norms(want, (sites["step"], st["batches"] * STEPS), (sites["decode"], st["batches"]),
              (sites["prompt"], st["batches"]))
    img_s = SERVE_TIMED / elapsed
    # mean host ms of the batches' and requests' spans, and the batch's device ms
    span_ms = {name: round(v["mean_ms"], 1) for name, v in st["spans"].items()
               if name.startswith("serving.")}
    batch_device_ms = st["spans"].get("serving.dispatch", {}).get("mean_device_ms")
    print(f"serving [{card}]: {SERVE_TIMED} requests from {SERVE_CLIENTS} clients in "
          f"{elapsed:.3f} s: {img_s:.4f} img/s; batch_hist {st['batch_hist']}, mean queue "
          f"{st['mean_queue_ms']:.1f} ms, span means {span_ms} ms, batch device "
          f"{batch_device_ms} ms; "
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
            "span_ms": span_ms, "batch_device_ms": batch_device_ms, "warmup_s": warm_s,
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
    sites = norm_sites(cfg, RES)  # the UNet and one ControlNet an evaluation
    second = _unet_norms(cfg.controlnet.unet, RES // cfg.vae.downsample_factor, 2, False)
    add_norms(want, (sites["step"] + second, STEPS), (sites["decode"], 1), (sites["prompt"], 1))
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


# --------------------------------------- adapters and the last two families


def path_launches(cfg, res, evals, encodes=0):
    """Every kernel's launches over two requests of `evals` evaluations of a
    UNet-only family (no ControlNet runs, whatever the configuration's
    structural controlnet field; no fused norms, no int8) that decode once
    and encode `encodes` times, and the attention launches by key length."""
    want = dict.fromkeys(KERNELS, 0)
    step, per_decode = expected_launches(cfg, res, n_controlnets=0)
    for name, n in step.items():
        want[name] += evals * n
    by_key = {}
    for q_shape, s, _ in attention_sites(cfg, res, n_controlnets=0):
        if attention_route(q_shape, s, torch.bfloat16):
            by_key[s] = by_key.get(s, 0) + 2 * evals
    want["fused_attention"] = per_decode * (1 + encodes)
    lat = res // cfg.vae.downsample_factor
    by_key[lat * lat] = by_key.get(lat * lat, 0) + 2 * want["fused_attention"]
    return {name: 2 * n for name, n in want.items()}, by_key


def captured_path(config, build, cfg, res, evals, encodes=0, towers=()):
    """A main path over free-standing engines: build(capture) -> ({name:
    Engine}, request(seed) -> (uint8 image on the host, x_0 latents)). One
    warm-up request with engines built to capture (their capture seconds,
    graph nodes and pools, the peak memory), two timed replayed requests whose
    launches are held to `path_launches` (every bf16 attention launch on a
    tensor-core variant) and to the norms of the UNet's evaluations, the
    decode, the encodes and the request's `towers` ((sites, calls) of its
    text and depth towers), one eager request (engines built with
    capture=False) with the first one's seed, equal in bytes, one traced
    replayed request and one replay of each engine by CUDA events."""
    from stablediffusioneo_tpu_torch.ops import dispatch
    from stablediffusioneo_tpu_torch.ops.kernels.attention import (
        key_length_launches,
        variant_launches,
    )

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engines, request = build(True)
    request(0)
    warm_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    infos = {name: eng.get_engine_infor() for name, eng in engines.items()}
    print(f"{config} warm-up request: {warm_s:.3f} s, captures "
          + "; ".join(f"{n} {i['compile_seconds']:.3f} s, {i['device_ops']} graph nodes, "
                      f"pool {i['memory']['pool_bytes']} bytes" for n, i in infos.items())
          + f"; peak memory allocated {peak} bytes", flush=True)
    if not all(eng.compiled for eng in engines.values()):
        raise AssertionError(f"{config}: an engine was not captured")
    torch.cuda.synchronize()
    dispatch.reset_launches()
    for counter in (variant_launches, key_length_launches):
        counter.clear()
    images, latents, latencies = [], [], []
    lat = res // cfg.vae.downsample_factor
    for seed in (1, 2):
        t0 = time.perf_counter()
        img, z = request(seed)
        latencies.append(time.perf_counter() - t0)
        if not (torch.isfinite(z).all() and z.shape == (1, lat, lat, 4)
                and img.shape == (res, res, 3) and img.dtype == np.uint8):
            raise AssertionError(f"{config}: latents {tuple(z.shape)} not finite or image "
                                 f"{img.shape} {img.dtype}")
        images.append(img)
        latents.append(z.clone())
        print(f"{config} replayed request seed={seed}: {latencies[-1]:.4f} s; max |z| "
              f"{z.abs().max().item():.3f}", flush=True)
    launches, variants = dict(dispatch.launches), dict(variant_launches)
    key_lengths = {s: n for s, n in key_length_launches.items() if n}
    _, eager_request = build(False)
    t0 = time.perf_counter()
    eager = eager_request(1)[0]
    eager_latency = time.perf_counter() - t0
    differ = int((eager != images[0]).sum())
    print(f"{config} eager request seed=1: {eager_latency:.4f} s; bytes that differ from "
          f"the replayed image: {differ} of {eager.size}", flush=True)
    if differ:
        raise AssertionError(f"the replayed image ({config}) differs from the eager one "
                             f"in {differ} bytes")
    want, want_keys = path_launches(cfg, res, evals, encodes)
    lat = res // cfg.vae.downsample_factor
    add_norms(want, (_unet_norms(cfg.unet, lat, 2, True), 2 * evals),
              (_vae_norms(cfg.vae, lat, 1), 2), (_vae_encoder_norms(cfg.vae, res, 1), 2 * encodes),
              *((sites, 2 * calls) for sites, calls in towers))
    want_keys = {s: n for s, n in want_keys.items() if n}
    want_variants = add_variant(
        {variant: 2 * n for variant, n in packed_variants(cfg, res, evals,
                                                          n_controlnets=0).items()},
        site_variant(512, 1), want["fused_attention"])
    print(f"{config} kernel launches over the 2 replayed requests: {launches} (expected "
          f"{want}); by key length {key_lengths} (expected {want_keys}); by variant "
          f"{variants}", flush=True)
    if (launches != want or key_lengths != want_keys
            or {k: v for k, v in variants.items() if v} != want_variants):
        raise AssertionError(f"{config} launches {launches}, {key_lengths}, {variants} != "
                             f"{want}, {want_keys}")
    if np.array_equal(images[0], images[1]):
        raise AssertionError(f"{config}: two seeds gave the same image")
    print(f"{config} image stats: mean {images[0].mean():.2f} std {images[0].std():.2f}",
          flush=True)
    trace = traced_request(lambda: request(3))
    traced = None
    if trace is None:
        print(f"{config} traced replayed request: not measured (the profiler gave no "
              "device events)", flush=True)
    else:
        ms, parts, n_ops = trace
        traced = {"device_ms": ms, "device_ops": n_ops,
                  **{f"{family}_ms": part for family, part in parts.items()}}
        print(f"{config} traced replayed request: device time {ms:.1f} ms in {n_ops} device "
              "operations; this package's kernels, ms: "
              + ", ".join(f"{family} {part:.1f}" for family, part in parts.items()),
              flush=True)
    replays = {}
    for name, eng in engines.items():
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        eng.replay()
        end.record()
        torch.cuda.synchronize()
        replays[name] = start.elapsed_time(end)
    print(f"{config} one replay of each engine by CUDA events, ms: "
          + ", ".join(f"{n} {ms:.1f}" for n, ms in replays.items()), flush=True)
    del engines
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "key_lengths": key_lengths, "latencies": latencies,
            "eager_latency": eager_latency, "image": images[0], "latents": latents[0],
            "traced": traced, "engines": infos, "replay_ms": replays, "peak_bytes": peak,
            "warm_s": warm_s}


def seeded_adapter(net, seed, directory, on):
    """A rank-LORA_RANK adapter on DEFAULT_TARGETS of the port's network
    `net`, b drawn non-zero, through save_lora and load_lora (the
    sdeo-lora-v1 file); returns (adapter, metadata)."""
    from stablediffusioneo_tpu_torch.training.lora import init_lora, load_lora, save_lora

    g = torch.Generator(device="cuda").manual_seed(seed)
    tree = init_lora(g, net, rank=LORA_RANK)

    def fill(node):
        for k, v in node.items():
            if isinstance(v, dict):
                fill(v)
            elif k == "b":
                node[k] = torch.randn(v.shape, generator=g, device="cuda") * LORA_B_STD

    fill(tree)
    path = os.path.join(directory, f"{on}_lora.npz")
    save_lora(path, tree, alpha=LORA_ALPHA, rank=LORA_RANK, on=on)
    return load_lora(path)


def graphs_of(rt):
    """{engine key: its CUDA graph object} of a runtime's captured engines."""
    return {k: e._graph for k, e in rt._engines.items() if e.compiled}


def lora_phase(model, cfg, tokenizer):
    """LoRA on the SD-1.5 ControlNet model at 512x512, 20 steps, merged into
    the engines captured before the merge: a seeded adapter for the UNet,
    the ControlNet and CLIP each, through an sdeo-lora-v1 file; scale 0 gives
    the base image in bytes; then each merged at alpha / rank (site counts,
    seconds a merge): the same engines (no new capture) replay the merged
    weights, another image, replay = eager in bytes, 560 packed + 1 split
    launches a request."""
    from stablediffusioneo_tpu_torch.ops import dispatch
    from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline

    pipe = Canny2ImagePipeline(model, tokenizer, cfg, device="cuda")
    rt = pipe.runtime
    img, kw = smoke_image(), run_kwargs("default")
    base = pipe.process(img, PROMPT, seed=1, **kw)[1]
    graphs = graphs_of(rt)
    nets = {"unet": rt.model.unet, "controlnet": rt.model.control, "clip": rt.model.clip}
    with tempfile.TemporaryDirectory() as directory:
        adapters = {on: seeded_adapter(net, 10 + i, directory, on)
                    for i, (on, net) in enumerate(nets.items())}
    for on, (tree, _) in adapters.items():
        rt.apply_lora(tree, scale=0.0, on=on)
    zero = pipe.process(img, PROMPT, seed=1, **kw)[1]
    if not np.array_equal(zero, base):
        raise AssertionError(f"apply_lora(scale=0) changed {(zero != base).sum()} bytes")
    sites, merge_s = {}, {}
    for on, (tree, meta) in adapters.items():
        t0 = time.perf_counter()
        sites[on] = rt.apply_lora(tree, scale=meta["alpha"] / meta["rank"], on=on)
        merge_s[on] = time.perf_counter() - t0
    print(f"lora: rank {LORA_RANK}, alpha {LORA_ALPHA}; sites merged {sites}; seconds a "
          f"merge {merge_s}", flush=True)
    dispatch.reset_launches()
    t0 = time.perf_counter()
    merged = pipe.process(img, PROMPT, seed=1, **kw)[1]
    latency = time.perf_counter() - t0
    launches = dict(dispatch.launches)
    same = graphs_of(rt)
    rt.graphs = False
    eager = pipe.process(img, PROMPT, seed=1, **kw)[1]
    rt.graphs = None
    want = {k: n // 2 for k, n in expected_request_launches(cfg, "default")[0].items() if n}
    print(f"lora: merged request {latency:.4f} s replayed; {len(same)} captured engines "
          f"before and after the merge ({len(graphs)} before), the same graphs: "
          f"{same == graphs}; the image differs from the base in "
          f"{int((merged != base).sum())} bytes, from the eager request in "
          f"{int((merged != eager).sum())}; launches {launches}", flush=True)
    if (same != graphs or np.array_equal(merged, base) or not np.array_equal(merged, eager)
            or {k: v for k, v in launches.items() if v} != want):
        raise AssertionError(f"lora phase failed: same engines {same == graphs}, launches "
                             f"{launches} (expected {want})")
    return pipe, {"sites": sites, "merge_s": merge_s, "request_s": latency}


def two_token_word(tokenizer):
    """A word the BPE tokenizer takes as exactly two tokens."""
    for word in ("house", "woods", "light", "river", "garden", "stone", "door", "hill",
                 "red", "old", "mist", "rose"):
        if len(tokenizer.encode(word)) == 2:
            return word
    raise AssertionError("no two-token word among the candidates")


def textual_inversion_phase(pipe, tokenizer):
    """Textual inversion on a live runtime (the LoRA phase's pipeline): a
    2-vector concept made of the embedding rows of a two-token word gives
    that word's image in bytes, a concept of random vectors another image;
    only the CLIP engines are evicted (and captured again), the sample+decode
    engine is not captured again."""
    from stablediffusioneo_tpu_torch.checkpoint.textual_inversion import (
        apply_textual_inversion,
        token_embedding,
    )

    rt = pipe.runtime
    img, kw = smoke_image(), run_kwargs("default")
    word = two_token_word(tokenizer)
    prompt = f"a {word} in the woods"
    want = pipe.process(img, prompt, seed=1, **kw)[1]
    before = graphs_of(rt)
    rows = token_embedding(rt.model.clip).weight[tokenizer.encode(word)].float().cpu()
    g = torch.Generator().manual_seed(3)
    n = apply_textual_inversion(rt, tokenizer, {"<clone>": rows.numpy()})
    n += apply_textual_inversion(rt, tokenizer, {"<rand>": (torch.randn(
        (2, rows.shape[1]), generator=g) * 0.02).numpy()})
    evicted = {k for k in before if k[0] == "clip"} - set(rt._engines)
    clone = pipe.process(img, "a <clone> in the woods", seed=1, **kw)[1]
    rand = pipe.process(img, "a <rand> in the woods", seed=1, **kw)[1]
    after = graphs_of(rt)
    recaptured = {k for k in after if k[0] == "clip"}
    kept = {k: g for k, g in before.items() if k[0] != "clip"}
    print(f"textual inversion: {n} rows added; the word {word!r} is "
          f"{tokenizer.encode(word)}; CLIP engines evicted {len(evicted)}, captured again "
          f"{len(recaptured)}; the other {len(kept)} engines kept: "
          f"{all(after.get(k) is g for k, g in kept.items())}; the <clone> image differs "
          f"from the word's in {int((clone != want).sum())} bytes, the <rand> image in "
          f"{int((rand != want).sum())}", flush=True)
    if not (n == 4 and evicted and len(recaptured) == len(evicted)
            and all(after.get(k) is g for k, g in kept.items()) and len(after) == len(before)
            and np.array_equal(clone, want) and not np.array_equal(rand, want)):
        raise AssertionError("textual-inversion phase failed")
    pipe.runtime.release()
    return {"rows": n, "clip_engines_evicted": len(evicted),
            "clip_engines_recaptured": len(recaptured)}


def inpaint_build(model, ids):
    """captured_path's build of the 9-channel inpainting request at 512x512:
    the text tower eagerly (no kernel at 77 tokens), the masked-image encode
    in encoder_engine (posterior mode), inpaint_to_concat, then
    concat_sample_decode_engine (20 DDIM steps, scale 9) on x_T drawn from
    the seed."""
    from stablediffusioneo_tpu_torch.models.clip import clip_text_apply
    from stablediffusioneo_tpu_torch.pipeline.concat_cond import inpaint_to_concat
    from stablediffusioneo_tpu_torch.runtime.engine import (
        concat_sample_decode_engine,
        encoder_engine,
    )

    dtype = next(model.parameters()).dtype
    img = torch.from_numpy(smoke_source()[None].astype(np.float32) / 127.5 - 1.0).to(
        "cuda", dtype)
    mask = torch.from_numpy(smoke_mask()[None].astype(np.float32) / 255.0).to("cuda")
    lat = RES // model.cfg.vae.downsample_factor

    def build(capture):
        enc = encoder_engine(model, 1, RES, RES, deterministic=True, capture=capture)
        eng = concat_sample_decode_engine(model, STEPS, 1, RES, RES, capture=capture)

        def request(seed):
            with torch.no_grad():
                ctx = clip_text_apply(model.clip, ids).to(dtype)
                c_concat = inpaint_to_concat(model.first_stage_model, img, mask,
                                             encode=enc).to(dtype)
            x = torch.randn((1, lat, lat, 4), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(seed))
            out, z = eng(x.to(dtype), c_concat, ctx[:1], ctx[1:],
                         torch.full((1,), SCALE, device="cuda"))
            return out[0].cpu().numpy(), z

        return {enc.name: enc, eng.name: eng}, request

    return build


def inpaint_phase(tokenizer):
    """The 9-channel inpainting model (sd15_inpaint_pipeline(), full width,
    seeded) at 512x512, 20 DDIM steps, scale 9, batch 1, a rectangular mask,
    as a main path (captured_path; 400 packed + 2 split launches a request:
    20 an evaluation of the UNet alone, the masked-image encode and the
    decode); then its state dict in the
    sd-v1-5-inpainting layout through a torch.save'd file and
    load_inpaint_pipeline: every key consumed or named, none orphaned, the
    same image in bytes."""
    from stablediffusioneo_tpu_torch.checkpoint import load_inpaint_pipeline
    from stablediffusioneo_tpu_torch.config import sd15_inpaint_pipeline
    from stablediffusioneo_tpu_torch.models.cldm import LatentDiffusion, seeded

    cfg = sd15_inpaint_pipeline()
    model = seeded(lambda: LatentDiffusion(cfg), torch.Generator(device="cuda").manual_seed(0))
    model = model.to(torch.bfloat16)
    ids = torch.as_tensor(np.asarray(tokenizer([PROMPT, ""])), dtype=torch.long,
                          device="cuda")
    run = captured_path("inpaint 9ch", inpaint_build(model, ids), cfg, RES, STEPS,
                        encodes=1, towers=[(_tower_norms(cfg.clip), 1)])
    sd = dict(model.state_dict())
    extra = {"betas": torch.linspace(1e-4, 2e-2, 1000),
             "cond_stage_model.transformer.text_model.embeddings.position_ids":
                 torch.arange(77)[None]}
    with tempfile.TemporaryDirectory() as directory:
        path = os.path.join(directory, "sd-v1-5-inpainting_seeded.ckpt")
        t0 = time.perf_counter()
        torch.save({"state_dict": {**sd, **extra}}, path)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        loaded = load_inpaint_pipeline(path, cfg, device="cuda", dtype=torch.bfloat16)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    report = loaded.load_report
    print(f"inpaint checkpoint: {len(sd) + len(extra)} keys, {size} bytes written in "
          f"{save_s:.2f} s, loaded onto the card in {load_s:.2f} s; consumed "
          f"{len(report.consumed)}, ignored {sorted(report.ignored)}, orphans "
          f"{len(report.orphans)}", flush=True)
    if not (report.complete and len(report.consumed) == len(sd)
            and report.ignored == set(extra)):
        raise AssertionError(f"inpaint checkpoint load: {report.problems()}")
    del sd, model
    engines, request = inpaint_build(loaded, ids)(True)
    out = request(1)[0]
    differ = int((out != run["image"]).sum())
    print(f"inpaint checkpoint: the loaded model's request seed=1 differs from the seeded "
          f"model's image in {differ} bytes", flush=True)
    if differ:
        raise AssertionError(f"the loaded inpainting model gives another image ({differ})")
    del engines, request, loaded
    gc.collect()
    torch.cuda.empty_cache()
    run["checkpoint"] = {"keys": len(report.consumed) + len(report.ignored), "bytes": size,
                         "save_s": save_s, "load_s": load_s}
    return run


# ---------------------------------------------------------------- annotators


def seeded_batch_norms(net, generator):
    """`net`'s BatchNorms moved off the identity that init_weights leaves:
    gains 1 + 0.1 N(0, 1), shifts, means 0.1 N(0, 1), variances U(0.5, 1.5),
    drawn from `generator` (on the net's device)."""
    from stablediffusioneo_tpu_torch.ops.layers import FrozenBatchNorm2d

    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (torch.nn.BatchNorm2d, FrozenBatchNorm2d)):
                c, dev = m.weight.shape, m.weight.device
                m.weight.copy_(1.0 + 0.1 * torch.randn(c, generator=generator, device=dev))
                m.bias.copy_(0.1 * torch.randn(c, generator=generator, device=dev))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=generator, device=dev))
                m.running_var.copy_(0.5 + torch.rand(c, generator=generator, device=dev))
    return net


def annotator_net(kind, generator):
    """A seeded full-width annotator net of `kind` on the generator's device,
    fp32 (a BatchNorm net's statistics drawn too), and its forward on an
    NCHW input."""
    from stablediffusioneo_tpu_torch.annotators.hed import init_hed
    from stablediffusioneo_tpu_torch.annotators.midas import init_dpt
    from stablediffusioneo_tpu_torch.annotators.midas_hybrid import init_dpt_hybrid
    from stablediffusioneo_tpu_torch.annotators.mlsd_net import init_mlsd_large
    from stablediffusioneo_tpu_torch.annotators.openpose import init_body
    from stablediffusioneo_tpu_torch.annotators.uniformer import init_uniformer

    net = {"dpt_large": init_dpt, "dpt_hybrid": init_dpt_hybrid, "hed": init_hed,
           "openpose_body": init_body, "mlsd_large": init_mlsd_large,
           "uniformer": init_uniformer}[kind](generator)
    if kind in ("mlsd_large", "uniformer"):
        seeded_batch_norms(net, generator)
    return net.eval().requires_grad_(False)


def card_vs_cpu(label, net, x, want, forward=None):
    """`net` (fp32, on the card: through the kernels) against its copy on the
    CPU (plain versions) on the CPU tensor x, TF32 off; forward(net, x)
    gives the output or a list of them (default net(x)). Fails unless every
    output is finite and within REF_TOL x max |ref| and the card's launches
    equal `want`."""
    from stablediffusioneo_tpu_torch.ops import dispatch

    forward = forward or (lambda n, t: n(t))
    cpu = copy.deepcopy(net).cpu()
    dispatch.reset_launches()
    with torch.no_grad():
        t0 = time.perf_counter()
        card = forward(net, x.cuda())
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches = {k: v for k, v in dispatch.launches.items() if v}
        t0 = time.perf_counter()
        ref = forward(cpu, x)
        cpu_s = time.perf_counter() - t0
    outs = [(c.cpu(), r) for c, r in zip(card if isinstance(card, (list, tuple)) else [card],
                                         ref if isinstance(ref, (list, tuple)) else [ref])]
    errs = [((c - r).abs().max().item(), r.abs().max().item()) for c, r in outs]
    print(f"{label}, fp32: card vs CPU max|d| / max|ref| "
          f"{[f'{e:.3e} / {m:.3e}' for e, m in errs]}; card {card_s:.2f} s (first call), "
          f"CPU {cpu_s:.2f} s; launches {launches} (expected {want})", flush=True)
    if not (all(torch.isfinite(c).all() for c, _ in outs)
            and all(e <= REF_TOL * m for e, m in errs) and launches == want):
        raise AssertionError(f"{label} card vs CPU failed: {errs}, {launches}")
    return {"max_rel_err": max(e / m for e, m in errs), "launches": launches,
            "card_first_s": card_s, "cpu_s": cpu_s}


def annotator_reference():
    """The annotator nets at full width in fp32, card (through the kernels:
    DPT-L's 24 ViT blocks at 1,025 tokens and UniFormer's 8 stage-3 blocks
    at 1,024 launch the split entry) against the same weights on the CPU
    (plain versions), TF32 off: DPT-L at 512x512, the DPT-hybrid at 384x384
    (577 tokens: plain attention), HED at 512x512, the body net at 368x368,
    MLSD (a 4-channel input in [-1, 1]) and UniFormer + UperNet at 512x512;
    within REF_TOL x max |ref| for every output; every LayerNorm and
    GroupNorm of the nets on its kernel (annotator_norms)."""
    from stablediffusioneo_tpu_torch.ops.dispatch import ATTN_MIN_TQ

    out = {}
    for kind, side in ANNOTATOR_REFERENCE:
        net = annotator_net(kind, torch.Generator(device="cuda").manual_seed(5))
        gen = torch.Generator().manual_seed(6)
        if kind == "mlsd_large":
            x = torch.rand((1, 4, side, side), generator=gen) * 2 - 1
        else:
            x = torch.randn((1, 3, side, side), generator=gen)
        if kind in ("hed",):
            x = (x * 60 + 120).clamp(0, 255)  # raw pixel values
        want = ({"fused_attention": VIT_BLOCKS[kind]}
                if kind in VIT_BLOCKS and vit_tokens(side) >= ATTN_MIN_TQ else {})
        if kind == "uniformer" and uniformer_tokens(side) >= ATTN_MIN_TQ:
            want = {"fused_attention": UNIFORMER_SA_BLOCKS}
        add_norms(want, (annotator_norms(kind, side), 1))
        out[kind] = {"side": side, **card_vs_cpu(f"annotator reference ({kind} {side}x{side})",
                                                 net, x, want)}
        del net
        gc.collect()
        torch.cuda.empty_cache()
    return out


def annotator_image():
    """The JAX bench's annotators-row input image."""
    rng = np.random.default_rng(ANNOTATOR_IMAGE_SEED)
    return (rng.random((RES, RES, 3)) * 255).astype(np.uint8)


def make_detector(family):
    """The family's detector on the card, seeded weights, as the JAX bench
    builds it (MiDaS: dpt_large)."""
    from stablediffusioneo_tpu_torch.annotators import (
        CannyDetector,
        HEDdetector,
        MidasDetector,
        OpenposeDetector,
    )

    return {"canny": CannyDetector, "hed": HEDdetector,
            "midas": lambda: MidasDetector(model_type="dpt_large"),
            "openpose": OpenposeDetector}[family]()


def detector_requests(pipe, cfg, family, build, hint, splits, norms=()):
    """One detector as the annotator of process() on the pipeline's model:
    `build()` makes it on the card (its seconds and weight bytes); its map
    alone (the peak memory of one call above what was allocated before it,
    the hint variant process() takes for it, which must be `hint`); then one
    warm process() and two timed ones at RES x RES, STEPS steps, scale 9,
    seed 1: p50 and preprocess_ms. Held: every request's launches are the
    default request's (560 packed + 1 split) plus the detector's own split
    launches, `splits` ({key length: launches a request}), on the
    tensor-core variants, and its norm kernels' (`norms`, the sites of one
    detection); the sample engine is the hint variant's."""
    from stablediffusioneo_tpu_torch.annotators import CannyDetector
    from stablediffusioneo_tpu_torch.annotators.util import HWC3
    from stablediffusioneo_tpu_torch.ops import dispatch
    from stablediffusioneo_tpu_torch.ops.kernels.attention import (
        key_length_launches,
        variant_launches,
    )

    img = annotator_image()
    kw = dict(num_samples=1, image_resolution=RES, ddim_steps=STEPS)
    base, base_keys = expected_request_launches(cfg, "default")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    det = build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    weights = torch.cuda.memory_allocated() - before
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    raw = pipe._annotate(img, 100, 200, det)[1]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - start
    variant = "bithint" if pipe._pack_hint(HWC3(raw), raw) is not None else "uint8"
    pipe.apply_canny = det
    t0 = time.perf_counter()
    pipe.process(img, ANNOTATOR_PROMPT, seed=1, **kw)
    warm_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    dispatch.reset_launches()
    for counter in (variant_launches, key_length_launches):
        counter.clear()
    times, pre = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        res = pipe.process(img, ANNOTATOR_PROMPT, seed=1, **kw)
        times.append(time.perf_counter() - t0)
        pre.append(pipe.last_timings["preprocess_ms"])
    launches = dict(dispatch.launches)
    variants = {k: v for k, v in variant_launches.items() if v}
    key_lengths = {k: v for k, v in key_length_launches.items() if v}
    extra = 2 * sum(splits.values())
    want = add_norms({**base, "fused_attention": base["fused_attention"] + extra}, (norms, 2))
    want_keys = dict(base_keys)
    for s, n in splits.items():
        want_keys[s] = want_keys.get(s, 0) + 2 * n
    want_variants = expected_request_variants(cfg, "default", base["fused_attention"])
    for s, n in splits.items():  # the ViTs' and UniFormer's heads of 64 channels
        add_variant(want_variants, site_variant(64, s), 2 * n)
    names = sorted(e.name for e in pipe.runtime._engines.values()
                   if e.name.startswith("ddim+decode"))
    p50 = statistics.median(times)
    print(f"annotators ({family}): p50 {p50 * 1e3:.1f} ms over {times} s (warm-up "
          f"{warm_s:.2f} s), preprocess_ms {pre}; detector built in {build_s:.2f} s, "
          f"weights {weights} bytes, one call's peak {peak} bytes; map "
          f"{raw.shape} {raw.dtype} ({int((raw > 0).sum())} non-zero) -> the {variant} hint; "
          f"sample engines {names}; launches {launches} by variant {variants} by key length "
          f"{key_lengths}", flush=True)
    wanted = f"ddim+decode_{STEPS}x1x{RES}x{RES}" + ("_bithint" if variant == "bithint"
                                                    else "")
    if (variant != hint or wanted not in names
            or not (res[1].shape == (RES, RES, 3) and res[1].dtype == np.uint8)):
        raise AssertionError(f"annotators ({family}): {variant} hint, engines {names}")
    if (launches != want or key_lengths != want_keys or variants != want_variants):
        raise AssertionError(f"annotators ({family}) launches {launches}, {key_lengths}, "
                             f"{variants} != {want}, {want_keys}, {want_variants}")
    pipe.apply_canny = CannyDetector()
    del det
    gc.collect()
    torch.cuda.empty_cache()
    return {"p50_s": p50, "request_s": times, "warm_s": warm_s, "preprocess_ms": pre,
            "detector_build_s": build_s, "detector_weight_bytes": weights,
            "detector_peak_bytes": peak, "hint": variant, "launches": launches,
            "key_lengths": key_lengths, "map_nonzero": int((raw > 0).sum())}


def annotators_phase(model, cfg, tokenizer):
    """The JAX bench's annotators row (tracked config 4) on the loaded SD-1.5
    model: for Canny, HED, MiDaS dpt_large and OpenPose (seeded weights),
    detector_requests: each family's p50 and preprocess_ms, the worst p50,
    the detector's weight bytes and peak memory. Held: every request's
    launches are the default request's (560 packed + 1 split), plus MiDaS's
    24 split launches at 1,025 tokens; Canny's map takes the bit-packed hint
    engine and the others' maps (not binary) the uint8 one."""
    from stablediffusioneo_tpu_torch.ops.dispatch import ATTN_MIN_TQ
    from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline

    pipe = Canny2ImagePipeline(model, tokenizer, cfg, device="cuda")
    out = {}
    for family in ANNOTATOR_FAMILIES:
        vit = ({vit_tokens(RES): VIT_BLOCKS["dpt_large"]}
               if family == "midas" and vit_tokens(RES) >= ATTN_MIN_TQ else {})
        out[family] = detector_requests(pipe, cfg, family, lambda: make_detector(family),
                                        "bithint" if family == "canny" else "uint8", vit,
                                        annotator_norms("dpt_large", RES)
                                        if family == "midas" else ())
    worst = max(r["p50_s"] for r in out.values())
    print(f"annotators: canny2image_{RES}x{RES}_{STEPS}step_multi_annotator_worst_p50 "
          f"{worst:.4f} s ({ {f: round(r['p50_s'], 4) for f, r in out.items()} })",
          flush=True)
    pipe.runtime.release()
    return {"worst_p50_s": worst, "families": out}


def detector_file_phase(model, cfg, tokenizer, directory):
    """MLSD and UniFormer on the loaded SD-1.5 model, after the annotators
    row: each a seeded full-width net (annotator_net: BatchNorm statistics
    drawn) written by torch.save under its upstream file name, read back by
    the detector's ckpt_path with strict accounting (all 344 / 398 keys),
    then detector_requests. MLSD runs at MLSD_THRESHOLDS (process() hands an
    annotator the Canny thresholds, which MLSDdetector would take as its
    own); its map is binary and takes the bit-packed hint. UniFormer's
    coloured map takes the uint8 hint, and each detection launches the split
    kernel once for each of stage 3's 8 blocks at 1,024 tokens."""
    import functools

    from stablediffusioneo_tpu_torch.annotators.mlsd import MLSDdetector
    from stablediffusioneo_tpu_torch.annotators.uniformer import UniformerDetector
    from stablediffusioneo_tpu_torch.ops.dispatch import ATTN_MIN_TQ
    from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline

    pipe = Canny2ImagePipeline(model, tokenizer, cfg, device="cuda")
    out = {}
    for family, (kind, filename) in FILE_DETECTORS.items():
        net = annotator_net(kind, torch.Generator().manual_seed(9))
        path = os.path.join(directory, filename)
        keys = len(net.state_dict())
        torch.save(net.state_dict(), path)
        del net
        if family == "mlsd":
            def build():
                return functools.partial(MLSDdetector(ckpt_path=path), thr_v=MLSD_THRESHOLDS[0],
                                         thr_d=MLSD_THRESHOLDS[1])
            hint, splits, norms = "bithint", {}, ()
        else:
            def build():
                return UniformerDetector(ckpt_path=path)
            t = uniformer_tokens(RES)
            hint, splits = "uint8", ({t: UNIFORMER_SA_BLOCKS} if t >= ATTN_MIN_TQ else {})
            norms = annotator_norms("uniformer", RES)
        out[family] = {"file_keys": keys, "file_bytes": os.path.getsize(path),
                       **detector_requests(pipe, cfg, family, build, hint, splits, norms)}
        os.remove(path)
        if not out[family]["map_nonzero"]:
            raise AssertionError(f"{family}: an empty map")
    pipe.runtime.release()
    return out


def yolo_phase(directory):
    """The JAX bench's yolo row (cli/bench.py:_bench_yolo) on the port:
    YOLOv5s with seeded weights (init_yolov5(0) on the CPU, BatchNorm
    statistics drawn) written under the upstream names and read back by
    load_yolov5 (strict accounting); the net in fp32 card vs CPU at
    YOLO_REF_SIDE within REF_TOL, boxes and scores each to its own max |ref|;
    then the request of the row on the net load_yolov5 gives by default (the
    card, bf16): a 720x1280 image from default_rng(0), letterboxed to
    1120x1120 by PreProcessor, uploaded as uint8, yolov5_detect k=300 on the
    device (fp32 decode), PostProcessor (0.99, 0.45) on the host: 1 warm-up
    and YOLO_TIMED timed requests (p50, img/s), the detect call alone by CUDA
    events. Held: predictions (1, 300, 85), finite, sorted by objectness, the
    top 300 rows of the card's full prediction tensor on the same image;
    that tensor and those rows, boxes and scores apart, within YOLO_BF16_TOL
    x max |ref| of the fp32 net on the CPU (the same rows); no kernel of this
    package launched (convolutions only)."""
    from stablediffusioneo_tpu_torch.ops import dispatch
    from stablediffusioneo_tpu_torch.yolo import (
        PostProcessor,
        PreProcessor,
        init_yolov5,
        load_yolov5,
        yolov5_detect,
    )
    from stablediffusioneo_tpu_torch.yolo.model import yolov5_apply

    def boxes_and_scores(net, x):
        pred = yolov5_apply(net, x)
        return [pred[..., :4], pred[..., 4:]]

    net = seeded_batch_norms(init_yolov5(0, device="cpu"), torch.Generator().manual_seed(10))
    path = os.path.join(directory, "yolov5s.pt")
    torch.save(net.state_dict(), path)
    x = torch.rand((1, 3, YOLO_REF_SIDE, YOLO_REF_SIDE), generator=torch.Generator().manual_seed(11))
    ref = card_vs_cpu(f"yolov5s {YOLO_REF_SIDE}x{YOLO_REF_SIDE}", net.cuda(), x, {},
                      forward=boxes_and_scores)
    del net
    card = load_yolov5(ckpt_path=path)
    cpu = load_yolov5(ckpt_path=path, device="cpu")
    keys = len(card.state_dict())
    os.remove(path)
    dtype = next(card.parameters()).dtype
    if dtype != torch.bfloat16 or next(cpu.parameters()).dtype != torch.float32:
        raise AssertionError(f"yolo: load_yolov5 gave {dtype} on the card")
    pre = PreProcessor(YOLO_SIDE, YOLO_SIDE)
    img = (np.random.default_rng(0).random((*YOLO_IMAGE, 3)) * 255).astype(np.uint8)
    _, _, left, top = pre(img)
    post = PostProcessor(YOLO_CONF, YOLO_IOU, left, top, img.shape[1] / YOLO_SIDE,
                         img.shape[0] / YOLO_SIDE)

    def request():
        x, _, _, _ = pre(img)
        u8 = torch.from_numpy((x * 255.0).astype(np.uint8)[None]).cuda()
        pred = yolov5_detect(card, u8, k=YOLO_TOPK).cpu().numpy()
        return pred, post(pred), u8

    t0 = time.perf_counter()
    pred, dets, u8 = request()
    warm_s = time.perf_counter() - t0
    dispatch.reset_launches()
    times = []
    for _ in range(YOLO_TIMED):
        t0 = time.perf_counter()
        pred, dets, u8 = request()
        times.append(time.perf_counter() - t0)
    launches = {k: v for k, v in dispatch.launches.items() if v}
    detect_ms = time_ms(lambda: yolov5_detect(card, u8, k=YOLO_TOPK), warmup=1, reps=8)
    p50 = statistics.median(times)
    obj = pred[0, :, 4]
    with torch.no_grad():
        full = yolov5_apply(card, (u8.float() / 255.0).permute(0, 3, 1, 2).to(dtype))
        want = yolov5_apply(cpu, (u8.cpu().float() / 255.0).permute(0, 3, 1, 2))
    idx = torch.topk(full[..., 4], YOLO_TOPK, dim=1).indices
    rows = idx[..., None].expand(-1, -1, full.shape[-1])
    full, top = full.cpu(), torch.gather(full, 1, rows).cpu()
    want_top = torch.gather(want, 1, rows.cpu())
    errs = {f"{what} {part}": ((c[..., cols] - r[..., cols]).abs().max().item(),
                               r[..., cols].abs().max().item())
            for what, c, r in (("all", full, want), ("top", top, want_top))
            for part, cols in (("boxes", slice(0, 4)), ("scores", slice(4, None)))}
    print(f"yolo: yolov5_{YOLO_SIDE}x{YOLO_SIDE}_e2e p50 {p50 * 1e3:.2f} ms, "
          f"{1.0 / p50:.3f} img/s over {times} s (warm-up {warm_s:.2f} s); detect alone "
          f"{detect_ms:.3f} ms (CUDA events); pred {pred.shape} {pred.dtype}, objectness "
          f"{obj[0]:.4f}..{obj[-1]:.4f}, {len(dets[0])} detections; {keys} keys loaded; "
          f"launches {launches}; {dtype} card vs fp32 CPU max|d| / max|ref| "
          f"{ {k: f'{e:.3e} / {m:.3e}' for k, (e, m) in errs.items()} } "
          f"(tolerance {YOLO_BF16_TOL} x max|ref|)", flush=True)
    if not (pred.shape == (1, YOLO_TOPK, 85) and np.isfinite(pred).all()
            and (np.diff(obj) <= 0).all() and not launches
            and np.array_equal(pred, top.numpy()) and torch.isfinite(full).all()
            and all(e <= YOLO_BF16_TOL * m for e, m in errs.values())):
        raise AssertionError(f"yolo: pred {pred.shape}, launches {launches}, errors {errs}")
    del card, cpu
    torch.cuda.empty_cache()
    return {"metric": f"yolov5_{YOLO_SIDE}x{YOLO_SIDE}_e2e_imgs_per_sec", "value": 1.0 / p50,
            "p50_s": p50, "request_s": times, "warm_s": warm_s, "detect_ms": detect_ms,
            "detections": len(dets[0]), "keys": keys, "reference": ref,
            "bf16_vs_fp32": {k: e / m for k, (e, m) in errs.items()}}


def scoring_phase(model, cfg, tokenizer, directory):
    """The scoring harness (cli/score.py's flow) on the loaded SD-1.5 model:
    the FID Inception tower with seeded weights (init_inception, BatchNorm
    statistics drawn) written under pt_inception's name and read back with
    strict accounting (470 keys), fp32 with TF32 off; its features of a
    fixture scene, card vs CPU, within REF_TOL x max |ref|, and the card's
    time for one image; then ScoreHarness with that extractor over the
    replayed process() at SCORE_RES, STEPS steps, on SCORE_IMAGES fixture
    scenes against self-consistency goldens (a first pass of the same
    requests, which captures the engines): every PD exactly 0; the same
    requests at the next seed: every PD above 0."""
    from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline
    from stablediffusioneo_tpu_torch.scoring import InceptionFeatureExtractor, ScoreHarness
    from stablediffusioneo_tpu_torch.scoring.inception import init_inception
    from stablediffusioneo_tpu_torch.testing.fixtures import make_scene

    net = seeded_batch_norms(init_inception(torch.Generator().manual_seed(12)),
                             torch.Generator().manual_seed(13))
    path = os.path.join(directory, "pt_inception-2015-12-05.pth")
    torch.save(net.state_dict(), path)
    del net
    ext = InceptionFeatureExtractor(ckpt_path=path, device="cuda")
    cpu_ext = InceptionFeatureExtractor(ckpt_path=path, device="cpu")
    os.remove(path)
    images = [make_scene(1000 + i, SCORE_RES) for i in range(SCORE_IMAGES)]
    card_f, ref_f = ext(images[0]), cpu_ext(images[0])
    err, scale = float(np.abs(card_f - ref_f).max()), float(np.abs(ref_f).max())
    feature_ms = time_ms(lambda: ext(images[0]), warmup=1, reps=5)
    print(f"scoring: Inception {len(ext.report.consumed)} keys; features {card_f.shape} card "
          f"vs CPU max|d| / max|ref| {err:.3e} / {scale:.3e}; one image {feature_ms:.2f} ms",
          flush=True)
    if not (np.isfinite(card_f).all() and err <= REF_TOL * scale
            and len(ext.report.consumed) == 470):
        raise AssertionError(f"scoring: Inception card vs CPU {err} / {scale}")
    pipe = Canny2ImagePipeline(model, tokenizer, cfg, device="cuda")
    kw = dict(prompt="a bird", ddim_steps=STEPS, image_resolution=SCORE_RES, seed=SCORE_SEED)
    t0 = time.perf_counter()
    goldens = [pipe.process(img, num_samples=1, **kw)[-1] for img in images]
    golden_s = time.perf_counter() - t0
    result = ScoreHarness(pipe.process, ext).run(images, goldens, **kw)
    other = ScoreHarness(pipe.process, ext).run(images, goldens, **{**kw, "seed": SCORE_SEED + 1})
    print(f"scoring: self-consistency ({SCORE_IMAGES} scenes, {SCORE_RES}x{SCORE_RES}, {STEPS} "
          f"steps; goldens {golden_s:.2f} s): mean_t_ms {result['mean_t_ms']:.1f}, mean_pd "
          f"{result['mean_pd']}, mean_score {result['mean_score']:.4f}; seed "
          f"{SCORE_SEED + 1}: mean_pd {other['mean_pd']:.4f}, mean_score "
          f"{other['mean_score']:.4f}", flush=True)
    if not (all(r["pd"] == 0.0 for r in result["records"])
            and all(r["pd"] > 0.0 for r in other["records"])):
        raise AssertionError(f"scoring: PDs {result['records']}, {other['records']}")
    pipe.runtime.release()
    return {"inception_keys": len(ext.report.consumed), "feature_max_rel_err": err / scale,
            "feature_ms": feature_ms, "self_consistency": result, "other_seed": other}


def native_phase():
    """The preprocessing library (native/preproc.cpp) built by the port's
    loader on this machine (g++ into csrc/build/) and held to cv2 at
    tests/test_native.py's bounds: Canny exact on a blurred box and an IoU
    above 0.8 on blurred noise, the bilinear resize within 1; each timed on
    the host (median of 10) beside cv2 at 512x512."""
    import cv2

    from stablediffusioneo_tpu_torch.annotators import native
    from stablediffusioneo_tpu_torch.utils.native import library_path

    t0 = time.perf_counter()
    ok = native.native_available()
    build_s = time.perf_counter() - t0
    box = np.zeros((64, 64), np.uint8)
    box[16:48, 16:48] = 200
    box = cv2.GaussianBlur(box, (5, 5), 1.2)
    exact = np.array_equal(native.canny(box, 100, 200) > 0, cv2.Canny(box, 100, 200) > 0)
    noise = cv2.GaussianBlur((np.random.default_rng(14).random((128, 128)) * 255)
                             .astype(np.uint8), (7, 7), 2.0)
    a, b = native.canny(noise, 60, 150) > 0, cv2.Canny(noise, 60, 150) > 0
    iou = (a & b).sum() / max((a | b).sum(), 1)
    img = annotator_image()
    resize_d = int(np.abs(native.resize_bilinear(img, 384, 448).astype(int)
                          - cv2.resize(img, (448, 384), interpolation=cv2.INTER_LINEAR)
                          .astype(int)).max())

    def host_ms(fn):
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    times = {"canny": host_ms(lambda: native.canny(gray, 100, 200)),
             "cv2_canny": host_ms(lambda: cv2.Canny(gray, 100, 200)),
             "resize_bilinear": host_ms(lambda: native.resize_bilinear(img, 384, 448)),
             "cv2_resize": host_ms(lambda: cv2.resize(img, (448, 384)))}
    print(f"native: {library_path('sdeo_preproc').name} built and loaded in {build_s:.2f} s; "
          f"canny exact on the box {exact}, IoU on noise {iou:.3f}; resize max|d| {resize_d}; "
          f"host ms {times}", flush=True)
    if not (ok and exact and iou > 0.8 and resize_d <= 1):
        raise AssertionError(f"native: {ok}, {exact}, {iou}, {resize_d}")
    return {"build_s": build_s, "canny_iou": iou, "resize_max_abs": resize_d, "host_ms": times}


# ------------------------------------------- checkpoint tools, T5, the CLIs


def drill_phase(directory):
    """The offline drill (testing/offline_drill.py:run_drill) on the card,
    every family at full width: files synthesized from the packaged key
    universes under their real names, manifest verify, strict load through
    the port's loaders, one inference in bf16, finite uint8. The sd15 file is
    kept in `directory` for readiness_phase; the other families' files are
    written to a temporary directory and deleted after each family. Each
    family's seconds, bytes written, keys verified and attention launches;
    sd15's request and sdxl's sample+decode (DRILL_RES, DRILL_STEPS) launch
    #1 and #2 as the plans say (at 256x256 SDXL's attention sites hold 256
    and 64 tokens, under the kernels' 1,024-query gate, hence DRILL_RES 512).
    Then a drill file pinned into a copy of the manifest verifies, and with
    one byte flipped is rejected on its sha256."""
    from stablediffusioneo_tpu_torch.checkpoint import manifest
    from stablediffusioneo_tpu_torch.models.sdxl import SDXLConfig
    from stablediffusioneo_tpu_torch.testing.offline_drill import (
        ALL_FAMILIES,
        run_drill,
        synth_state_dict,
        write_pth,
    )

    def log(msg):
        print(msg, flush=True)

    print(f"drill: {shutil.disk_usage(directory).free} bytes free where the files are "
          f"written", flush=True)
    reports = run_drill(ALL_FAMILIES[:1], out_dir=directory, res=DRILL_RES,
                        steps=DRILL_STEPS, keep_files=True, log=log)
    with tempfile.TemporaryDirectory() as scratch:
        reports += run_drill(ALL_FAMILIES[1:], out_dir=scratch, res=DRILL_RES,
                             steps=DRILL_STEPS, log=log)
    # sd15's process() is its runtime's first request: each engine runs once
    # eagerly before its capture (runtime/engine.py:Engine.load), and those
    # launches count, then the replay's; sdxl's loop runs eagerly, once
    want = {}
    for fam, cfg, runs in (("sd15", sd15_config(), 2), ("sdxl", SDXLConfig(), 1)):
        step, split = expected_launches(cfg, DRILL_RES)
        want[fam] = {"fused_attention_packed": runs * DRILL_STEPS
                     * step["fused_attention_packed"], "fused_attention": runs * split}
    out = {}
    for r in reports:
        attn = {k: v for k, v in r["launches"].items() if k.startswith("fused_attention")}
        print(f"drill {r['family']}: {r['seconds']} s, {r['bytes'] / 1e9:.3f} GB written, "
              f"{r['keys']} keys verified, attention launches {attn}"
              + (f" (expected {want[r['family']]})" if r["family"] in want else ""),
              flush=True)
        out[r["family"]] = {k: r[k] for k in ("seconds", "bytes", "keys")}
        out[r["family"]]["launches"] = attn
    if [r["family"] for r in reports] != list(ALL_FAMILIES):
        raise AssertionError(f"drill families {[r['family'] for r in reports]}")
    for fam, launches in want.items():
        if out[fam]["launches"] != launches or not all(launches.values()):
            raise AssertionError(f"drill {fam}: launches {out[fam]['launches']}, "
                                 f"expected {launches}")
    with tempfile.TemporaryDirectory() as scratch:
        path = write_pth(synth_state_dict(manifest.load_universe("hed"), seed=3),
                         os.path.join(scratch, "ControlNetHED.pth"))
        local = os.path.join(scratch, "manifest.json")
        shutil.copy(manifest.default_manifest_path(), local)
        entry = manifest.pin_file(path, manifest_path=local)
        pinned = manifest.verify_file(path, manifest_path=local)
        raw = bytearray(open(path, "rb").read())
        raw[len(raw) // 2] ^= 0xFF
        with open(path, "wb") as f:
            f.write(raw)
        try:
            manifest.verify_file(path, manifest_path=local)
            rejected = None
        except manifest.ManifestError as e:
            rejected = str(e)
    print(f"drill: ControlNetHED.pth pinned (sha256 {entry['sha256'][:16]}, "
          f"{entry['size_bytes']} bytes) verifies {pinned['ok']}; with one byte flipped: "
          f"{rejected!r}", flush=True)
    if not (pinned["ok"] and pinned["sha256"] == entry["sha256"] and rejected
            and "sha256" in rejected):
        raise AssertionError(f"the tampered file was not rejected on its sha256: {rejected}")
    return {"families": out, "tampered": rejected.splitlines()[-1].strip()}


def sd15_config():
    from stablediffusioneo_tpu_torch.config import sd15_pipeline

    return sd15_pipeline(dtype="bfloat16")


def tokenizer_files(tokenizer, directory):
    """`tokenizer`'s vocabulary and merges as HF's vocab.json and merges.txt
    in `directory` (what sdeo-readiness-torch --vocab / --merges take)."""
    vocab = os.path.join(directory, "vocab.json")
    merges = os.path.join(directory, "merges.txt")
    with open(vocab, "w", encoding="utf-8") as f:
        json.dump(tokenizer.encoder, f)
    ranked = sorted(tokenizer.bpe_ranks, key=tokenizer.bpe_ranks.get)
    with open(merges, "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(" ".join(m) for m in ranked) + "\n")
    return vocab, merges


def readiness_phase(tokenizer, ckpt):
    """sdeo-readiness-torch's flow (cli/readiness.py) on the drill's sd15
    file with the smoke's BPE vocabulary as vocab.json / merges.txt:
    --verify-manifest over the three files (each OK), then the parity
    check: strict accounting, the card's bf16 run through captured engines
    against the port's fp32 run on the CPU from the same file (plain
    versions), READINESS_N fixture scenes at READINESS_RES, READINESS_STEPS
    DDIM steps; each PD and the mean against READINESS_PD_LIMIT, the card's
    attention launches as the plans say. The PD cannot see a wrong card path
    on these weights (near-flat images), so each image's final latents are
    held within READINESS_LATENT_TOL x max |z_ref| of the reference's; then
    the file loaded on the card in fp32 runs the same requests within
    READINESS_FP32_TOL x max |z_ref|, and two broken ones (strength 0: no
    ControlNet residual; another prompt: another text context) must differ
    by more. Then --dry-run (the tiny seeded flow, its card side on the card)
    exits 0."""
    from stablediffusioneo_tpu_torch.cli import readiness
    from stablediffusioneo_tpu_torch.ops import dispatch

    cfg = sd15_config()
    with tempfile.TemporaryDirectory() as directory:
        vocab, merges = tokenizer_files(tokenizer, directory)
        args = readiness.parse_args(
            ["--ckpt", ckpt, "--vocab", vocab, "--merges", merges, "--verify-manifest",
             "--res", str(READINESS_RES), "--steps", str(READINESS_STEPS),
             "--n", str(READINESS_N), "--pd-limit", str(READINESS_PD_LIMIT)])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            verified = readiness.check_manifest(args)
        print(buf.getvalue().rstrip(), flush=True)
        if not (verified and sum(line.startswith("OK ")
                                 for line in buf.getvalue().splitlines()) == 3):
            raise AssertionError("readiness --verify-manifest did not pass the three files")
        before = dispatch.counts()
        t0 = time.perf_counter()
        result = readiness.parity(args)
        seconds = time.perf_counter() - t0
        launches = {k: v for k, v in dispatch.counts_since(before)[0].items()
                    if k.startswith("fused_attention")}
    # the card's requests: the first one's engines run once eagerly before
    # their capture, then every request replays (READINESS_N + 1 runs)
    step, split = expected_launches(cfg, READINESS_RES)
    runs = READINESS_N + 1
    want = {"fused_attention_packed": runs * READINESS_STEPS * step["fused_attention_packed"],
            "fused_attention": runs * split}
    print(f"readiness: card bf16 vs CPU fp32 PDs {[round(p, 4) for p in result['pds']]}, "
          f"mean {result['mean_pd']:.4f} (limit {READINESS_PD_LIMIT}); card request ms "
          f"{[round(t, 1) for t in result['times_ms']]}; {result['consumed']} keys consumed, "
          f"{result['ignored']} known-unused; {seconds:.1f} s with the CPU reference; card "
          f"attention launches {launches} (expected {want})", flush=True)
    if not (result["pass"] and launches == want and all(want.values())):
        raise AssertionError(f"readiness failed: {result}, launches {launches}")
    del result["pipeline"]
    gc.collect()
    torch.cuda.empty_cache()
    # the same flow with the card in fp32 (TF32 off): on these weights the
    # nets move the latents by less than their bf16 rounding, so only here
    # can a broken request be told apart from the reference
    pipe = readiness._pipeline(ckpt, dataclasses.replace(cfg, dtype="float32"), tokenizer,
                               "cuda")[1]
    fp32 = {}
    for name, prompt, strength in (("card fp32", readiness.PROMPT, 1.0),
                                   ("no ControlNet", readiness.PROMPT, 0.0),
                                   ("another prompt", "a red car on a street", 1.0)):
        errs = []
        for img, z_ref in zip(result["images"], result["ref_latents"]):
            pipe.process(img, prompt, **dict(result["kwargs"], strength=strength))
            z = pipe.last_latents.float().cpu()
            errs.append(float((z - z_ref).abs().max() / z_ref.abs().max()))
        fp32[name] = errs
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    print(f"readiness latents, max|dz|/max|z_ref| against the CPU's fp32 run: card bf16 "
          f"{[f'{e:.3g}' for e in result['latent_errs']]} (bound {READINESS_LATENT_TOL}); "
          f"card fp32 {[f'{e:.3g}' for e in fp32['card fp32']]} (bound "
          f"{READINESS_FP32_TOL}); broken fp32 requests (each must exceed "
          f"{READINESS_FP32_TOL}): no ControlNet "
          f"{[f'{e:.3g}' for e in fp32['no ControlNet']]}, another prompt "
          f"{[f'{e:.3g}' for e in fp32['another prompt']]}", flush=True)
    if not (max(result["latent_errs"]) <= READINESS_LATENT_TOL
            and max(fp32["card fp32"]) <= READINESS_FP32_TOL
            and min(fp32["no ControlNet"] + fp32["another prompt"]) > READINESS_FP32_TOL):
        raise AssertionError(f"readiness latents: bf16 {result['latent_errs']}, fp32 {fp32}")
    dry = readiness.main(["--dry-run"])
    print(f"readiness --dry-run: exit code {dry}", flush=True)
    if dry != 0:
        raise AssertionError("readiness --dry-run failed")
    return {"pds": result["pds"], "mean_pd": result["mean_pd"],
            "latent_errs": result["latent_errs"], "fp32_latent_errs": fp32,
            "request_ms": result["times_ms"], "seconds": seconds, "launches": launches}


def t5_phase(clip):
    """T5 v1.1-large at full width (24 layers, d 1024; models/t5.py), seeded
    on the card: fp32 on the card against fp32 on the CPU (TF32 off), within
    REF_TOL x max |ref|, without and with a padding mask; then in bf16 the
    eager p50 of T5_CALLS calls (CUDA events) and clip_t5_encode's two
    outputs with the loaded SD-1.5 CLIP tower. T5 runs no kernel (its
    attention takes an additive bias, as in the JAX package's plain
    einsums)."""
    from stablediffusioneo_tpu_torch.models.t5 import T5Config, clip_t5_encode, init_t5, t5_encode
    from stablediffusioneo_tpu_torch.ops import dispatch

    cfg = T5Config()
    t5 = init_t5(torch.Generator(device="cuda").manual_seed(0), cfg)
    cpu = copy.deepcopy(t5).cpu()
    g = torch.Generator().manual_seed(5)
    ids = torch.randint(1, cfg.vocab_size, (2, cfg.max_length), generator=g)
    mask = torch.ones_like(ids)
    mask[0, 40:] = 0
    ids[0, 40:] = 0
    errs = {}
    before = dispatch.counts()
    with torch.no_grad():
        for label, m in (("no mask", None), ("padding mask", mask)):
            card = t5_encode(t5, ids.cuda(), None if m is None else m.cuda()).cpu()
            ref = t5_encode(cpu, ids, m)
            err, scale = (card - ref).abs().max().item(), ref.abs().max().item()
            errs[label] = err / scale
            print(f"t5 ({label}): T5 v1.1-large fp32 at {cfg.max_length} tokens, card vs CPU "
                  f"max|d| {err:.3e} (max|ref| {scale:.3e})", flush=True)
            if not (torch.isfinite(card).all() and err <= REF_TOL * scale):
                raise AssertionError(f"t5 ({label}): {err} against {scale}")
        del cpu
        t5 = t5.to(torch.bfloat16)
        ids_c, mask_c = ids.cuda(), mask.cuda()
        ms = time_ms(lambda: t5_encode(t5, ids_c, mask_c), warmup=3, reps=T5_CALLS)
        clip_ids = torch.randint(0, 49408, (2, 77), generator=g).cuda()
        zs = clip_t5_encode(clip, t5, clip_ids, ids_c, mask_c)
    shapes = [tuple(z.shape) for z in zs]
    launches = {k: v for k, v in dispatch.counts_since(before)[0].items() if v}
    print(f"t5: bf16 (2, {cfg.max_length}) with a padding mask, eager p50 {ms:.3f} ms over "
          f"{T5_CALLS} calls; clip_t5_encode shapes {shapes}; kernel launches {launches}",
          flush=True)
    if shapes != [(2, 77, 768), (2, 77, cfg.d_model)] or not all(
            torch.isfinite(z).all() for z in zs):
        raise AssertionError(f"clip_t5_encode: {shapes}")
    del t5
    gc.collect()
    torch.cuda.empty_cache()
    return {"max_rel_err": errs, "bf16_p50_ms": ms}


def smoke_cli_phase():
    """sdeo-smoke-torch (cli/smoke.py:main) as a user runs it: the CLIP
    engine of a runtime over seeded SD-1.5 weights captured on the card;
    its output (1, 77, 768) bf16 and finite, the engine compiled."""
    from stablediffusioneo_tpu_torch.cli import smoke

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        code = smoke.main([])
    seconds = time.perf_counter() - t0
    text = buf.getvalue().rstrip()
    print(f"sdeo-smoke-torch ({seconds:.2f} s, exit code {code}):\n{text}", flush=True)
    mean = re.search(r"mean\|x\|= (\S+)", text)
    if not (code == 0 and "clip engine OK: (1, 77, 768) torch.bfloat16" in text
            and "'compiled': True" in text and mean and math.isfinite(float(mean.group(1)))):
        raise AssertionError("sdeo-smoke-torch did not bring the CLIP engine up")
    gc.collect()
    torch.cuda.empty_cache()
    return {"seconds": seconds, "mean_abs": float(mean.group(1))}


def unet_reference(label, unet, cfg, control=None, res=REFERENCE_RES):
    """One full-width fp32 evaluation at res x res of a family's UNet (and
    its ControlNet), card (kernel entries where the gates send them) against
    the same weights on the CPU (plain versions), TF32 off: within REF_TOL x
    max |ref|, the card's kernel launches as the plans say."""
    from stablediffusioneo_tpu_torch.models.controlnet import controlled_unet_apply
    from stablediffusioneo_tpu_torch.ops import dispatch

    ucfg = cfg.unet
    lat = res // cfg.vae.downsample_factor
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, lat, lat, 4), generator=g)
    ctx = torch.randn((2, text_length(cfg), ucfg.context_dim), generator=g)
    t = torch.tensor([801.0, 801.0])
    y = torch.randn((2, ucfg.adm_in_channels), generator=g) if ucfg.adm_in_channels else None
    hint = (torch.rand((2, res, res, 3), generator=g) > 0.8).float() if control else None
    nets = {"cuda": (unet, control),
            "cpu": tuple(None if m is None else copy.deepcopy(m).cpu() for m in (unet, control))}
    outs, seconds = {}, {}
    for dev, (u, c) in nets.items():
        dispatch.reset_launches()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = controlled_unet_apply(
                u, c, x.to(dev), None if hint is None else hint.to(dev), t.to(dev),
                ctx.to(dev), control_scales=None if c is None else [1.0] * 13,
                y=None if y is None else y.to(dev))
        outs[dev] = out.cpu()
        seconds[dev] = time.perf_counter() - t0
        if dev == "cuda":
            launches = {k: v for k, v in dispatch.launches.items() if v}
    del nets
    err = (outs["cuda"] - outs["cpu"]).abs().max().item()
    ref_scale = outs["cpu"].abs().max().item()
    want = {k: v for k, v in expected_launches(cfg, res, torch.float32)[0].items() if v}
    add_norms(want, (_unet_norms(ucfg, lat, 2, True), 1),
              (_unet_norms(cfg.controlnet.unet, lat, 2, False) if control is not None else [],
               1))
    print(f"reference ({label}): full-width {'controlled ' if control else ''}UNet "
          f"{res}x{res} fp32, card vs CPU max|d| {err:.3e} (max|ref| {ref_scale:.3e}); card "
          f"{seconds['cuda']:.2f} s, CPU {seconds['cpu']:.2f} s; kernel launches {launches} "
          f"(expected {want})", flush=True)
    if not (torch.isfinite(outs["cuda"]).all() and err <= REF_TOL * ref_scale
            and launches == want):
        raise AssertionError(f"{label} reference failed: {err}, {launches}")
    return {"max_abs_err": err, "max_abs_ref": ref_scale, "launches": launches}


def sdxl_reference():
    """The SDXL base UNet (SDXLConfig(), seeded on the card in fp32, built
    apart: the smoke's SDXL model is drawn in bf16) through unet_reference
    at SDXL_REF_RES (1,024-token level-1 sites: the packed kernel's fp32
    variant at head dim 64)."""
    from stablediffusioneo_tpu_torch.models.cldm import init_unet

    cfg = family_configs()[1]
    unet = init_unet(torch.Generator(device="cuda").manual_seed(0), cfg.unet)
    out = unet_reference("sdxl base", unet, cfg, res=SDXL_REF_RES)
    del unet
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------- depth2img


def depth2img_build(model, ids):
    """captured_path's build of the depth2img request at 512x512: the text
    tower eagerly, the MiDaS DPT-hybrid tower at 384x384 on the init image and
    depth_to_concat (pipeline/concat_cond.py:image_to_depth_concat), then
    concat_sample_decode_engine (20 DDIM steps, scale 9; its 1 conditioning
    channel) on x_T drawn from the seed."""
    from stablediffusioneo_tpu_torch.models.clip import clip_text_apply
    from stablediffusioneo_tpu_torch.pipeline.concat_cond import image_to_depth_concat
    from stablediffusioneo_tpu_torch.runtime.engine import concat_sample_decode_engine

    dtype = next(model.parameters()).dtype
    img = torch.from_numpy(smoke_source()[None].astype(np.float32) / 127.5 - 1.0).to("cuda")
    lat = RES // model.cfg.vae.downsample_factor

    def build(capture):
        eng = concat_sample_decode_engine(model, STEPS, 1, RES, RES, capture=capture)

        def request(seed):
            with torch.no_grad():
                ctx = clip_text_apply(model.clip, ids).to(dtype)
                c_concat = image_to_depth_concat(model.depth, img, (lat, lat)).to(dtype)
            x = torch.randn((1, lat, lat, 4), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(seed))
            out, z = eng(x.to(dtype), c_concat, ctx[:1], ctx[1:],
                         torch.full((1,), SCALE, device="cuda"))
            return out[0].cpu().numpy(), z

        return {eng.name: eng}, request

    return build


def depth_tower_ms(model, calls=5):
    """The MiDaS tower of a depth2img request alone (384x384 input to the
    depth channel), ms a call by CUDA events, eager."""
    from stablediffusioneo_tpu_torch.pipeline.concat_cond import image_to_depth_concat

    img = torch.from_numpy(smoke_source()[None].astype(np.float32) / 127.5 - 1.0).to("cuda")
    lat = RES // model.cfg.vae.downsample_factor
    with torch.no_grad():
        return time_ms(lambda: image_to_depth_concat(model.depth, img, (lat, lat)),
                       warmup=2, reps=calls)


def depth2img_phase(tokenizer):
    """SD-2.0 depth2img (sd2_depth_pipeline(), full width, seeded, bf16): its
    state dict in the 512-depth-ema layout (model.diffusion_model.*,
    first_stage_model.*, cond_stage_model.model.*, depth_model.model.* with
    the OpenCLIP leftovers and a schedule buffer) through a torch.save'd file
    and load_depth2img_pipeline (every key consumed or named, none orphaned;
    its keys and bytes printed), then on the loaded model the 512x512
    request, 20 DDIM steps, scale 9, as a main path over
    concat_sample_decode_engine (captured_path: the tower at 384x384 under
    the attention gate, 400 packed + 1 split launches a request), the tower's
    time apart; the seeded model's request equal to the loaded one's in
    bytes."""
    from stablediffusioneo_tpu_torch.checkpoint import load_depth2img_pipeline
    from stablediffusioneo_tpu_torch.config import sd2_depth_pipeline
    from stablediffusioneo_tpu_torch.models.cldm import Depth2ImgModel, seeded
    from stablediffusioneo_tpu_torch.pipeline.concat_cond import DEPTH_SIZE

    cfg = sd2_depth_pipeline()
    model = seeded(lambda: Depth2ImgModel(cfg), torch.Generator(device="cuda").manual_seed(0))
    model = model.to(torch.bfloat16)
    ids = torch.as_tensor(np.asarray(tokenizer([PROMPT, ""])), dtype=torch.long,
                          device="cuda")
    sd = dict(model.state_dict())
    extra = {"betas": torch.linspace(1e-4, 2e-2, 1000),
             "cond_stage_model.model.attn_mask": torch.zeros(77, 77),
             "cond_stage_model.model.logit_scale": torch.tensor(4.6)}
    with tempfile.TemporaryDirectory() as directory:
        path = os.path.join(directory, "512-depth-ema_seeded.ckpt")
        t0 = time.perf_counter()
        torch.save({"state_dict": {**sd, **extra}}, path)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        loaded = load_depth2img_pipeline(path, cfg, device="cuda", dtype=torch.bfloat16)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    report = loaded.load_report
    tower = sum(k.startswith("depth_model.model.") for k in report.consumed)
    print(f"depth2img checkpoint: {len(sd) + len(extra)} keys ({tower} of the tower), "
          f"{size} bytes written in {save_s:.2f} s, loaded onto the card in {load_s:.2f} s; "
          f"consumed {len(report.consumed)}, ignored {sorted(report.ignored)}, orphans "
          f"{len(report.orphans)}", flush=True)
    if not (report.complete and len(report.consumed) == len(sd)
            and report.ignored == set(extra)):
        raise AssertionError(f"depth2img checkpoint load: {report.problems()}")
    run = captured_path("depth2img", depth2img_build(loaded, ids), cfg, RES, STEPS,
                        towers=[(_tower_norms(cfg.clip), 1),
                                (annotator_norms("dpt_hybrid", DEPTH_SIZE), 1)])
    run["tower_ms"] = depth_tower_ms(loaded)
    print(f"depth2img: the depth tower (384x384) and depth_to_concat "
          f"{run['tower_ms']:.2f} ms a call", flush=True)
    del loaded
    engines, request = depth2img_build(model, ids)(True)
    out = request(1)[0]
    differ = int((out != run["image"]).sum())
    print(f"depth2img: the seeded model's request seed=1 differs from the loaded model's "
          f"image in {differ} bytes", flush=True)
    if differ:
        raise AssertionError(f"the seeded depth2img model gives another image ({differ})")
    del engines, request, model, sd
    gc.collect()
    torch.cuda.empty_cache()
    run["checkpoint"] = {"keys": len(report.consumed) + len(report.ignored), "bytes": size,
                         "save_s": save_s, "load_s": load_s}
    return run


def refiner_reference(model):
    """One full-width refiner-UNet evaluation at 256x256 in fp32, the card
    (through the kernel entries, none gated at this size) against the same
    weights on the CPU (plain versions), TF32 off: within REF_TOL x max
    |ref|. The refiner's level 3 has no attention and its middle block a
    depth-4 transformer."""
    from stablediffusioneo_tpu_torch.models.unet import UNetModel, unet_forward
    from stablediffusioneo_tpu_torch.ops import dispatch
    from stablediffusioneo_tpu_torch.ops.layers import nchw

    ucfg = model.cfg.unet
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 32, 32, 4), generator=g)
    ctx = torch.randn((2, 77, ucfg.context_dim), generator=g)
    y = torch.randn((2, ucfg.adm_in_channels), generator=g)
    t = torch.tensor([801.0, 801.0])
    with torch.device("meta"):
        cpu_unet = UNetModel(ucfg)
    cpu_unet.to_empty(device="cpu")
    cpu_unet.load_state_dict(model.unet.state_dict())
    outs = {}
    for dev, unet in (("cuda", model.unet), ("cpu", cpu_unet)):
        dispatch.reset_launches()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = unet_forward(unet, nchw(x.to(dev)), t.to(dev), ctx.to(dev), y=y.to(dev))
        outs[dev] = out.cpu()
        if dev == "cuda":
            launches = {k: v for k, v in dispatch.launches.items() if v}
        print(f"refiner reference: {dev} evaluation {time.perf_counter() - t0:.2f} s",
              flush=True)
    del cpu_unet
    err = (outs["cuda"] - outs["cpu"]).abs().max().item()
    ref_scale = outs["cpu"].abs().max().item()
    want = {k: v for k, v in expected_launches(model.cfg, 256, torch.float32)[0].items() if v}
    add_norms(want, (_unet_norms(ucfg, 32, 2, True), 1))
    print(f"reference (sdxl refiner): full-width refiner UNet 256x256 fp32, card vs CPU "
          f"max|d| {err:.3e} (max|ref| {ref_scale:.3e}), kernel launches {launches} "
          f"(expected {want})", flush=True)
    if not (torch.isfinite(outs["cuda"]).all() and err <= REF_TOL * ref_scale
            and launches == want):
        raise AssertionError(f"refiner reference failed: {err}, {launches}")
    return {"max_abs_err": err, "max_abs_ref": ref_scale}


def refiner_build(model, ids_g, z_base):
    """captured_path's build of the refiner's request: bigG conditioning of
    the prompt and the empty prompt (aesthetic scores 6.0 and 2.5, one call
    a branch, eagerly, outside the engine), the base latents forward-diffused
    to the entry of the last REFINER_T_ENC of STEPS steps with noise drawn
    from the seed outside the graph, then sdxl_refine_decode_engine."""
    from stablediffusioneo_tpu_torch.models.sdxl import sdxl_refiner_conditioning
    from stablediffusioneo_tpu_torch.ops.schedule import DiffusionSchedule
    from stablediffusioneo_tpu_torch.pipeline.ddim import stochastic_tail_entry
    from stablediffusioneo_tpu_torch.runtime.engine import sdxl_refine_decode_engine

    d = model.cfg.diffusion
    sched = DiffusionSchedule(d.timesteps, d.linear_start, d.linear_end,
                              d.schedule).ddim(STEPS)
    dtype = next(model.parameters()).dtype
    size = (SDXL_RES, SDXL_RES)

    def build(capture):
        eng = sdxl_refine_decode_engine(model, STEPS, REFINER_T_ENC, 1, SDXL_RES, SDXL_RES,
                                        capture=capture)

        def request(seed):
            with torch.no_grad():
                (ctx_c, y_c), (ctx_u, y_u) = (
                    sdxl_refiner_conditioning(model, ids, size, aesthetic_score=score)
                    for ids, score in ((ids_g[:1], REFINER_SCORES[0]),
                                       (ids_g[1:], REFINER_SCORES[1])))
            noise = torch.randn(z_base.shape, device="cuda",
                                generator=torch.Generator(device="cuda").manual_seed(seed))
            _, x = stochastic_tail_entry(sched, REFINER_T_ENC, z_base.to(dtype), noise)
            img, z = eng(x, ctx_c, ctx_u, y_c, y_u,
                         torch.full((1,), SDXL_SCALE, device="cuda"))
            return img[0].cpu().numpy(), z

        return {eng.name: eng}, request

    return build


def refiner_phase(tokenizer, z_base):
    """SDXL base -> refiner at 1024x1024: the refiner (SDXLRefinerConfig(),
    weights drawn on the card) first in fp32 for refiner_reference, then in
    bf16 as a main path on the base's latents (captured_path: t_enc 4 of 20,
    scale 5; 320 packed + 1 split launches a request); then its sgm-layout
    state dict (with OpenCLIP's two leftovers) written to a temporary
    directory (its free bytes printed first) and read back by
    load_sdxl_refiner_pipeline: every key consumed or named, none orphaned,
    the same image in bytes."""
    from stablediffusioneo_tpu_torch.checkpoint import load_sdxl_refiner_pipeline
    from stablediffusioneo_tpu_torch.models.cldm import seeded
    from stablediffusioneo_tpu_torch.models.sdxl import SDXLRefiner, sdxl_tokenize

    cfg = refiner_config()
    model = seeded(lambda: SDXLRefiner(cfg), torch.Generator(device="cuda").manual_seed(0))
    reference = refiner_reference(model)
    model = model.to(torch.bfloat16)
    gc.collect()
    torch.cuda.empty_cache()
    ids_g = torch.as_tensor(sdxl_tokenize(tokenizer, [PROMPT, ""])[1], dtype=torch.long,
                            device="cuda")
    run = captured_path("sdxl refiner 1024", refiner_build(model, ids_g, z_base), cfg,
                        SDXL_RES, REFINER_T_ENC,
                        towers=[(_tower_norms(cfg.clip_g, pooled=True), 2)])
    sd = dict(model.state_dict())
    t = cfg.clip_g.max_length
    extra = {"conditioner.embedders.0.model.attn_mask": torch.full(
                 (t, t), float("-inf"), device="cuda").triu(1),
             "conditioner.embedders.0.model.logit_scale": torch.tensor(4.6052, device="cuda")}
    with tempfile.TemporaryDirectory() as directory:
        free = shutil.disk_usage(directory).free
        print(f"refiner checkpoint: {free} bytes free where the file is written", flush=True)
        path = os.path.join(directory, "sd_xl_refiner_seeded.pth")
        t0 = time.perf_counter()
        torch.save({**sd, **extra}, path)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        loaded = load_sdxl_refiner_pipeline(path, cfg, device="cuda", dtype=torch.bfloat16)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    report = loaded.load_report
    print(f"refiner checkpoint: {len(sd) + len(extra)} keys, {size} bytes written in "
          f"{save_s:.2f} s, loaded onto the card in {load_s:.2f} s; consumed "
          f"{len(report.consumed)}, ignored {sorted(report.ignored)}, orphans "
          f"{len(report.orphans)}", flush=True)
    if not (report.complete and len(report.consumed) == len(sd)
            and report.ignored == set(extra)):
        raise AssertionError(f"refiner checkpoint load: {report.problems()}")
    del sd, model
    gc.collect()
    torch.cuda.empty_cache()
    engines, request = refiner_build(loaded, ids_g, z_base)(True)
    out = request(1)[0]
    differ = int((out != run["image"]).sum())
    print(f"refiner checkpoint: the loaded refiner's request seed=1 differs from the "
          f"seeded refiner's image in {differ} bytes", flush=True)
    if differ:
        raise AssertionError(f"the loaded refiner gives another image ({differ} bytes)")
    del engines, request, loaded
    gc.collect()
    torch.cuda.empty_cache()
    run["checkpoint"] = {"keys": len(report.consumed) + len(report.ignored), "bytes": size,
                         "save_s": save_s, "load_s": load_s, "free_bytes": free}
    run["reference"] = reference
    return run


# ------------------------------------------------------------- SD3 phase


SD3_RES, SD3_STEPS, SD3_SCALE = 1024, 40, 4.5  # the model card's request


def build_sd3(seed):
    """SD 3.5 Medium at full width (the 2.5 B MMDiT-X, CLIP-L, bigG, T5-XXL
    and the 16-channel VAE: 7.9 B parameters), its weights drawn in bf16 on
    the card from a seed: linears and convs U(+-1/sqrt(fan_in)), embeddings
    N(0, 0.02) (positions 0.01), every norm's gain 1 and bias 0 (the
    benchmark's rules; init_weights does not know the RMSNorm and T5 norm
    modules)."""
    from stablediffusioneo_tpu_torch.models.sd3 import SD3, SD3Config

    with torch.device("meta"):
        model = SD3(SD3Config())
    model = model.to(torch.bfloat16).to_empty(device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d)):
                bound = m.weight[0].numel() ** -0.5
                for p in (m.weight, m.bias):
                    if p is not None:
                        p.uniform_(-bound, bound, generator=g)
            elif isinstance(m, torch.nn.Embedding):
                m.weight.normal_(0.0, 0.01 if name.endswith("position_embedding") else 0.02,
                                 generator=g)
            else:
                for pname, p in m.named_parameters(recurse=False):
                    if p.dim() != 1 or pname not in ("weight", "bias"):
                        raise RuntimeError(f"build_sd3: no rule for {name}.{pname}")
                    p.fill_(1.0 if pname == "weight" else 0.0)
    return model.eval().requires_grad_(False)


def sd3_ids(cfg):
    """(CLIP-L, bigG, T5) ids of [PROMPT, ""] on the card: the stand-in CLIP
    ids (bigG padded with zeros after the first EOT, as open_clip does) and
    a stand-in for T5's SentencePiece ids (one hashed id a word in [3,
    32000), EOS 1, padded with 0 to the tower's length)."""
    ids_l = stand_in_tokenizer([PROMPT, ""], cfg.clip_l.max_length)
    ids_g = ids_l.copy()
    for row in ids_g:
        row[np.nonzero(row == 49407)[0][0] + 1:] = 0
    n = cfg.t5.max_length
    t5 = []
    for text in (PROMPT, ""):
        row = [3 + zlib.crc32(w.encode()) % 31997 for w in text.split()][:n - 1] + [1]
        t5.append(row + [0] * (n - len(row)))
    return [torch.as_tensor(np.asarray(a), dtype=torch.long, device="cuda")
            for a in (ids_l, ids_g, t5)]


def sd3_plan(cfg, steps, requests, res=SD3_RES):
    """What `requests` SD3 requests of batch 1 at res x res launch in the sample+decode
    engine, from the configuration: each evaluation (the batch-2 CFG
    concat) runs the joint attention in every block over text + image
    tokens and the image-only attention in each dual block on the packed
    kernel; the q/k RMSNorm of each of those projections (context, image
    and image-only: two calls each), plain; the adaLN LayerNorms on #7: two
    a block in each stream, one in the pre-only last context block, one
    before the final layer; the decode, its GroupNorms by the card's rule
    and one split attention at the mid-block. Returns (launches by kernel,
    attention calls by key length, norm calls by (norm, route))."""
    from stablediffusioneo_tpu_torch.ops.norms import group_norm_route

    t = cfg.transformer
    lat = res // cfg.vae.downsample_factor
    n = (lat // t.patch_size) ** 2
    joint = n + cfg.clip_l.max_length + cfg.t5.max_length
    dual = sum(1 for i in t.dual_attention_layers if i < t.num_layers)
    evals = requests * steps
    ln = 2 * t.num_layers + 2 * (t.num_layers - 1) + 1 + 1
    decode = _vae_norms(cfg.vae, lat, 1)
    want = add_norms({**dict.fromkeys(KERNELS, 0),
                      "fused_attention_packed": evals * (t.num_layers + dual),
                      "fused_attention": requests, "fused_layer_norm": evals * ln},
                     (decode, requests))
    keys = {joint: evals * t.num_layers, n: evals * dual, lat * lat: requests}
    routes = collections.Counter({("layer_norm", "kernel"): evals * ln,
                                  ("rms_norm", "plain_card"): evals * 2 * (2 * t.num_layers
                                                                           + dual)})
    for _, shape, _, groups in decode:
        routes["group_norm", group_norm_route(shape, groups, torch.bfloat16, "contiguous",
                                              "cuda", False)] += requests
    return want, keys, dict(routes)


def sd3_kernel_rows(cfg):
    """The kernels at SD3's sites, each against its plain version (measure:
    bf16 and fp32, device and eager times, the bound): the packed attention
    at the joint site (2, 4429, 1536) x 4429 and the image-only site (2,
    4096, 1536) x 4096, 24 heads of 64, q and k through `ops/norms.py:
    rms_norm` as the MMDiT-X feeds them; #7 without affine
    (`layer_norm(x, None, None, 1e-6)`, adaLN's norm, `unit_affine` standing
    in) at the image tokens (2, 4096, 1536) and the context's (2, 333, 1536)."""
    from stablediffusioneo_tpu_torch.ops import norms
    from stablediffusioneo_tpu_torch.ops.attention import packed_attention
    from stablediffusioneo_tpu_torch.ops.kernels import attention as ka
    from stablediffusioneo_tpu_torch.ops.kernels import layernorm as kl

    t = cfg.transformer
    heads, d, c = t.num_attention_heads, t.attention_head_dim, t.hidden_size
    n = (SD3_RES // cfg.vae.downsample_factor // t.patch_size) ** 2
    ctx = cfg.clip_l.max_length + cfg.t5.max_length
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(shape, dtype):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    rows = {"fused_attention_packed": [], "fused_layer_norm": []}
    wgmma = lambda q, k, v: ka._packed_launch(q, k, v, heads, d ** -0.5,
                                              "fused_attention_packed", "wgmma")
    for site, tq in (("joint", n + ctx), ("image_only", n)):
        def make(dt, tq=tq):
            w = (1 + 0.1 * torch.randn(d, generator=g, device="cuda")).to(dt)
            q, k = (norms.rms_norm(randn((2, tq, heads, d), dt), w, 1e-6).reshape(2, tq, c)
                    for _ in range(2))
            return q, k, randn((2, tq, c), dt)

        ops, _, exps = attention_work(2, heads, tq, tq, d)
        row = measure(
            "fused_attention_packed", {"site": site, "q": [2, tq, c], "s": tq, "heads": heads},
            lambda q, k, v: packed_attention(q, k, v, heads),
            lambda q, k, v: ka.fused_attention_packed_plain(q, k, v, heads, d ** -0.5), make,
            ops=ops, peak=PEAK_BF16, variants=ka.variant_launches, others={"wgmma": wgmma},
            library=lambda q, k, v: F.scaled_dot_product_attention(
                *(x.view(2, -1, heads, d).transpose(1, 2) for x in (q, k, v))))
        row["exp_ms"] = exps / PEAK_EXP * 1e3
        if row["bf16_variant"] != site_variant(d, tq) or row["fp32_variant"] != "cuda_core":
            raise AssertionError(f"SD3 {site} attention ran {row['bf16_variant']} (bf16) and "
                                 f"{row['fp32_variant']} (fp32)")
        rows["fused_attention_packed"].append(row)
    for site, shape in (("image", (2, n, c)), ("context", (2, ctx, c))):
        norms.route_counts.clear()
        row = measure(
            "fused_layer_norm", {"site": site, "x": list(shape), "affine": False},
            lambda x: norms.layer_norm(x, None, None, 1e-6),
            lambda x: kl.fused_layer_norm_plain(x, *norms.unit_affine(c, x.dtype, x.device),
                                                1e-6),
            lambda dt: (randn(shape, dt),), ops=NORM_OPS * math.prod(shape),
            library=lambda x: F.layer_norm(x, (c,), None, None, 1e-6),
            variants=kl.plan_launches)
        if set(norms.route_counts) != {("layer_norm", "kernel")}:
            raise AssertionError(f"SD3 {site} LayerNorm without affine ran "
                                 f"{dict(norms.route_counts)}")
        rows["fused_layer_norm"].append(row)
    return rows


def sd3_request(model, eng, ctx, y, seed):
    """One SD3 engine call on x_T drawn from the seed (NHWC, 16 channels)
    with the conditioning `ctx`, `y` of [PROMPT, ""]. Returns the image on
    the host and the latents."""
    lat = SD3_RES // model.cfg.vae.downsample_factor
    x = torch.randn((1, lat, lat, model.cfg.transformer.in_channels),
                    generator=torch.Generator(device="cuda").manual_seed(seed),
                    device="cuda").to(torch.bfloat16)
    img, z = eng(x, ctx[:1], ctx[1:], y[:1], y[1:], torch.full((1,), SD3_SCALE, device="cuda"))
    return img[0].cpu().numpy(), z.clone()


def sd3_phase():
    """SD 3.5 Medium (the cell sd35-medium.single's request): the kernels at
    its sites (sd3_kernel_rows), then the seeded full-width model in bf16:
    the three towers' conditioning (sd3_conditioning, eager; device time
    printed), the flow-matching sample+decode engine
    (runtime/engine.py:sd3_sample_decode_engine, 40 steps, scale 4.5,
    1024x1024) captured by a warm-up request, the counters zeroed, two
    replayed requests of the same conditioning, their launches held to
    sd3_plan (by kernel, by key length, every norm call by route: 1,480
    packed + 1 split attention, 3,840 #7 and 4,880 plain RMSNorm calls a
    request), then one eager request (capture=False) with the first one's
    seed whose image must equal the replayed one in bytes."""
    from stablediffusioneo_tpu_torch.models.sd3 import SD3Config, sd3_conditioning
    from stablediffusioneo_tpu_torch.ops import dispatch
    from stablediffusioneo_tpu_torch.ops.kernels.attention import (
        key_length_launches,
        variant_launches,
    )
    from stablediffusioneo_tpu_torch.ops.kernels.groupnorm import plan_launches as gn_plans
    from stablediffusioneo_tpu_torch.ops.kernels.layernorm import plan_launches as ln_plans
    from stablediffusioneo_tpu_torch.ops.norms import route_counts
    from stablediffusioneo_tpu_torch.runtime.engine import sd3_sample_decode_engine

    cfg = SD3Config()
    rows = sd3_kernel_rows(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = build_sd3(seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ids = sd3_ids(cfg)
    with torch.no_grad():
        towers_ms = device_ms(lambda: sd3_conditioning(model, *ids), calls=3)
        ctx, y = sd3_conditioning(model, *ids)
    print(f"sd3: seeded model built on the card in {build_s:.2f} s, "
          f"{torch.cuda.memory_allocated()} bytes allocated; conditioning (CLIP-L, bigG, "
          f"T5-XXL over 256 tokens, cond and uncond as one batch of 2): device "
          f"{towers_ms:.3f} ms; context {tuple(ctx.shape)}, pooled {tuple(y.shape)}", flush=True)
    if not (torch.isfinite(ctx).all() and torch.isfinite(y).all()):
        raise AssertionError("sd3 conditioning is not finite")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = sd3_sample_decode_engine(model, SD3_STEPS, 1, SD3_RES, SD3_RES)
    sd3_request(model, eng, ctx, y, 0)
    warm_s = time.perf_counter() - t0
    info = eng.get_engine_infor()
    peak = torch.cuda.max_memory_allocated()
    print(f"sd3 warm-up request: {warm_s:.3f} s, of which the capture "
          f"{info['compile_seconds']:.3f} s; stages {info['stages']}, graph nodes "
          f"{info['device_ops']}, graph pools {info['memory']['pool_bytes']} bytes, peak "
          f"memory allocated {peak} bytes", flush=True)
    if not eng.compiled:
        raise AssertionError("the SD3 engine was not captured")
    torch.cuda.synchronize()
    dispatch.reset_launches()
    for counter in (variant_launches, gn_plans, ln_plans, key_length_launches, route_counts):
        counter.clear()
    images, latencies = [], []
    lat = SD3_RES // cfg.vae.downsample_factor
    for seed in (1, 2):
        t0 = time.perf_counter()
        img, z = sd3_request(model, eng, ctx, y, seed)
        latencies.append(time.perf_counter() - t0)
        if not (torch.isfinite(z).all() and z.shape == (1, lat, lat, 16)
                and img.shape == (SD3_RES, SD3_RES, 3) and img.dtype == np.uint8):
            raise AssertionError(f"sd3 latents {tuple(z.shape)} not finite or image "
                                 f"{img.shape} {img.dtype}")
        images.append(img)
        print(f"sd3 replayed request seed={seed}: {latencies[-1]:.4f} s; max |z| "
              f"{z.abs().max().item():.3f}", flush=True)
    launches = dict(dispatch.launches)
    variants, routes = dict(variant_launches), dict(route_counts)
    gn, ln = dict(gn_plans), dict(ln_plans)
    key_lengths = {s: n for s, n in key_length_launches.items() if n}
    want, want_keys, want_routes = sd3_plan(cfg, SD3_STEPS, requests=2)
    want_variants = {}
    for s, n in want_keys.items():  # the decode's mid-block at lat x lat keys, d = 512
        add_variant(want_variants, site_variant(
            512 if s == lat * lat else cfg.transformer.attention_head_dim, s), n)
    print(f"sd3 kernel launches over the 2 replayed requests: {launches} (expected {want}); "
          f"by key length {key_lengths} (expected {want_keys}); by variant {variants}; "
          f"GroupNorm plans { {str(p): n for p, n in gn.items()} }; LayerNorm plans "
          f"{ {str(p): n for p, n in ln.items()} }; norm calls by (norm, route) {routes} "
          f"(expected {want_routes})", flush=True)
    if (launches != want or key_lengths != want_keys or routes != want_routes
            or {k: v for k, v in variants.items() if v} != want_variants
            or sum(ln.values()) != want["fused_layer_norm"]):
        raise AssertionError(f"sd3 launches {launches}, {key_lengths}, {variants}, {routes} "
                             f"!= {want}, {want_keys}, {want_routes}")
    if np.array_equal(images[0], images[1]):
        raise AssertionError("two seeds gave the same SD3 image")
    eager_eng = sd3_sample_decode_engine(model, SD3_STEPS, 1, SD3_RES, SD3_RES, capture=False)
    t0 = time.perf_counter()
    eager = sd3_request(model, eager_eng, ctx, y, 1)[0]
    eager_latency = time.perf_counter() - t0
    differ = int((eager != images[0]).sum())
    print(f"sd3 eager request seed=1: {eager_latency:.4f} s; bytes that differ from the "
          f"replayed image: {differ} of {eager.size}; image mean {images[0].mean():.2f} "
          f"std {images[0].std():.2f}", flush=True)
    if differ:
        raise AssertionError(f"the replayed SD3 image differs from the eager one in "
                             f"{differ} bytes")
    del eng, eager_eng, model, ctx, y
    gc.collect()
    torch.cuda.empty_cache()
    return {"kernels": rows, "latencies": latencies, "eager_latency": eager_latency,
            "launches": launches, "key_lengths": key_lengths, "routes": {
                f"{norm}:{route}": n for (norm, route), n in routes.items()},
            "text_towers_ms": towers_ms, "peak_bytes": peak, "warm_s": warm_s,
            "engine": info}


# ------------------------------------------------------------ training phase


def train_attention_launches(cfg, res, remat=False):
    """fused_attention_packed launches of one train step at `res`: every
    kernel-gated attention site of one evaluation of the ControlNet and the
    UNet (the forward), and with remat the sites of the blocks a gradient
    passes through again (torch.utils.checkpoint runs a block's forward
    again only where it kept a graph: the ControlNet's blocks and the UNet's
    decoder; the frozen UNet's encoder and middle block see no input that
    requires grad)."""
    from stablediffusioneo_tpu_torch.models.unet import decoder_plan, encoder_plan

    ucfg = cfg.unet
    lat = res // cfg.vae.downsample_factor
    levels = len(ucfg.channel_mult)
    mid = {"attn": True, "cout": ucfg.model_channels * ucfg.channel_mult[-1],
           "ds": 2 ** (levels - 1), "depth": ucfg.depth_for(levels - 1)}

    def sites(blocks):
        n = 0
        for d in blocks:
            if d["attn"]:
                tq = (lat // d["ds"]) ** 2
                for s in (tq, text_length(cfg)):
                    if attention_route((1, tq, d["cout"]), s, torch.bfloat16) == \
                            "fused_attention_packed":
                        n += d["depth"]
        return n

    enc, dec = encoder_plan(ucfg) + [mid], decoder_plan(ucfg)
    forward = 2 * sites(enc) + sites(dec)
    return forward + (sites(enc) + sites(dec) if remat else 0)


def train_batch(cfg, res, batch):
    """The JAX bench's train-row batch: x0 N(0,1), hint U[0,1), ctx N(0,1)
    from default_rng(2946901), on the card."""
    rng = np.random.default_rng(TRAIN_SEED)
    f = cfg.vae.downsample_factor
    out = {"x0": rng.standard_normal((batch, res // f, res // f, 4), np.float32),
           "hint": rng.random((batch, res, res, 3)).astype(np.float32),
           "ctx": rng.standard_normal((batch, 77, cfg.unet.context_dim), np.float32)}
    return {k: torch.from_numpy(v).cuda() for k, v in out.items()}


def traced_train_step(fn):
    """(device ms, the attention kernels' ms, the attention backward's ms,
    the AdamW step's ms, device operations) of one call of fn, from one
    torch.profiler trace: the kernels' and copies' durations (the ranges
    that annotations mark on the device are not counted: they span
    kernels, and would count them twice). The backward (plain PyTorch,
    ops/kernels/attention.py:packed_bwd) is read off a record_function range
    put around it for this trace only, the optimizer off the range
    torch.optim puts around its step: the device time of the kernels
    launched inside. None where the profiler gives no device events."""
    from torch.profiler import ProfilerActivity, profile
    from stablediffusioneo_tpu_torch.ops.kernels import attention as ka

    real = ka.packed_bwd

    def annotated(*args):
        with torch.profiler.record_function("sdeo_attention_backward"):
            return real(*args)

    ka.packed_bwd = annotated
    try:
        for attempt in range(3):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            events = prof.events()
            dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
            total = sum(e.device_time for e in dev)
            if total > 0:
                break
            time.sleep(0.5 * (attempt + 1))
        else:
            return None
    finally:
        ka.packed_bwd = real
    fwd = sum(e.device_time for e in dev if FAMILIES["attention"] in e.name)

    def inside(name):
        return sum(getattr(e, "device_time_total", 0) for e in events
                   if e.name.startswith(name) and e.device_type == torch.autograd.DeviceType.CPU)

    return (total / 1e3, fwd / 1e3, inside("sdeo_attention_backward") / 1e3,
            inside("Optimizer.step") / 1e3, len(dev))


def train_run(model, unet, cfg, name):
    """One row of the JAX bench's train recipe (TRAIN_RUNS): a first step
    timed apart, TRAIN_STEPS timed steps each closed by float(loss) (their
    launches counted from 0 and held to train_attention_launches), the peak
    memory of the steps, one traced step."""
    from stablediffusioneo_tpu_torch.ops import dispatch
    from stablediffusioneo_tpu_torch.training.trainer import (
        create_train_state, make_schedule_buffers, train_step)

    res, b, remat = TRAIN_RUNS[name]
    batch = train_batch(cfg, res, b)
    sa, s1 = make_schedule_buffers(cfg, "cuda")
    state, tx = create_train_state(model.control_model, TRAIN_LR)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    dispatch.set_kernels(remat=remat)

    def step():
        nonlocal state
        state, loss = train_step(state, tx, unet, cfg, sa, s1, batch, key=0)
        return float(loss)

    try:
        t0 = time.perf_counter()
        first = step()
        first_s = time.perf_counter() - t0
        dispatch.reset_launches()
        times, losses = [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            losses.append(step())
            times.append(time.perf_counter() - t0)
        launches = dict(dispatch.launches)
        peak = torch.cuda.max_memory_allocated()
        trace = traced_train_step(step)
    finally:
        dispatch.set_kernels(remat=False)
    per_step = train_attention_launches(cfg, res, remat)
    want = dict.fromkeys(KERNELS, 0)
    want["fused_attention_packed"] = per_step * TRAIN_STEPS
    add_norms(want, (train_norms(cfg, res, b), TRAIN_STEPS))
    p50 = statistics.median(times)
    row = {"resolution": res, "batch": b, "remat": remat, "first_step_s": first_s,
           "step_s": times, "p50_s": p50, "steps_per_s": 1 / p50, "samples_per_s": b / p50,
           "peak_bytes": peak, "resident_bytes": resident, "losses": [first] + losses,
           "launches": launches, "attention_launches_per_step": per_step}
    if trace is not None:
        row.update(device_ms=trace[0], attention_kernel_ms=trace[1],
                   attention_backward_ms=trace[2], adamw_ms=trace[3], device_ops=trace[4])
    print(f"{name}: first step {first_s:.3f} s (loss {first:.4f}); {TRAIN_STEPS} steps p50 "
          f"{p50 * 1e3:.1f} ms ({', '.join(f'{t * 1e3:.1f}' for t in times)}) -> "
          f"{1 / p50:.3f} steps/s, {b / p50:.2f} samples/s; peak {peak / 1e9:.2f} GB "
          f"({resident / 1e9:.2f} GB resident before); losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; launches {launches} (expected "
          f"{per_step} packed a step)", flush=True)
    if trace is None:
        print(f"{name}: traced step not measured (the profiler gave no device events)",
              flush=True)
    else:
        print(f"{name}: traced step: device time {trace[0]:.1f} ms in {trace[4]} device "
              f"operations (idle share of the p50 step {1 - trace[0] / 1e3 / p50:.3f}); "
              f"attention kernels (forward) {trace[1]:.2f} ms, attention backward (plain "
              f"PyTorch) {trace[2]:.2f} ms, AdamW {trace[3]:.2f} ms", flush=True)
    if launches != want or not all(math.isfinite(x) for x in row["losses"]):
        raise AssertionError(f"{name}: launches {launches} != {want}, or a loss is not finite")
    del state, tx
    return row


def step_grads(control, unet, cfg, params, batch, t, noise):
    """The diffusion loss's gradients of `params` (not stepped) and the loss."""
    from stablediffusioneo_tpu_torch.training.trainer import diffusion_loss, make_schedule_buffers

    sa, s1 = make_schedule_buffers(cfg, batch["x0"].device)
    loss = diffusion_loss(control, unet, cfg, sa, s1, batch["x0"], batch["hint"], batch["ctx"],
                          t, noise, controlnet_params=params)
    names = list(params)
    return dict(zip(names, torch.autograd.grad(loss, [params[n] for n in names]))), loss.item()


def max_rel(a, b):
    """max over tensors of max |a - b| / max |b|, and the tensor's name."""
    return max((((a[n].float() - b[n].float()).abs().max() / b[n].float().abs().max()).item(), n)
               for n in b)


def train_remat_check(model, unet, cfg):
    """One step's gradients at 512x512 b2, bf16, from the same masters and
    draws: twice without remat (the run-to-run spread) and once with."""
    from stablediffusioneo_tpu_torch.ops import dispatch
    from stablediffusioneo_tpu_torch.training.trainer import step_draws

    batch = train_batch(cfg, 512, 2)
    t, noise = step_draws(0, 0, batch["x0"], cfg.diffusion.timesteps)
    params = {n: p.detach().float().clone().requires_grad_() for n, p in
              model.control_model.named_parameters()}
    a = step_grads(model.control_model, unet, cfg, params, batch, t, noise)[0]
    b = step_grads(model.control_model, unet, cfg, params, batch, t, noise)[0]
    dispatch.set_kernels(remat=True)
    try:
        c = step_grads(model.control_model, unet, cfg, params, batch, t, noise)[0]
    finally:
        dispatch.set_kernels(remat=False)
    spread, remat = max_rel(b, a), max_rel(c, a)
    print(f"remat determinism, 512x512 b2 bf16, one step's ControlNet gradients: two runs "
          f"without remat differ by {spread[0]:.3e} x max |g| at most ({spread[1]}); remat "
          f"against no remat {remat[0]:.3e} ({remat[1]})", flush=True)
    if remat[0] > GRAD_TOL[torch.bfloat16]:
        raise AssertionError(f"remat gradients differ: {remat}")
    return {"spread": spread[0], "remat": remat[0]}


def train_reference(model, cfg):
    """One train step's loss and ControlNet gradients at full width, 256x256
    batch 1, fp32, the same t and noise: the card (through the kernels: the
    packed attention Function at the 1024-token sites; the norms of the
    frozen UNet's encoder, whose inputs need no gradient, on the norm
    kernels) against the CPU (plain versions), per tensor within
    TRAIN_REF_TOL; the level-0 attention projections' gradients are non-zero
    on the card."""
    from stablediffusioneo_tpu_torch.ops import dispatch

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    g = torch.Generator().manual_seed(4)
    batch = {"x0": torch.randn((1, 32, 32, 4), generator=g),
             "hint": (torch.rand((1, 256, 256, 3), generator=g) > 0.8).float(),
             "ctx": torch.randn((1, 77, cfg.unet.context_dim), generator=g)}
    t, noise = torch.tensor([500]), torch.randn((1, 32, 32, 4), generator=g)
    out = {}
    for dev in ("cuda", "cpu"):
        control, unet = ((model.control_model, model.unet) if dev == "cuda" else
                         (copy.deepcopy(model.control_model).cpu(), copy.deepcopy(model.unet).cpu()))
        params = {n: p.detach().float().clone().requires_grad_() for n, p in
                  control.named_parameters()}
        dispatch.reset_launches()
        t0 = time.perf_counter()
        grads, loss = step_grads(control, unet, cfg32, params,
                                 {k: v.to(dev) for k, v in batch.items()}, t.to(dev),
                                 noise.to(dev))
        out[dev] = ({n: v.cpu() for n, v in grads.items()}, loss, dict(dispatch.launches),
                    time.perf_counter() - t0)
        del control, unet, params, grads
    err, worst = max_rel(out["cuda"][0], out["cpu"][0])
    level0 = [n for n in out["cuda"][0] if n.startswith("input_blocks.1.1.transformer_blocks.0.")
              and n.split(".")[-2] in ("to_q", "to_k", "to_v")]
    zero = [n for n in level0 if out["cuda"][0][n].abs().max().item() == 0]
    want = dict.fromkeys(KERNELS, 0)
    want["fused_attention_packed"] = train_attention_launches(cfg, 256)
    add_norms(want, (train_norms(cfg, 256, 1), 1))
    print(f"train reference: full-width ControlNet step 256x256 b1 fp32, card vs CPU: loss "
          f"{out['cuda'][1]:.6f} / {out['cpu'][1]:.6f}; gradients of {len(out['cpu'][0])} tensors, "
          f"max |d| / max |CPU| {err:.3e} ({worst}); level-0 attention projections "
          f"{len(level0)}, all non-zero on the card: {not zero}; card launches "
          f"{out['cuda'][2]}; {out['cuda'][3]:.2f} s on the card, {out['cpu'][3]:.1f} s on the CPU",
          flush=True)
    if err > TRAIN_REF_TOL or zero or len(level0) != 6 or out["cuda"][2] != want or \
            abs(out["cuda"][1] - out["cpu"][1]) > TRAIN_REF_TOL * abs(out["cpu"][1]):
        raise AssertionError(f"train reference failed: {err} ({worst}), zero {zero}, "
                             f"launches {out['cuda'][2]} (expected {want})")
    return {"max_rel_err": err, "worst": worst, "loss": [out["cuda"][1], out["cpu"][1]],
            "cpu_s": out["cpu"][3]}


def train_lora(model, unet, cfg):
    """LoRA rank 8 on the ControlNet, 2 steps at 256x256 b8 (the train
    row's batch): the base weights equal in bytes after, every factor
    moved."""
    from stablediffusioneo_tpu_torch.ops import dispatch
    from stablediffusioneo_tpu_torch.training.lora import (
        _get, _site_paths, init_lora, lora_train_step)
    from stablediffusioneo_tpu_torch.training.trainer import (
        create_train_state, make_schedule_buffers)

    base = model.control_model
    before = {n: p.detach().clone() for n, p in base.named_parameters()}
    lora = init_lora(torch.Generator(device="cuda").manual_seed(1), base, rank=LORA_RANK)
    first = {p: {k: v.clone() for k, v in _get(lora, p).items()} for p in _site_paths(lora)}
    state, tx = create_train_state(base, TRAIN_LR, params=lora)
    batch = train_batch(cfg, 256, 8)
    sa, s1 = make_schedule_buffers(cfg, "cuda")
    dispatch.reset_launches()
    losses, times = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        state, loss = lora_train_step(state, tx, {"unet": unet, "controlnet": base}, cfg, sa, s1,
                                      batch, key=0)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
    launches = dict(dispatch.launches)
    same = all(torch.equal(p, before[n]) for n, p in base.named_parameters())
    moved = {f: sum(not torch.equal(_get(state.params, p)[f], first[p][f]) for p in first)
             for f in ("a", "b")}
    print(f"LoRA training: rank {LORA_RANK} on the ControlNet, {len(first)} sites, 2 steps "
          f"256x256 b8: {', '.join(f'{t:.3f}' for t in times)} s, losses {losses}; base "
          f"weights equal in bytes: {same}; sites whose a / b moved: {moved['a']} / "
          f"{moved['b']}; launches {launches}", flush=True)
    want = 2 * train_attention_launches(cfg, 256)
    if not same or moved != {"a": len(first), "b": len(first)} or \
            launches["fused_attention_packed"] != want:
        raise AssertionError(f"LoRA training failed: {same}, {moved}, {launches}")
    return {"sites": len(first), "step_s": times, "losses": losses, "launches": launches}


def train_resume(model, unet, cfg):
    """Save after step 1, restore into a fresh state, take step 2, at
    256x256 b8: against two uninterrupted runs of both steps (their
    difference is the spread the comparison is held to)."""
    from stablediffusioneo_tpu_torch.training.loop import restore_checkpoint, save_checkpoint
    from stablediffusioneo_tpu_torch.training.trainer import (
        create_train_state, make_schedule_buffers, train_step)

    batch = train_batch(cfg, 256, 8)
    sa, s1 = make_schedule_buffers(cfg, "cuda")

    def run(directory=None):
        state, tx = create_train_state(model.control_model, TRAIN_LR)
        for i in range(2):
            if i == 1 and directory:
                path = os.path.join(directory, "state.pt")
                t0 = time.perf_counter()
                save_checkpoint(path, state)
                state, tx = create_train_state(model.control_model, TRAIN_LR)
                state = restore_checkpoint(path, state)
                times.append(time.perf_counter() - t0)
            state, loss = train_step(state, tx, unet, cfg, sa, s1, batch, key=0)
            float(loss)
        return {n: p.detach() for n, p in state.params.items()}

    times = []
    a, b = run(), run()
    with tempfile.TemporaryDirectory() as directory:
        c = run(directory)
        size = os.path.getsize(os.path.join(directory, "state.pt"))
    spread, err = max_rel(b, a)[0], max_rel(c, a)[0]
    print(f"resume: save after step 1 ({size / 1e9:.2f} GB, save + restore {times[0]:.2f} s), "
          f"step 2 against two uninterrupted runs: max |d| / max |p| {err:.3e}; the two "
          f"uninterrupted runs differ by {spread:.3e}", flush=True)
    if err > 2 * spread:
        raise AssertionError(f"the resumed step differs by {err}, beyond the spread {spread}")
    return {"max_rel_err": err, "spread": spread, "file_bytes": size, "save_restore_s": times[0]}


class StandInLoader:
    """Stands in for training/data.py:ImagePairLoader (no dataset is in the
    repository): seeded uint8 (source, target) pairs and their indices."""

    def __init__(self, batch, res, n, seed):
        self.batch, self.res, self.n = batch, res, n
        self.rng = np.random.default_rng(seed)

    def next(self):
        shape = (self.batch, self.res, self.res, 3)
        return {"source": (self.rng.random(shape) > 0.8).astype(np.uint8) * 255,
                "target": self.rng.integers(0, 256, shape, dtype=np.uint8),
                "indices": self.rng.integers(0, self.n, self.batch).astype(np.int32)}


def train_user_path(model, cfg):
    """The user's path: controlnet_batches over a stand-in loader (256x256
    b2), the runtime's captured CLIP engine (encode_prompt) and VAE encoder
    (encode_image, a seeded posterior sample a step), then 2 steps of
    train() with EMA and a metrics file. The runtime casts the model to
    bf16 in place, so this runs last."""
    from stablediffusioneo_tpu_torch.ops import dispatch
    from stablediffusioneo_tpu_torch.runtime.engine import CNSDRuntime
    from stablediffusioneo_tpu_torch.training.data import controlnet_batches
    from stablediffusioneo_tpu_torch.training.loop import train

    found = {"PIL": subprocess.run([sys.executable, "-c", "import PIL"],
                                   capture_output=True).returncode == 0,
             "png.h": os.path.exists("/usr/include/png.h"),
             "jpeglib.h": os.path.exists("/usr/include/jpeglib.h")}
    print(f"user path: this machine has {found} (the native loader needs the headers; the "
          "stand-in loader needs neither)", flush=True)
    rt = CNSDRuntime(model, cfg, device="cuda")
    prompts = [f"{PROMPT}, number {i}" for i in range(8)]

    def encode_image(u8, step):
        img = torch.from_numpy(u8).cuda().float() / 127.5 - 1.0
        return rt.encode_image(img, torch.Generator(device="cuda").manual_seed(step))

    warm = StandInLoader(2, 256, len(prompts), 5).next()  # captures both engines
    rt.encode_prompt(stand_in_tokenizer(prompts[:2]))
    encode_image(warm["target"], 0)
    data = controlnet_batches(StandInLoader(2, 256, len(prompts), 6), prompts,
                              stand_in_tokenizer, rt.encode_prompt, encode_image)
    before = {n: p.detach().clone() for n, p in model.control_model.named_parameters()}
    with tempfile.TemporaryDirectory() as directory:
        metrics = os.path.join(directory, "metrics.jsonl")
        dispatch.reset_launches()
        t0 = time.perf_counter()
        state = train(cfg, model.unet, model.control_model, data, num_steps=2,
                      learning_rate=TRAIN_LR, metrics_path=metrics, device="cuda")
        seconds = time.perf_counter() - t0
        launches = dict(dispatch.launches)
        records = [json.loads(x) for x in open(metrics).read().splitlines()]
    moved = sum(not torch.equal(p, before[n].float()) for n, p in state.params.items())
    want = dict.fromkeys(KERNELS, 0)
    want.update(fused_attention_packed=2 * train_attention_launches(cfg, 256), fused_attention=2)
    # a step's batch: one CLIP call and one VAE encode (b2), then the step
    add_norms(want, (_tower_norms(cfg.clip), 2), (_vae_encoder_norms(cfg.vae, 256, 2), 2),
              (train_norms(cfg, 256, 2), 2))
    print(f"user path: 2 train() steps at 256x256 b2 from the stand-in loader in {seconds:.2f} s, "
          f"metrics {records}; tensors moved {moved} of {len(before)}; EMA kept: "
          f"{state.ema is not None}; launches {launches} (expected {want})", flush=True)
    if launches != want or len(records) != 2 \
            or not all(math.isfinite(r["loss"]) for r in records) \
            or not moved or state.ema is None:
        raise AssertionError(f"user path failed: {launches}, {records}, {moved}")
    rt.release()
    return {"seconds": seconds, "losses": [r["loss"] for r in records], "launches": launches,
            "found": found}


def training_phase(cfg):
    """ControlNet fine-tuning at the full SD-1.5 widths, seeded weights."""
    from stablediffusioneo_tpu_torch.training.trainer import frozen

    model = build_model(cfg, seed=0)
    out = {"reference": train_reference(model, cfg)}
    unet = frozen(model.unet, cfg.dtype)
    out["runs"] = {name: train_run(model, unet, cfg, name) for name in TRAIN_RUNS}
    off, on = out["runs"]["train 512 b2"], out["runs"]["train 512 b2, remat"]
    print(f"remat at 512x512 b2: peak {on['peak_bytes'] / 1e9:.2f} GB against "
          f"{off['peak_bytes'] / 1e9:.2f}, step p50 {on['p50_s'] * 1e3:.1f} ms against "
          f"{off['p50_s'] * 1e3:.1f}", flush=True)
    out["remat_check"] = train_remat_check(model, unet, cfg)
    out["lora"] = train_lora(model, unet, cfg)
    out["resume"] = train_resume(model, unet, cfg)
    del unet
    gc.collect()
    torch.cuda.empty_cache()
    out["user_path"] = train_user_path(model, cfg)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------- parallel phase
# Ranks spawned on the one card: gloo (NCCL takes one rank a device), the
# collectives staged through pinned host memory (parallel/mesh.py), engines
# eager; then one rank over NCCL with captured engines.
PARALLEL_RES, PARALLEL_STEPS = 256, 4  # the fp32 process() checks
# (mesh, fused norms) of the fp32 PARALLEL_RES x PARALLEL_STEPS requests and
# of the bf16 RES x STEPS ones
PARALLEL_FP32_RUNS = (("dp=2", False), ("tp=2", False), ("sp=2", False),
                      ("tp=2", True), ("sp=2", True))
PARALLEL_BF16_RUNS = (("tp=2", True), ("sp=2", True))
# the fp32 latents of a mesh request against the unsharded request on the
# card, max |d| / max |ref|: sound meshes read 5.0e-6 to 5.8e-6, a skipped
# row-parallel all-reduce at the UNet's middle block 3.5e-3 (PR 17's runs);
# and the images within PARALLEL_IMAGE_TOL of 255 (sound: 1, a rounding)
PARALLEL_TOL, PARALLEL_IMAGE_TOL = 2e-5, 1
# faults planted in a rank's sharded model, each run as an fp32 request of
# its mesh that the checks above must fail: (mesh, what, module, how)
PARALLEL_FAULTS = (
    ("tp=2", "one row-parallel all-reduce skipped (the UNet middle block's "
     "cross-attention output)", "unet.middle_block.1.transformer_blocks.0.attn2.to_out.0",
     "no reduce"),
    ("sp=2", "one conv's halo rows zeroed (the UNet's output conv)", "unet.out.2", "no halo"),
    ("sp=2", "one conv's halo rows zeroed (the ControlNet's first ResBlock conv)",
     "control_model.input_blocks.1.0.in_layers.2", "no halo"),
    ("sp=2", "one conv's halo rows zeroed (the VAE decoder's output conv)",
     "first_stage_model.decoder.conv_out", "no halo"),
)
PP_TOL = 1e-4  # the fp32 pp towers against the sequential ones, relative to max |ref|
TRAIN_CHECK_LR = 1e-5
# one train step's parameter moves against the single-process step's, summed
# over a rank's slices: sum |d move| <= TRAIN_MOVE_TOL x sum |move| (a step
# left untaken reads 1)
TRAIN_MOVE_TOL = 1e-4  # sound: 8.6e-6 to 8.7e-6 (PR 17's run)
# the bf16 512x512 20-step requests at tp=2 and sp=2 (fused norms on) against
# the unsharded image: the share of pixels off by more than 1 may be at most
# this multiple of the share of the unsharded request against itself with
# one x_T value scaled by 1.01 (the serving phase's control). The fp32 checks
# hold the function; bf16 on these near-flat nets shows rounding order, which
# 20 steps spread as they spread that control's last-bit change.
PARALLEL_PIXEL_SLACK = 1.5


def _hold(ok, what):
    """The parallel phase's checks: a failed one fails the run."""
    if not ok:
        raise AssertionError(what)


def _rank_entry(rank, world, store, backend, job, out_dir):
    """A spawned rank: one process group over a FileStore, the card 0, the
    job (a function of this module) and its result in a file."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        result = globals()[job](rank)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(job, world, backend):
    """Every rank's result of job(rank) in `world` spawned processes."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_rank_entry, args=(world, os.path.join(d, "store"), backend, job, d),
                 nprocs=world, join=True)
        return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


def card_generator(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def _say(rank, text):
    if rank == 0:
        print(text, flush=True)


def _launched(before):
    from stablediffusioneo_tpu_torch.ops import dispatch

    return {k: v for k, v in dispatch.counts_since(before)[0].items() if v}


def _parallel_request(pipe, batch, res, steps, x_T, seed=1):
    """One process() of the smoke image at res, `steps` steps, x_T handed
    in; (images, latents, seconds)."""
    import cv2

    img = cv2.resize(smoke_image(), (res, res), interpolation=cv2.INTER_AREA)
    t0 = time.perf_counter()
    out = pipe.process(img, PROMPT, num_samples=batch, image_resolution=res,
                       ddim_steps=steps, scale=9.0, seed=seed, x_T=x_T)
    torch.cuda.synchronize()
    return np.stack(out[1:]), pipe.last_latents.float().cpu(), time.perf_counter() - t0


def plant_fault(model, module, how):
    """A planted fault in a rank's sharded model: "no reduce" drops a
    row-parallel linear's all-reduce (it adds its bias to this rank's
    partial product), "no halo" makes a row-split conv pad this rank's rows
    with zeros instead of its neighbours' rows."""
    m = model.get_submodule(module)
    if how == "no reduce":
        m.tp_row = None
    else:
        m.__class__ = torch.nn.Conv2d


def parallel_inference_job(rank):
    """(a) SD-1.5 + ControlNet at full width through process() on meshes of
    the two ranks: fp32 at PARALLEL_RES x PARALLEL_STEPS, each of
    PARALLEL_FP32_RUNS against the unsharded request on the card (within
    PARALLEL_TOL), and each of PARALLEL_FAULTS outside it; then the bf16
    512x512 20-step requests of PARALLEL_BF16_RUNS against the unsharded
    image (pixel share beside its control). Each mesh path's launch counts
    start from 0 and are read after it, and each rank's launches, by kernel
    and by attention call, must be the plan's (mesh_plan)."""
    from stablediffusioneo_tpu_torch.config import sd15_pipeline
    from stablediffusioneo_tpu_torch.ops import dispatch
    from stablediffusioneo_tpu_torch.ops.kernels import attention as ka
    from stablediffusioneo_tpu_torch.parallel import make_mesh
    from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline

    out = {"fp32": {}, "bf16": {}, "faults": {}, "launches": {}}
    meshes = {"dp=2": make_mesh(dp=2), "tp=2": make_mesh(dp=1, tp=2),
              "sp=2": make_mesh(dp=1, sp=2)}
    _say(rank, f"parallel: meshes {meshes['tp=2']!r} ...; transport "
               f"{meshes['tp=2'].transport}")
    flags = dispatch.kernel_flags()
    g = torch.Generator().manual_seed(11)
    f = 8
    for dtype, res, steps, runs in (("float32", PARALLEL_RES, PARALLEL_STEPS, PARALLEL_FP32_RUNS),
                                    ("bfloat16", RES, STEPS, PARALLEL_BF16_RUNS)):
        cfg = sd15_pipeline(dtype=dtype)
        model = build_model(sd15_pipeline(), seed=0)
        x_T = torch.randn((2, res // f, res // f, 4), generator=g).numpy()
        for norms in sorted({n for _, n in runs}):
            dispatch.set_kernels(groupnorm=norms, layernorm=norms)
            tag = f"{dtype}{', fused norms' if norms else ''}"
            mine = [name for name, n in runs if n == norms]
            ref_pipe = Canny2ImagePipeline(copy.deepcopy(model), stand_in_tokenizer, cfg,
                                           graphs=False)
            refs = {b: _parallel_request(ref_pipe, b, res, steps, x_T[:b])
                    for b in sorted({2 if name == "dp=2" else 1 for name in mine})}
            if dtype == "bfloat16":
                ctl = x_T[:1].copy()
                ctl[0, res // (2 * f), res // (2 * f), 0] *= 1.01
                control = pixel_share(refs[1][0],
                                      _parallel_request(ref_pipe, 1, res, steps, ctl)[0])
            del ref_pipe
            faults = PARALLEL_FAULTS if dtype == "float32" and not norms else ()
            for name, what, module, how in [(n, None, None, None) for n in mine] + list(faults):
                batch = 2 if name == "dp=2" else 1
                pipe = Canny2ImagePipeline(model, stand_in_tokenizer, cfg, mesh=meshes[name])
                if what:
                    plant_fault(pipe.runtime.model, module, how)
                before, shapes = dispatch.counts(), collections.Counter(ka.shape_launches)
                imgs, lat, sec = _parallel_request(pipe, batch, res, steps, x_T[:batch])
                launched = _launched(before)
                shapes = {k: v for k, v in (collections.Counter(ka.shape_launches)
                                            - shapes).items()}
                ref_imgs, ref_lat, ref_sec = refs[batch]
                _hold(bool(torch.isfinite(lat).all()) and imgs.shape == ref_imgs.shape,
                      f"parallel {name} {tag}: {imgs.shape}")
                d_img = int(np.abs(imgs.astype(int) - ref_imgs.astype(int)).max())
                if what:
                    err = (lat - ref_lat).abs().max().item() / ref_lat.abs().max().item()
                    out["faults"][what] = {"mesh": name, "max_rel_err": err,
                                           "image_max_abs": d_img, "request_s": sec}
                    _say(rank, f"parallel {name} fp32, planted fault: {what}: latents max|d| "
                               f"/ max|ref| {err:.3e}, images max|d| {d_img} (one must exceed "
                               f"PARALLEL_TOL {PARALLEL_TOL} / PARALLEL_IMAGE_TOL "
                               f"{PARALLEL_IMAGE_TOL})")
                    _hold(err > PARALLEL_TOL or d_img > PARALLEL_IMAGE_TOL,
                          f"parallel fault passed the checks: {what}: {err}, {d_img}")
                    del pipe
                    continue
                want_k, want_s = mesh_plan(cfg, res, steps, getattr(torch, dtype),
                                           {name[:2]: 2}, batch, norms)
                _say(rank, f"parallel {name} {tag}: launches {launched}, by attention "
                           f"call (batch, heads, Tq, S, d) {shapes}")
                _hold(launched == want_k and shapes == want_s,
                      f"parallel {name} {tag}: rank {rank} launched {launched} {shapes}, "
                      f"the plan {want_k} {want_s}")
                if dtype == "float32":
                    err = (lat - ref_lat).abs().max().item() / ref_lat.abs().max().item()
                    out["fp32"][f"{name}{', fused norms' if norms else ''}"] = {
                        "max_rel_err": err, "image_max_abs": d_img, "request_s": sec,
                        "unsharded_s": ref_sec}
                    _say(rank, f"parallel {name} {tag}: {res}x{res} x {steps} steps, batch "
                               f"{batch}, latents against the unsharded request: max|d| / "
                               f"max|ref| {err:.3e} (PARALLEL_TOL {PARALLEL_TOL}), images "
                               f"max|d| {d_img} (PARALLEL_IMAGE_TOL {PARALLEL_IMAGE_TOL}); "
                               f"request {sec:.2f} s (unsharded {ref_sec:.2f} s)")
                    _hold(err <= PARALLEL_TOL and d_img <= PARALLEL_IMAGE_TOL,
                          f"parallel {name} {tag}: {err}, images {d_img}")
                else:
                    share = pixel_share(ref_imgs, imgs)
                    limit = PARALLEL_PIXEL_SLACK * control
                    out["bf16"][name] = {"pixel_share_off": share, "control": control,
                                         "limit": limit, "image_max_abs": d_img,
                                         "request_s": sec, "unsharded_s": ref_sec}
                    _say(rank, f"parallel {name} {tag}: {res}x{res} x {steps} steps against "
                               f"the unsharded image: share of pixels off by > 1 {share:.4f} "
                               f"(control, one x_T value x 1.01: {control:.4f}; limit "
                               f"{limit:.4f}), max|d| {d_img}; request {sec:.2f} s "
                               f"(unsharded {ref_sec:.2f} s)")
                    _hold(share <= limit, f"parallel {name} bf16: {share} > {limit}")
                out["launches"][f"{name} {tag}"] = launched
                del pipe
                gc.collect()
                torch.cuda.empty_cache()
        del model
        gc.collect()
        torch.cuda.empty_cache()
    dispatch.set_kernels(**dict(flags))
    return out


def parallel_towers_job(rank):
    """(b) CLIP ViT-L (12 layers) and T5 v1.1-large (24 blocks) at pp=2,
    (2, 77), fp32, against the sequential towers on the card."""
    from stablediffusioneo_tpu_torch.config import sd15_pipeline
    from stablediffusioneo_tpu_torch.models.cldm import init_clip_text
    from stablediffusioneo_tpu_torch.models.clip import clip_text_apply, clip_text_apply_pp
    from stablediffusioneo_tpu_torch.models.t5 import T5Config, init_t5, t5_encode, t5_encode_pp
    from stablediffusioneo_tpu_torch.parallel import make_mesh

    mesh = make_mesh(pp=2, dp=1)
    g = torch.Generator().manual_seed(5)
    ccfg, tcfg = sd15_pipeline().clip, T5Config()
    clip = init_clip_text(card_generator(3), ccfg)
    t5 = init_t5(card_generator(4), tcfg)
    ids = torch.randint(0, ccfg.vocab_size, (2, ccfg.max_length), generator=g).cuda()
    tids = torch.randint(1, tcfg.vocab_size, (2, 77), generator=g).cuda()
    mask = torch.ones_like(tids)
    mask[1, 30:] = 0
    out = {}
    with torch.no_grad():
        for name, pp, seq in (
                ("clip", lambda: clip_text_apply_pp(clip, ids, mesh),
                 lambda: clip_text_apply(clip, ids)),
                ("t5", lambda: t5_encode_pp(t5, tids, mesh), lambda: t5_encode(t5, tids)),
                ("t5 mask", lambda: t5_encode_pp(t5, tids, mesh, mask=mask),
                 lambda: t5_encode(t5, tids, mask=mask))):
            t0 = time.perf_counter()
            got = pp()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            want = seq()
            err = (got - want).abs().max().item() / want.abs().max().item()
            out[name] = {"max_rel_err": err, "seconds": sec}
            _say(rank, f"parallel pp=2 {name}: {tuple(got.shape)} against the sequential "
                       f"tower, max|d| / max|ref| {err:.3e} (PP_TOL {PP_TOL}); {sec:.3f} s")
            if not torch.isfinite(got).all() or err > PP_TOL:
                raise AssertionError(f"parallel pp {name}: {err}")
    return out


def parallel_training_job(rank):
    """(c) One full-width ControlNet train step (fp32, PARALLEL_TRAIN_RES,
    batch 2, the draws handed in) at dp=2, tp=2 and dp=2 with FSDP, against
    the single-process step: the loss within REF_TOL, AdamW's first moment
    (the step's gradients) within REF_TOL of max |ref| and the parameters'
    moves within TRAIN_MOVE_TOL of the step's, each rank on its slices."""
    from stablediffusioneo_tpu_torch.config import sd15_pipeline
    from stablediffusioneo_tpu_torch.parallel import make_mesh, shard_params
    from stablediffusioneo_tpu_torch.parallel.mesh import fsdp_dim, local_slice, tp_local
    from stablediffusioneo_tpu_torch.training import trainer

    cfg = sd15_pipeline(dtype="float32")
    model = build_model(cfg, seed=0)
    unet, control = model.unet.requires_grad_(False), model.control_model
    res, b = PARALLEL_RES, 2
    g = torch.Generator().manual_seed(9)
    batch = {"x0": torch.randn((b, res // 8, res // 8, 4), generator=g).cuda(),
             "hint": torch.rand((b, res, res, 3), generator=g).cuda(),
             "ctx": torch.randn((b, cfg.clip.max_length, cfg.unet.context_dim),
                                generator=g).cuda()}
    t = torch.randint(0, 1000, (b,), generator=g).cuda()
    noise = torch.randn(batch["x0"].shape, generator=g).cuda()
    sa, s1 = trainer.make_schedule_buffers(cfg, "cuda")

    def step(state, tx, u):
        t0 = time.perf_counter()
        state, loss = trainer.train_step(state, tx, u, cfg, sa, s1, batch, key=0, t=t,
                                         noise=noise)
        torch.cuda.synchronize()
        return state, tx, float(loss), time.perf_counter() - t0

    start = {n: p.detach().clone() for n, p in control.named_parameters()}
    ref_state, ref_tx, ref_loss, ref_s = step(*trainer.create_train_state(
        copy.deepcopy(control), TRAIN_CHECK_LR), unet)
    ref = {n: (p.detach(), ref_tx.state[p]["exp_avg"], start[n])
           for n, p in ref_state.params.items()}
    del ref_tx
    out = {"unsharded": {"loss": ref_loss, "seconds": ref_s}}
    for name, kw, fsdp in (("dp=2", dict(dp=2), False), ("tp=2", dict(dp=1, tp=2), False),
                           ("dp=2 fsdp", dict(dp=2), True)):
        mesh = make_mesh(**kw)
        u = shard_params(copy.deepcopy(unet), mesh)
        if fsdp:
            u = trainer.fsdp_frozen(u, mesh)
        net = shard_params(copy.deepcopy(control), mesh)
        state, tx, loss, sec = step(*trainer.create_train_state(
            net, TRAIN_CHECK_LR, mesh=mesh, fsdp=fsdp), u)
        tp_specs, specs = net.tp_specs, state.fsdp_specs or {}
        worst_m, off, moved = 0.0, 0.0, 0.0
        for n, p in state.params.items():
            wants = ref[n]
            if n in tp_specs:
                wants = [tp_local(w, n, tp_specs[n], mesh.axis("tp")) for w in wants]
            d = fsdp_dim(specs.get(n, ()))
            if d is not None:
                wants = [local_slice(w, mesh.axis("dp"), d) for w in wants]
            want_p, want_m, was = wants
            m = tx.state[p]["exp_avg"]
            worst_m = max(worst_m, (m - want_m).abs().max().item()
                          / max(want_m.abs().max().item(), 1e-30))
            off += (p.detach() - want_p).abs().sum().item()
            moved += (want_p - was).abs().sum().item()
        loss_err = abs(loss - ref_loss) / abs(ref_loss)
        move_err = off / moved
        out[name] = {"loss": loss, "loss_rel_err": loss_err, "moment_rel_err": worst_m,
                     "move_rel_err": move_err, "seconds": sec}
        _say(rank, f"parallel train step {name}: loss {loss:.6f} (unsharded "
                   f"{ref_loss:.6f}, rel {loss_err:.2e}); first moments max|d| / max|ref| "
                   f"{worst_m:.2e}; parameter moves off the unsharded step's, summed: "
                   f"{move_err:.2e} of theirs (TRAIN_MOVE_TOL {TRAIN_MOVE_TOL}); step "
                   f"{sec:.2f} s (unsharded {ref_s:.2f} s)")
        _hold(loss_err <= REF_TOL and worst_m <= REF_TOL and move_err <= TRAIN_MOVE_TOL,
              f"parallel train step {name} rank {rank}: {out[name]}")
        del state, tx, u, net
        gc.collect()
        torch.cuda.empty_cache()
    return out


def parallel_gloo_job(rank):
    return {"inference": parallel_inference_job(rank), "towers": parallel_towers_job(rank),
            "training": parallel_training_job(rank)}


def parallel_graphs_job(rank):
    """(d) One rank over NCCL: a mesh runtime with graphs=True captures its
    engines with the NCCL collectives inside (its mesh's dp and tp axes,
    of size 1, still run them); the replayed request equals the eager
    one (graphs=False) in bytes."""
    from stablediffusioneo_tpu_torch.config import sd15_pipeline
    from stablediffusioneo_tpu_torch.ops import dispatch
    from stablediffusioneo_tpu_torch.parallel import make_mesh
    from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline

    cfg = sd15_pipeline(dtype="bfloat16")
    mesh = make_mesh(dp=1, tp=1)
    pipe = Canny2ImagePipeline(build_model(cfg, seed=0), stand_in_tokenizer, cfg, mesh=mesh,
                               graphs=True)
    x_T = torch.randn((1, RES // 8, RES // 8, 4), generator=torch.Generator().manual_seed(2))
    first = _parallel_request(pipe, 1, RES, STEPS, x_T.numpy())
    before = dispatch.counts()
    replay = _parallel_request(pipe, 1, RES, STEPS, x_T.numpy())
    launched = _launched(before)
    engines = {e.name: e.get_engine_infor() for e in pipe.runtime._engines.values()}
    pipe.runtime.graphs = False
    eager = _parallel_request(pipe, 1, RES, STEPS, x_T.numpy())
    equal = bool(np.array_equal(replay[0], eager[0]))
    print(f"parallel graphs: NCCL mesh {mesh!r}, engines captured "
          f"{ {n: i['compiled'] for n, i in engines.items()} }; replayed request "
          f"{replay[2]:.3f} s (first, with captures, {first[2]:.2f} s), eager "
          f"{eager[2]:.3f} s, equal in bytes: {equal}; launches of the replay {launched}",
          flush=True)
    _hold(equal and all(i["compiled"] for i in engines.values()),
          f"parallel graphs: equal {equal}, engines {engines}")
    want = mesh_plan(cfg, RES, STEPS, torch.bfloat16, {})[0]
    _hold(launched == want, f"parallel graphs: the replay launched {launched}, the plan {want}")
    return {"equal": equal, "replay_s": replay[2], "eager_s": eager[2],
            "capture_s": first[2], "launches": launched,
            "device_ops": {n: i.get("device_ops") for n, i in engines.items()}}


def parallel_phase(card):
    """Ranks on the one card (see the module docstring, item 18): two over
    gloo for (a)-(c), then one over NCCL for (d)."""
    t0 = time.perf_counter()
    gloo = run_ranks("parallel_gloo_job", 2, "gloo")
    t1 = time.perf_counter()
    graphs = run_ranks("parallel_graphs_job", 1, "nccl")[0]
    t2 = time.perf_counter()
    out = {**gloo[0], "graphs": graphs, "card": card,
           "seconds": {"gloo ranks": t1 - t0, "nccl rank": t2 - t1}}
    launches = {f"parallel {k}": v for k, v in gloo[0]["inference"]["launches"].items()}
    for k, v in gloo[1]["inference"]["launches"].items():  # the other rank's
        launches[f"parallel {k}"] = {n: launches[f"parallel {k}"].get(n, 0) + c
                                     for n, c in v.items()}
    launches["parallel graphs"] = graphs["launches"]
    out["launches"] = launches
    print(f"parallel phase on {card}: {out['seconds']}", flush=True)
    return out


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
    attention_grads = attention_grad_phase()
    print(f"kernel phase done at {time.perf_counter() - t_start:.1f} s", flush=True)
    model = build_model(cfg, seed=0)
    reference_phase(model, cfg)
    print(f"reference phase done at {time.perf_counter() - t_start:.1f} s", flush=True)
    annotator_ref = annotator_reference()
    print(f"annotator reference done at {time.perf_counter() - t_start:.1f} s", flush=True)
    runs = {}
    for config in ("default", "int8", "hires", "dpmpp-karras", "euler-a",
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
    for config in ("img2img", "inpaint",
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
    annotators = annotators_phase(loaded, cfg, tokenizer)
    print(f"annotators phase done at {time.perf_counter() - t_start:.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as directory:
        detectors = detector_file_phase(loaded, cfg, tokenizer, directory)
        print(f"MLSD and UniFormer phases done at {time.perf_counter() - t_start:.1f} s",
              flush=True)
        scoring = scoring_phase(loaded, cfg, tokenizer, directory)
        print(f"scoring phase done at {time.perf_counter() - t_start:.1f} s", flush=True)
        yolo = yolo_phase(directory)
        print(f"yolo phase done at {time.perf_counter() - t_start:.1f} s", flush=True)
    native = native_phase()
    print(f"native phase done at {time.perf_counter() - t_start:.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as directory:
        drill = drill_phase(directory)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"drill phase done at {time.perf_counter() - t_start:.1f} s", flush=True)
        ready = readiness_phase(tokenizer, os.path.join(directory, "control_sd15_canny.pth"))
        gc.collect()
        torch.cuda.empty_cache()
        print(f"readiness phase done at {time.perf_counter() - t_start:.1f} s", flush=True)
    t5 = t5_phase(loaded.clip)
    print(f"t5 phase done at {time.perf_counter() - t_start:.1f} s", flush=True)
    smoke_cli = smoke_cli_phase()
    print(f"sdeo-smoke-torch phase done at {time.perf_counter() - t_start:.1f} s", flush=True)
    lora_pipe, lora = lora_phase(loaded, cfg, tokenizer)
    print(f"lora phase done at {time.perf_counter() - t_start:.1f} s", flush=True)
    inversion = textual_inversion_phase(lora_pipe, tokenizer)
    del loaded, lora_pipe
    gc.collect()
    torch.cuda.empty_cache()
    print(f"textual-inversion phase done at {time.perf_counter() - t_start:.1f} s",
          flush=True)
    runs["inpaint 9ch"] = inpaint_phase(tokenizer)
    print(f"main path (inpaint 9ch) and its checkpoint done at "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    runs["depth2img"] = depth2img_phase(tokenizer)
    print(f"depth2img checkpoint and main path done at "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    sd21_cfg, _ = family_configs()
    model = build_model(sd21_cfg, seed=0)
    references = {"sd21": unet_reference("sd21", model.unet, sd21_cfg, model.control_model)}
    runs["sd21 768"] = main_path(model, sd21_cfg, "sd21 768")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    print(f"main path (sd21 768) done at {time.perf_counter() - t_start:.1f} s", flush=True)
    references["sdxl base"] = sdxl_reference()
    print(f"sdxl base reference done at {time.perf_counter() - t_start:.1f} s", flush=True)
    model = build_sdxl(seed=0)
    for config in ("sdxl 1024",):
        runs[config] = sdxl_path(model, config, tokenizer)
        print(f"main path ({config}) done at {time.perf_counter() - t_start:.1f} s",
              flush=True)
    sdxl_checkpoint = sdxl_checkpoint_phase(model, tokenizer, runs["sdxl 1024"]["image"])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    print(f"sdxl checkpoint phase done at {time.perf_counter() - t_start:.1f} s", flush=True)
    runs["sdxl refiner 1024"] = refiner_phase(tokenizer, runs["sdxl 1024"]["latents"])
    print(f"main path (sdxl refiner 1024), its reference and checkpoint done at "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    sd3 = sd3_phase()
    print(f"sd3 phase done at {time.perf_counter() - t_start:.1f} s", flush=True)
    training = training_phase(cfg)
    print(f"training phase done at {time.perf_counter() - t_start:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    parallel = parallel_phase(card)
    print(f"parallel phase done at {time.perf_counter() - t_start:.1f} s", flush=True)
    latencies = {config: r["latencies"] for config, r in runs.items()}
    eager = {config: r["eager_latency"] for config, r in runs.items()}
    base = runs["default"]["image"].astype(np.int16)
    print(f"replayed request latency, s: {latencies}; eager request latency, s: {eager}; "
          f"seed-1 images against the default's, mean |d| of 255: int8 "
          f"{np.abs(base - runs['int8']['image']).mean():.3f}", flush=True)

    # the UniFormer row's launches: its detections' split launches at stage
    # 3's key length, two requests of one detection each
    t = uniformer_tokens(RES)
    for row in kernels["fused_attention"]:
        if "annotators:uniformer" in row["paths"]:
            row["launches"] = detectors["uniformer"]["key_lengths"].get(t, 0) \
                - expected_request_launches(cfg, "default")[1].get(t, 0)
            row["launches_per_detection"] = row["launches"] / 2
    out = []
    for name, (source, replaces) in KERNELS.items():
        rows = kernels[name]
        launches = runs[EXERCISED_BY.get(name, "default")]["launches"]
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
                                 "multi-ControlNet": multi["launches"].get(name, 0),
                                 "sd3 1024": sd3["launches"][name],
                                 **{f"annotators:{f}": r["launches"][name]
                                    for f, r in annotators["families"].items()},
                                 **{f"annotators:{f}": r["launches"][name]
                                    for f, r in detectors.items()},
                                 # the training runs: TRAIN_STEPS steps each,
                                 # LoRA and the user path 2 steps
                                 **{run: r["launches"][name]
                                    for run, r in training["runs"].items()},
                                 "train lora": training["lora"]["launches"][name],
                                 "train user path": training["user_path"]["launches"][name],
                                 # the parallel phase's requests, both ranks
                                 **{path: c.get(name, 0)
                                    for path, c in parallel["launches"].items()}},
            "max_abs_err": max(r["bf16_max_abs_err"]
                               for r in rows + kernels["checked"].get(name, [])),
            # the parallel phase's rank-local calls checked untimed
            "checked_calls": kernels["checked"].get(name, []),
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
            for config in ("sdxl 1024",)}
    families = {config: {k: runs[config][k] for k in ("peak_bytes", "warm_s", "checkpoint")}
                for config in ("inpaint 9ch", "depth2img", "sdxl refiner 1024")}
    families["depth2img"]["tower_ms"] = runs["depth2img"]["tower_ms"]
    print(json.dumps({"kernels": out, "request_s": latencies, "eager_request_s": eager,
                      "checkpoint": checkpoint, "hackathon": hack,
                      "sdxl": sdxl, "sdxl_checkpoint": sdxl_checkpoint, "sd3": sd3,
                      "lora": lora, "textual_inversion": inversion, "families": families,
                      "refiner_reference": runs["sdxl refiner 1024"]["reference"],
                      "annotators": annotators, "annotator_reference": annotator_ref,
                      "mlsd": detectors["mlsd"], "uniformer": detectors["uniformer"],
                      "yolo": yolo, "scoring": scoring, "native": native,
                      "drill": drill, "readiness": ready, "t5": t5, "smoke_cli": smoke_cli,
                      "unet_references": references,
                      "sampler_variants_request_s": variants_s,
                      "serving": serving, "multi_controlnet": multi,
                      "attention_grads": attention_grads, "training": training,
                      "parallel": parallel,
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
