"""canny2image application pipeline (counterpart of
stablediffusioneo_tpu/pipeline/canny2image.py).

`process(...)` keeps the reference's 14 arguments
  (input_image, prompt, a_prompt, n_prompt, num_samples, image_resolution,
   ddim_steps, guess_mode, strength, scale, seed, eta,
   low_threshold, high_threshold)
plus `x_T=` (and `hires_noise=`, `img2img_noise=`, `inpaint_noise=`,
`step_noise=`) for
seeded cross-framework comparison. Path: resize to /64 -> Canny -> HWC3 hint
(a binary map uploaded bit-packed, (B, H, W/8) uint8, as the JAX package
does; another annotator's map as uint8) -> one CLIP call for cond and
uncond -> DDIM with CFG ->
VAE decode -> uint8, the last three as ONE engine of the runtime
(runtime/engine.py: a captured CUDA graph on the card, the eager loop on the
CPU or with graphs=False). With hires_upscale > 1 (the hires fix): the base
pass through the sampler engine, a bilinear latent upscale, a fresh Canny of
the input at the high resolution, and an img2img refine over the last
round(hires_denoise * ddim_steps) steps through the fused engine's init-latent
variant. With quantize_linears=True the UNet and ControlNet run int8
weight-only linears (kernel with set_kernels(int8_linear=True)).
init_image (img2img) and inpaint_image + inpaint_mask (blended-latent
inpainting) go through the VAE encoder's engine first (posterior mode), then
the loop's init-latent and inpaint variants. long_prompt and prompt_emphasis
select the prompt front end (models/text_encoding.py; they need a
models/tokenizer.py:CLIPTokenizer). encoder_cache_interval and cfg_rescale
select loop variants
(pipeline/ddim.py), `sampler` the loop (DDIM, PLMS, DPM-Solver++(2M), UniPC,
Euler, Euler-a, Heun; pipeline/{plms,dpm_solver,unipc,k_diffusion}.py) and
tome_ratio token merging in both nets (ops/tome.py); granular_timings=True runs sample and decode as two
engines with a device synchronisation between, for an honest phase split.
Multi-ControlNet: a ControlLDM of N ControlNets with `annotator=[...]` (one
hint source a net, Canny where the list is short) takes one float hint a net
and `strength` as a number or a tuple of one a net.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from stablediffusioneo_tpu_torch.config import PipelineConfig, sd15_pipeline
from stablediffusioneo_tpu_torch.models.cldm import ControlLDM
from stablediffusioneo_tpu_torch.ops.layers import resize_latent_bilinear
from stablediffusioneo_tpu_torch.runtime import profiling
from stablediffusioneo_tpu_torch.runtime.engine import CNSDRuntime
from stablediffusioneo_tpu_torch.runtime.profiling import _hard_sync


def _timings(request: profiling.Span, granular: bool) -> Dict[str, float]:
    """`last_timings` from a request's spans, under the JAX package's keys in
    its order: preprocess_ms (the `pipeline.preprocess` span), clip_ms (its
    end to the end of the last `text.encode`: tokenizing and the text
    encoder's enqueue), then sample_ms, decode_ms and fetch_ms (the granular
    path's spans, each ended by a device synchronisation) or
    sample_decode_fetch_ms (the text's end to the fetch's end), and total_ms
    (the `pipeline.request` span's start to the fetch's end; the span itself
    is still open). Empty with tracing off."""
    if not request:
        return {}
    by = {}
    for sp in request.children:
        by.setdefault(sp.name, sp)  # the first of each name
    pre, fetch = by["pipeline.preprocess"], by["pipeline.fetch"]
    text_end = max((sp.t1 for sp in request.children if sp.name == "text.encode"),
                   default=pre.t1)
    out = {"preprocess_ms": pre.ms, "clip_ms": (text_end - pre.t1) * 1e3}
    if granular:
        out.update(sample_ms=by["pipeline.sample"].ms, decode_ms=by["pipeline.decode"].ms,
                   fetch_ms=fetch.ms)
    else:
        out["sample_decode_fetch_ms"] = (fetch.t1 - text_end) * 1e3
    out["total_ms"] = (fetch.t1 - request.t0) * 1e3
    return out


class Canny2ImagePipeline:
    """tokenizer: any callable mapping a list of strings to an (N, T) int
    array. annotator: a callable (image, low, high) -> hint map (or (image)
    -> map); default Canny (cv2). With a multi-ControlNet model (ControlLDM
    of N nets) a list of annotators, one a net, padded with Canny
    (`self.annotators`; None for one net). mesh: a parallel.make_mesh mesh,
    handed down to the runtime as in the JAX package: every rank of it
    builds the pipeline and makes the same process() calls, and every rank
    gets the whole result."""

    def __init__(self, model: ControlLDM, tokenizer: Callable,
                 cfg: Optional[PipelineConfig] = None, device="cuda",
                 annotator=None, quantize_linears: bool = False,
                 graphs: Optional[bool] = None, mesh=None):
        from stablediffusioneo_tpu_torch.annotators.canny import CannyDetector

        self.cfg = cfg or sd15_pipeline()
        self.tokenizer = tokenizer
        control = model.control
        if isinstance(control, tuple):
            n = len(control)
            anns = annotator if isinstance(annotator, (list, tuple)) else (
                [annotator] if annotator else [])
            anns = list(anns) + [CannyDetector()] * (n - len(anns))
            self.annotators = anns[:n]
            self.apply_canny = self.annotators[0]
        else:
            if isinstance(annotator, (list, tuple)):
                raise ValueError("annotator=[...] takes a ControlLDM of one "
                                 "ControlNet an annotator (n_controlnets)")
            self.annotators = None
            self.apply_canny = annotator or CannyDetector()
        self.runtime = CNSDRuntime(model, self.cfg, device=device,
                                   quantize_linears=quantize_linears,
                                   graphs=graphs, mesh=mesh)
        self.last_timings: Dict[str, float] = {}
        self.last_latents: Optional[torch.Tensor] = None
        self.last_detected_maps: List[np.ndarray] = []

    def initialize(self, warmup_resolution: int = 256, warmup_steps: int = 1):
        """Build and run every engine once (hackathon.initialize + warm_up,
        canny2image_TRT.py:20-50), with the runtime's self-test."""
        self.runtime.warmup(warmup_resolution, warmup_steps)
        return self

    def _annotate(self, img: np.ndarray, low: int, high: int,
                  annotator=None) -> Tuple[np.ndarray, np.ndarray]:
        """The annotator's map as (HWC3 uint8 map, raw output); the first
        output of a detector that returns several."""
        from stablediffusioneo_tpu_torch.annotators.util import HWC3

        ann = annotator if annotator is not None else self.apply_canny
        try:
            out = ann(img, low, high)
        except TypeError:
            out = ann(img)
        if isinstance(out, tuple):
            out = out[0]
        out = np.asarray(out)
        return HWC3(out), out

    @staticmethod
    def _pack_hint(detected_map: np.ndarray, raw: np.ndarray):
        """Bit-pack a binary single-channel control map for upload (the JAX
        package's `_pack_hint`, the same code). Canny maps are {0, 255} gray:
        1 bit a pixel instead of 24 is lossless (786,432 -> 32,768 bytes at
        512x512), and the engine's packed variant unpacks to the exact {0, 1}
        values the uint8 variant's /255 gives. Returns the packed (H, W//8)
        array, or None when the map is not binary gray (other annotators' maps
        take the uint8 path)."""
        if raw.ndim != 2 or raw.dtype != np.uint8:
            return None
        if detected_map.shape[1] % 8:
            return None
        if not ((raw == 0) | (raw == 255)).all():
            return None
        return np.packbits(raw > 0, axis=-1)  # big-endian bit order

    def _hint(self, img: np.ndarray, low: int, high: int, num_samples: int):
        """(detected maps, the loop's hint for num_samples rows): one net, the
        map bit-packed where it is binary, else uint8 pixels; several nets, a
        tuple of float hints in [0, 1], one a net (JAX canny2image.py:
        183-210)."""
        if self.annotators is not None:
            maps = [self._annotate(img, low, high, a)[0] for a in self.annotators]
            return maps, tuple(np.repeat((m.astype(np.float32) / 255.0)[None],
                                         num_samples, axis=0) for m in maps)
        detected_map, raw = self._annotate(img, low, high)
        packed = self._pack_hint(detected_map, raw)
        hint = detected_map if packed is None else packed
        return [detected_map], np.repeat(hint[None], num_samples, axis=0)

    def process(
        self,
        input_image: np.ndarray,
        prompt: str,
        a_prompt: str = "best quality, extremely detailed",
        n_prompt: str = "longbody, lowres, bad anatomy, bad hands, missing fingers, extra digit, fewer digits, cropped, worst quality, low quality",
        num_samples: int = 1,
        image_resolution: int = 256,
        ddim_steps: int = 20,
        guess_mode: bool = False,
        strength: float = 1.0,
        scale: float = 9.0,
        seed: int = -1,
        eta: float = 0.0,
        low_threshold: int = 100,
        high_threshold: int = 200,
        x_T: Optional[np.ndarray] = None,
        sampler: str = "ddim",
        clip_skip: int = 0,
        long_prompt=False,
        prompt_emphasis: bool = False,
        init_image: Optional[np.ndarray] = None,
        inpaint_image: Optional[np.ndarray] = None,
        inpaint_mask: Optional[np.ndarray] = None,
        hires_upscale: float = 0.0,
        hires_denoise: float = 0.7,
        tome_ratio: float = 0.0,
        hires_noise: Optional[np.ndarray] = None,
        img2img_noise: Optional[np.ndarray] = None,
        inpaint_noise: Optional[np.ndarray] = None,
        step_noise: Optional[np.ndarray] = None,
        encoder_cache_interval: int = 1,
        granular_timings: bool = False,
        denoise_strength: float = 0.75,
        cfg_rescale: float = 0.0,
    ) -> List[np.ndarray]:
        """Returns [detected_map] + num_samples uint8 HWC images.

        hires_upscale > 1: the hires fix (JAX canny2image.py:345-393); the
        images and the returned map are at round(H * hires_upscale / 64) *
        64. granular_timings takes the plain request only: with it
        hires_upscale is not read, as in the JAX package.

        init_image + denoise_strength: img2img (DDIMSampler.encode/decode,
        ddim_hacked.py:233-317): the source, resized to the hint's size, is
        VAE-encoded (posterior mode), re-noised to step t_enc =
        round(denoise_strength * ddim_steps) (at least 1) and the last t_enc
        steps run. inpaint_image + inpaint_mask (uint8 HxW or HxWx1;
        nonzero = region to regenerate): the kept region is VAE-encoded
        (posterior mode) and re-imposed at every step's noise level
        (pipeline/ddim.py). img2img takes no x_T; neither takes hires or
        granular_timings.

        long_prompt: True runs the prompts through 3 x 77-token windows
        (hack_everything, hack.py:32-68), "auto" through the fewest windows
        that hold them; prompt_emphasis: "(word:1.3)" weights (not together
        with long_prompt). Both need a CLIPTokenizer (models/tokenizer.py).

        Parity hooks (the JAX package draws these from its own PRNG, which
        torch cannot reproduce): hires_noise, the hires refine's re-noise
        (NHWC latents at the high resolution); img2img_noise, the img2img
        re-noise (NHWC latents); inpaint_noise, the inpaint blend's noise of
        every step run, (steps, B, h, w, 4); step_noise, the loop's own noise
        of every step run (DDIM's with eta > 0, Euler-a's), (steps, B, h, w,
        4), not with the hires fix. Each is drawn from the seed's generator
        when None.

        sampler: "ddim", "plms" (eta 0 only), "dpmpp[-karras]",
        "unipc[-karras]", or "euler", "euler-a", "heun" (Karras spacing, or
        "-uniform"); eta is read by DDIM only, and Euler-a draws its step
        noise from the seed's generator. img2img, inpainting, the hires fix and
        encoder_cache_interval are DDIM-path features: other samplers with
        them raise ValueError before any work, as in the JAX package.
        tome_ratio > 0: token merging at the self-attention sites of at least
        cfg.controlnet.unet.tome_min_tokens tokens, in both nets."""
        with profiling.span("pipeline.request",
                            requests=(profiling.new_id(),)) as req_span:
            hires = bool(hires_upscale and hires_upscale > 1.0) and not granular_timings
            if hires and self.annotators is not None:
                raise ValueError("hires_upscale + multi-ControlNet is unsupported")
            if hires and step_noise is not None:
                raise ValueError("step_noise takes a request without the hires fix")
            if hires and (init_image is not None or inpaint_image is not None):
                raise ValueError("hires_upscale composes with plain txt2img only "
                                 "(no img2img/inpaint)")
            self.runtime.check_sampler(sampler, eta, encoder_cache_interval,
                                       inpaint=inpaint_image is not None,
                                       img2img=init_image is not None or hires)
            if inpaint_image is not None:
                if inpaint_mask is None:
                    raise ValueError("inpaint_image requires inpaint_mask")
                if granular_timings:
                    raise ValueError("inpainting is unsupported on the "
                                     "granular-timings diagnostic path")
            if init_image is not None:
                if granular_timings:
                    raise ValueError("img2img is unsupported on the "
                                     "granular-timings diagnostic path")
                if x_T is not None:
                    raise ValueError("init_image and x_T are mutually exclusive")
            if prompt_emphasis and long_prompt:
                raise ValueError("prompt_emphasis + long_prompt is unsupported "
                                 "(pick one encoder path)")
            from stablediffusioneo_tpu_torch.annotators.util import HWC3, resize_image

            rt = self.runtime
            with profiling.span("pipeline.preprocess"):
                img = resize_image(HWC3(input_image), image_resolution)
                H, W = img.shape[:2]
                self.last_detected_maps, hint = self._hint(img, low_threshold,
                                                           high_threshold, num_samples)
                detected_map = self.last_detected_maps[0]
                if seed == -1:
                    seed = int(np.random.randint(0, 2**31 - 1))
                gen = torch.Generator(device=rt.device).manual_seed(seed)

            texts = [prompt + ", " + a_prompt if a_prompt else prompt, n_prompt]
            if prompt_emphasis:
                from stablediffusioneo_tpu_torch.models.text_encoding import (
                    apply_emphasis,
                    tokenize_weighted,
                )

                ids, weights = tokenize_weighted(self.tokenizer, texts)
                ctx = apply_emphasis(rt.encode_prompt(ids, clip_skip=clip_skip), weights)
            elif long_prompt:
                ctx = rt.encode_prompt_windowed(
                    self.tokenizer, texts, clip_skip=clip_skip,
                    windows="auto" if long_prompt == "auto" else 3)
            else:
                ctx = rt.encode_prompt(self.tokenizer(texts), clip_skip=clip_skip)
            ctx_cond = ctx[0:1].repeat(num_samples, 1, 1)
            ctx_uncond = ctx[1:2].repeat(num_samples, 1, 1)

            f = self.cfg.vae.downsample_factor
            run = dict(guidance_scale=scale, strength=strength, eta=eta,
                       guess_mode=guess_mode, generator=gen,
                       encoder_cache_interval=encoder_cache_interval,
                       cfg_rescale=cfg_rescale, sampler=sampler, tome_ratio=tome_ratio,
                       noise=step_noise)
            if inpaint_image is not None:
                from stablediffusioneo_tpu_torch.pipeline.inpaint import prepare_inpaint

                src_f, m = prepare_inpaint(inpaint_image, inpaint_mask, H, W, f)
                run.update(
                    inpaint_latent=rt.encode_image(
                        np.repeat(src_f[None], num_samples, axis=0), deterministic=True),
                    inpaint_mask=torch.from_numpy(np.repeat(m[None], num_samples, axis=0)),
                    inpaint_noise=inpaint_noise)
            if init_image is not None:
                import cv2

                src = cv2.resize(HWC3(init_image), (W, H), interpolation=cv2.INTER_AREA)
                src_f = src.astype(np.float32) / 127.5 - 1.0
                run.update(
                    init_latent=rt.encode_image(
                        np.repeat(src_f[None], num_samples, axis=0), deterministic=True),
                    t_enc=max(1, min(ddim_steps, int(round(denoise_strength * ddim_steps)))),
                    renoise=img2img_noise)
            elif x_T is None:
                x_T = torch.randn((num_samples, H // f, W // f, 4), generator=gen,
                                  device=rt.device)
            if x_T is not None:
                x_T = torch.as_tensor(x_T, device=rt.device)
            if granular_timings:
                # diagnostic path: a device synchronisation between sample and
                # decode, so the phase split is honest
                with profiling.span("pipeline.sample"):
                    z = rt.sample(ddim_steps, x_T, hint, ctx_cond, ctx_uncond, **run)
                    _hard_sync(z)
                with profiling.span("pipeline.decode"):
                    images_dev = rt.decode_latent_device(z)
                    _hard_sync(images_dev)
            elif hires:
                import cv2

                z = rt.sample(ddim_steps, x_T, hint, ctx_cond, ctx_uncond, **run)
                H2 = int(round(H * hires_upscale / 64)) * 64
                W2 = int(round(W * hires_upscale / 64)) * 64
                z_up = resize_latent_bilinear(z, H2 // f, W2 // f)
                img_hi = cv2.resize(HWC3(input_image), (W2, H2),
                                    interpolation=cv2.INTER_LANCZOS4)
                (detected_map,), hint_hi = self._hint(img_hi, low_threshold,
                                                      high_threshold, num_samples)
                t_enc = max(1, min(ddim_steps, int(round(hires_denoise * ddim_steps))))
                images_dev = rt.sample_decode(
                    ddim_steps, None, hint_hi, ctx_cond, ctx_uncond,
                    init_latent=z_up, t_enc=t_enc,
                    renoise=None if hires_noise is None
                    else torch.as_tensor(hires_noise, device=rt.device), **run)
            else:
                # the whole latent -> pixels path is one engine and one fetch
                images_dev = rt.sample_decode(ddim_steps, x_T, hint, ctx_cond,
                                              ctx_uncond, **run)
            with profiling.span("pipeline.fetch"):
                images = images_dev.cpu().numpy()  # waits for the device
            if req_span:
                profiling.resolve(req_span)  # the fetch waited for the device
            self.last_timings = _timings(req_span, granular_timings)
            self.last_latents = rt.last_latents
            return [detected_map] + [images[i] for i in range(num_samples)]
