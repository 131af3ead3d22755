"""canny2image application pipeline (counterpart of
stablediffusioneo_tpu/pipeline/canny2image.py).

`process(...)` keeps the reference's 14 arguments
  (input_image, prompt, a_prompt, n_prompt, num_samples, image_resolution,
   ddim_steps, guess_mode, strength, scale, seed, eta,
   low_threshold, high_threshold)
plus `x_T=` (and `hires_noise=`, `img2img_noise=`, `inpaint_noise=`) for
seeded cross-framework comparison. Path: resize to /64 -> Canny -> HWC3 hint
(uploaded as uint8) -> one CLIP call for cond and uncond -> DDIM with CFG ->
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
(pipeline/ddim.py); granular_timings=True runs sample and decode as two
engines with a device synchronisation between, for an honest phase split.
The JAX package's other features are accepted by name and raise
NotImplementedError naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from stablediffusioneo_tpu_torch.config import PipelineConfig, sd15_pipeline
from stablediffusioneo_tpu_torch.models.cldm import ControlLDM
from stablediffusioneo_tpu_torch.ops.layers import resize_latent_bilinear
from stablediffusioneo_tpu_torch.runtime.engine import CNSDRuntime


def _not_ported(feature: str, item: str):
    return NotImplementedError(
        f"{feature} is not in the PyTorch port yet (ROADMAP queue 1: {item})")


class Canny2ImagePipeline:
    """tokenizer: any callable mapping a list of strings to an (N, T) int
    array. annotator: a callable (image, low, high) -> hint map; default
    Canny (cv2)."""

    def __init__(self, model: ControlLDM, tokenizer: Callable,
                 cfg: Optional[PipelineConfig] = None, device="cuda",
                 annotator=None, quantize_linears: bool = False,
                 graphs: Optional[bool] = None):
        if isinstance(annotator, (list, tuple)):
            raise _not_ported("multi-ControlNet", "Adapters and knobs")
        self.cfg = cfg or sd15_pipeline()
        self.tokenizer = tokenizer
        self.annotator = annotator
        self.runtime = CNSDRuntime(model, self.cfg, device=device,
                                   quantize_linears=quantize_linears,
                                   graphs=graphs)
        self.last_timings: Dict[str, float] = {}
        self.last_latents: Optional[torch.Tensor] = None
        self.last_detected_maps: List[np.ndarray] = []

    def initialize(self, warmup_resolution: int = 256, warmup_steps: int = 1):
        """Build and run every engine once (hackathon.initialize + warm_up,
        canny2image_TRT.py:20-50), with the runtime's self-test."""
        self.runtime.warmup(warmup_resolution, warmup_steps)
        return self

    def _sync(self) -> None:
        if self.runtime.device.type == "cuda":
            torch.cuda.synchronize(self.runtime.device)

    def _annotate(self, img: np.ndarray, low: int, high: int) -> np.ndarray:
        from stablediffusioneo_tpu_torch.annotators.canny import CannyDetector
        from stablediffusioneo_tpu_torch.annotators.util import HWC3

        ann = self.annotator or CannyDetector()
        try:
            out = ann(img, low, high)
        except TypeError:
            out = ann(img)
        if isinstance(out, tuple):
            out = out[0]
        return HWC3(np.asarray(out))

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
        every step run, (steps, B, h, w, 4). Each is drawn from the seed's
        generator when None."""
        hires = bool(hires_upscale and hires_upscale > 1.0) and not granular_timings
        if hires and (init_image is not None or inpaint_image is not None):
            raise ValueError("hires_upscale composes with plain txt2img only "
                             "(no img2img/inpaint)")
        for on, feature, item in (
                (sampler != "ddim", f"sampler {sampler!r}", "The other samplers"),
                (bool(tome_ratio), "ToMe", "Adapters and knobs")):
            if on:
                raise _not_ported(feature, item)
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

        t_start = time.perf_counter()
        img = resize_image(HWC3(input_image), image_resolution)
        H, W = img.shape[:2]
        detected_map = self._annotate(img, low_threshold, high_threshold)
        self.last_detected_maps = [detected_map]
        rt = self.runtime
        hint = torch.from_numpy(np.repeat(detected_map[None], num_samples,
                                          axis=0)).to(rt.device)
        if seed == -1:
            seed = int(np.random.randint(0, 2**31 - 1))
        gen = torch.Generator(device=rt.device).manual_seed(seed)
        t_pre = time.perf_counter()

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
        t_clip = time.perf_counter()

        f = self.cfg.vae.downsample_factor
        run = dict(guidance_scale=scale, strength=strength, eta=eta,
                   guess_mode=guess_mode, generator=gen,
                   encoder_cache_interval=encoder_cache_interval,
                   cfg_rescale=cfg_rescale)
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
        timings = {"preprocess_ms": (t_pre - t_start) * 1e3,
                   "clip_ms": (t_clip - t_pre) * 1e3}
        if granular_timings:
            # diagnostic path: a device synchronisation between sample and
            # decode, so the phase split is honest
            z = rt.sample(ddim_steps, x_T, hint, ctx_cond, ctx_uncond, **run)
            self._sync()
            t_sample = time.perf_counter()
            images_dev = rt.decode_latent_device(z)
            self._sync()
            t_decode = time.perf_counter()
            images = images_dev.cpu().numpy()
            t_end = time.perf_counter()
            timings.update(sample_ms=(t_sample - t_clip) * 1e3,
                           decode_ms=(t_decode - t_sample) * 1e3,
                           fetch_ms=(t_end - t_decode) * 1e3)
        else:
            if hires:
                import cv2

                z = rt.sample(ddim_steps, x_T, hint, ctx_cond, ctx_uncond, **run)
                H2 = int(round(H * hires_upscale / 64)) * 64
                W2 = int(round(W * hires_upscale / 64)) * 64
                z_up = resize_latent_bilinear(z, H2 // f, W2 // f)
                img_hi = cv2.resize(HWC3(input_image), (W2, H2),
                                    interpolation=cv2.INTER_LANCZOS4)
                detected_map = self._annotate(img_hi, low_threshold, high_threshold)
                hint_hi = torch.from_numpy(np.repeat(
                    detected_map[None], num_samples, axis=0)).to(rt.device)
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
            images = images_dev.cpu().numpy()  # waits for the device
            t_end = time.perf_counter()
            timings["sample_decode_fetch_ms"] = (t_end - t_clip) * 1e3
        timings["total_ms"] = (t_end - t_start) * 1e3
        self.last_timings = timings
        self.last_latents = rt.last_latents
        return [detected_map] + [images[i] for i in range(num_samples)]
