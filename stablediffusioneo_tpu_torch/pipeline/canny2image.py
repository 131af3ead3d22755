"""canny2image application pipeline (counterpart of
stablediffusioneo_tpu/pipeline/canny2image.py).

`process(...)` keeps the reference's 14 arguments
  (input_image, prompt, a_prompt, n_prompt, num_samples, image_resolution,
   ddim_steps, guess_mode, strength, scale, seed, eta,
   low_threshold, high_threshold)
plus `x_T=` for seeded cross-framework comparison. Path: resize to /64 ->
Canny -> HWC3 hint (uploaded as uint8) -> one CLIP call for cond and uncond
-> DDIM with CFG -> VAE decode -> uint8. The JAX package's other features
are accepted by name and raise NotImplementedError naming the ROADMAP item
that brings them.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from stablediffusioneo_tpu.config import PipelineConfig, sd15_pipeline
from stablediffusioneo_tpu_torch.models.cldm import ControlLDM
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
                 annotator=None, quantize_linears: bool = False):
        if quantize_linears:
            raise _not_ported("int8 weight-only linears", "Adapters and knobs")
        if isinstance(annotator, (list, tuple)):
            raise _not_ported("multi-ControlNet", "Adapters and knobs")
        self.cfg = cfg or sd15_pipeline()
        self.tokenizer = tokenizer
        self.annotator = annotator
        self.runtime = CNSDRuntime(model, self.cfg, device=device)
        self.last_timings: Dict[str, float] = {}
        self.last_latents: Optional[torch.Tensor] = None

    def _annotate(self, img: np.ndarray, low: int, high: int) -> np.ndarray:
        from stablediffusioneo_tpu.annotators.canny import CannyDetector
        from stablediffusioneo_tpu.annotators.util import HWC3

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
        tome_ratio: float = 0.0,
    ) -> List[np.ndarray]:
        """Returns [detected_map] + num_samples uint8 HWC images."""
        for on, feature, item in (
                (sampler != "ddim", f"sampler {sampler!r}", "The other samplers"),
                (init_image is not None, "img2img", "The other samplers"),
                (hires_upscale and hires_upscale > 1.0, "hires fix", "The other samplers"),
                (inpaint_image is not None or inpaint_mask is not None,
                 "inpainting", "The other model families"),
                (bool(long_prompt), "long prompts (3x77 windows)",
                 "models/text_encoding.py"),
                (prompt_emphasis, "prompt emphasis", "models/text_encoding.py"),
                (bool(tome_ratio), "ToMe", "Adapters and knobs")):
            if on:
                raise _not_ported(feature, item)
        from stablediffusioneo_tpu.annotators.util import HWC3, resize_image

        t_start = time.perf_counter()
        img = resize_image(HWC3(input_image), image_resolution)
        H, W = img.shape[:2]
        detected_map = self._annotate(img, low_threshold, high_threshold)
        rt = self.runtime
        hint = torch.from_numpy(np.repeat(detected_map[None], num_samples,
                                          axis=0)).to(rt.device)
        if seed == -1:
            seed = int(np.random.randint(0, 2**31 - 1))
        gen = torch.Generator(device=rt.device).manual_seed(seed)
        t_pre = time.perf_counter()

        cond_text = prompt + ", " + a_prompt if a_prompt else prompt
        ctx = rt.encode_prompt(self.tokenizer([cond_text, n_prompt]),
                               clip_skip=clip_skip)
        ctx_cond = ctx[0:1].repeat(num_samples, 1, 1)
        ctx_uncond = ctx[1:2].repeat(num_samples, 1, 1)
        t_clip = time.perf_counter()

        f = self.cfg.vae.downsample_factor
        if x_T is None:
            x_T = torch.randn((num_samples, H // f, W // f, 4), generator=gen,
                              device=rt.device)
        z = rt.sample(ddim_steps, torch.as_tensor(x_T, device=rt.device), hint,
                      ctx_cond, ctx_uncond, guidance_scale=scale,
                      strength=strength, eta=eta, guess_mode=guess_mode,
                      generator=gen)
        self.last_latents = z
        images = rt.decode(z).cpu().numpy()  # waits for the device
        t_end = time.perf_counter()
        self.last_timings = {
            "preprocess_ms": (t_pre - t_start) * 1e3,
            "clip_ms": (t_clip - t_pre) * 1e3,
            "sample_decode_fetch_ms": (t_end - t_clip) * 1e3,
            "total_ms": (t_end - t_start) * 1e3,
        }
        return [detected_map] + [images[i] for i in range(num_samples)]
