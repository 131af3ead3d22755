"""Device runtime for canny2image (counterpart of
stablediffusioneo_tpu/runtime/engine.py CNSDRuntime).

Holds the four networks on one device in the compute dtype (cast once at
construction) and runs: the CLIP encode, the DDIM loop, the VAE decode and
the uint8 denormalisation. PyTorch runs eagerly, so there is no AOT step and
no compile cache; CUDA graphs come later (ROADMAP queue 1: CUDA graphs).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from stablediffusioneo_tpu.config import PipelineConfig
from stablediffusioneo_tpu_torch.models.cldm import ControlLDM
from stablediffusioneo_tpu_torch.models.clip import clip_text_apply
from stablediffusioneo_tpu_torch.models.controlnet import guess_mode_scales
from stablediffusioneo_tpu_torch.models.unet import encoder_plan
from stablediffusioneo_tpu_torch.models.vae import vae_decode
from stablediffusioneo_tpu_torch.ops.schedule import DiffusionSchedule
from stablediffusioneo_tpu_torch.pipeline.ddim import ddim_sample

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class CNSDRuntime:
    """model: a ControlLDM holding the weights (any device, any dtype);
    it is moved to `device` and cast to cfg.dtype in place."""

    def __init__(self, model: ControlLDM, cfg: PipelineConfig,
                 device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = DTYPES[cfg.dtype]
        self.model = model.to(device=self.device, dtype=self.dtype).eval()
        self.model.requires_grad_(False)
        d = cfg.diffusion
        self.schedule = DiffusionSchedule(d.timesteps, d.linear_start,
                                          d.linear_end, d.schedule)
        self.n_taps = len(encoder_plan(cfg.unet)) + 1

    def _require_model(self) -> ControlLDM:
        if self.model is None:
            raise RuntimeError("runtime was released")
        return self.model

    @torch.no_grad()
    def encode_prompt(self, ids, clip_skip: int = 0) -> torch.Tensor:
        """(N, T) token ids -> (N, T, hidden) contexts in the compute dtype."""
        ids = torch.as_tensor(np.asarray(ids), dtype=torch.long,
                              device=self.device)
        return clip_text_apply(self._require_model().clip, ids,
                               clip_skip=clip_skip).to(self.dtype)

    def control_scales(self, batch: int, strength, guess_mode: bool):
        """(B, 13) control strengths: strength per tap, or the guess-mode
        decay; strength is a number or one per sample."""
        st = np.asarray(strength, np.float32).reshape(-1)
        if st.size == 1:
            st = np.full((batch,), st[0], np.float32)
        if guess_mode:
            cs = np.stack([guess_mode_scales(float(s), self.n_taps) for s in st])
        else:
            cs = np.repeat(st[:, None], self.n_taps, axis=1)
        return torch.as_tensor(cs.astype(np.float32), device=self.device)

    @torch.no_grad()
    def sample(self, num_steps: int, x_T: torch.Tensor, hint: torch.Tensor,
               ctx_cond: torch.Tensor, ctx_uncond: torch.Tensor,
               guidance_scale: float = 9.0, strength=1.0, eta: float = 0.0,
               guess_mode: bool = False,
               generator: Optional[torch.Generator] = None,
               noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """DDIM latents (fp32 NHWC). x_T: NHWC latents; hint: uint8 NHWC
        pixels (normalised here: /255 in fp32, then the compute dtype) or
        floats in [0, 1]."""
        model = self._require_model()
        hint = torch.as_tensor(hint, device=self.device)
        if hint.dtype == torch.uint8:
            hint = hint.float() / 255.0
        b = x_T.shape[0]
        gs = torch.as_tensor(np.broadcast_to(
            np.asarray(guidance_scale, np.float32).reshape(-1), (b,)).copy(),
            device=self.device)
        return ddim_sample(
            model.unet, model.control_model,
            self.schedule.ddim(num_steps, eta=eta),
            torch.as_tensor(x_T, device=self.device), hint.to(self.dtype),
            ctx_cond.to(self.device, self.dtype),
            ctx_uncond.to(self.device, self.dtype), gs,
            self.control_scales(b, strength, guess_mode),
            guess_mode=guess_mode, generator=generator, noise=noise,
            dtype=self.dtype)

    @torch.no_grad()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latents -> uint8 NHWC pixels on the device."""
        img = vae_decode(self._require_model().first_stage_model,
                         z.to(self.device, self.dtype), scaled=True)
        return torch.clamp(img.float() * 127.5 + 127.5, 0, 255).to(torch.uint8)

    def sample_decode(self, num_steps: int, x_T, hint, ctx_cond, ctx_uncond,
                      **kwargs) -> torch.Tensor:
        """DDIM + VAE decode + uint8 denormalisation; uint8 (B, H, W, 3)."""
        return self.decode(self.sample(num_steps, x_T, hint, ctx_cond,
                                       ctx_uncond, **kwargs))

    def warmup(self, resolution: int = 256, num_steps: int = 1,
               batch: int = 1):
        """Run every stage once at a small shape; returns the image shape."""
        if resolution % 64:
            raise ValueError("resolutions are multiples of 64 (resize_image)")
        f = self.cfg.vae.downsample_factor
        ids = np.zeros((batch, self.cfg.clip.max_length), np.int64)
        ctx = self.encode_prompt(ids)
        x_T = torch.zeros((batch, resolution // f, resolution // f, 4),
                          device=self.device)
        hint = torch.zeros((batch, resolution, resolution, 3),
                           dtype=torch.uint8, device=self.device)
        img = self.sample_decode(num_steps, x_T, hint, ctx, ctx)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return tuple(img.shape)

    def release(self) -> None:
        """Drop the weights and return the device memory they held."""
        self.model = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
