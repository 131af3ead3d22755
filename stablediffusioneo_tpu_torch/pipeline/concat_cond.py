"""ControlNet-free SD sampling (counterpart of
stablediffusioneo_tpu/pipeline/concat_cond.py).

`sd_txt2img` is the JAX `sd_txt2img_scan`: the stock LatentDiffusion txt2img
DDIM loop of the SD-1.x / 2.x families, the ControlNet loop without its
control branch: CFG as one batch-2 UNet evaluation a step, the context K/V
hoisted out of the loop, the fp32 update and x carried in the nets' dtype
(pipeline/ddim.py:ddim_sample with control=None).

`sd_concat_sample` / `sd_concat_img2img` are the JAX concat-conditioned loops
(LDM "hybrid" conditioning) of the dedicated inpainting checkpoints
(sd-v1-5-inpainting, SD-2.0's 512-inpainting-ema; config.sd15_inpaint_pipeline
/ sd2_inpaint_pipeline): in_channels = 9, the 4 latent channels + 1 mask
channel (1 = region to repaint, at latent resolution) + the 4-channel VAE
latent of the masked image, made by `inpaint_to_concat`. The extra channels
are step-invariant: ddim_sample concatenates them once, tiled for the CFG
batch (both branches take the same ones, as the JAX scan), and joins them to
x at every evaluation. The UNet itself is unchanged (its conv_in reads
cfg.in_channels).

The depth2img family (SD-2.0's 512-depth-ema; config.sd2_depth_pipeline)
takes one channel: the MiDaS DPT-hybrid depth of the init image
(annotators/midas_hybrid.py, the model's `depth_model`), made by
`depth_to_concat`.

Distinct from pipeline/ddim.py's blended-latent inpainting, which works with
any 4-channel checkpoint by re-imposing the kept region each step.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from stablediffusioneo_tpu_torch.models.unet import UNetModel
from stablediffusioneo_tpu_torch.models.vae import AutoencoderKL, vae_encode
from stablediffusioneo_tpu_torch.ops.layers import nchw, nhwc
from stablediffusioneo_tpu_torch.pipeline.ddim import ddim_sample, stochastic_tail_entry


def sd_txt2img(
    unet: UNetModel,
    schedule: Dict[str, np.ndarray],
    x_T: torch.Tensor,
    ctx_cond: torch.Tensor,
    ctx_uncond: torch.Tensor,
    scale,
    temperature: float = 1.0,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Sequence[torch.Tensor]] = None,
    dtype: Optional[torch.dtype] = None,
    parameterization: str = "eps",
    cfg_rescale: float = 0.0,
) -> torch.Tensor:
    """x_0 latents (B, h, w, 4) fp32 from NHWC x_T and the (B, T, C)
    contexts; schedule, scale, noise and the rest as in ddim_sample."""
    return ddim_sample(unet, None, schedule, x_T, None, ctx_cond, ctx_uncond, scale,
                       None, temperature=temperature, generator=generator, noise=noise,
                       dtype=dtype, parameterization=parameterization,
                       cfg_rescale=cfg_rescale)


def sd_concat_sample(
    unet: UNetModel,
    schedule: Dict[str, np.ndarray],
    x_T: torch.Tensor,
    c_concat: torch.Tensor,
    ctx_cond: torch.Tensor,
    ctx_uncond: torch.Tensor,
    scale,
    temperature: float = 1.0,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Sequence[torch.Tensor]] = None,
    dtype: Optional[torch.dtype] = None,
    parameterization: str = "eps",
    cfg_rescale: float = 0.0,
) -> torch.Tensor:
    """The JAX sd_concat_sample_scan: the DDIM loop of a concat-conditioned
    (ControlNet-free) UNet. c_concat: (B, h, w, k) NHWC latent-resolution
    conditioning channels, k = in_channels - 4 (5 for inpainting; another
    count raises). Returns x_0 latents (B, h, w, 4) fp32; the rest as
    sd_txt2img."""
    return ddim_sample(unet, None, schedule, x_T, None, ctx_cond, ctx_uncond, scale,
                       None, temperature=temperature, generator=generator, noise=noise,
                       dtype=dtype, parameterization=parameterization,
                       cfg_rescale=cfg_rescale, c_concat=c_concat)


def sd_concat_img2img(
    unet: UNetModel,
    schedule: Dict[str, np.ndarray],
    z0: torch.Tensor,
    t_enc: int,
    c_concat: torch.Tensor,
    ctx_cond: torch.Tensor,
    ctx_uncond: torch.Tensor,
    scale,
    renoise: Optional[torch.Tensor] = None,
    temperature: float = 1.0,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Sequence[torch.Tensor]] = None,
    dtype: Optional[torch.dtype] = None,
    parameterization: str = "eps",
    cfg_rescale: float = 0.0,
) -> torch.Tensor:
    """The JAX sd_concat_img2img: the init image's latent z0 forward-diffused
    to the entry step of the last t_enc entries of the schedule
    (pipeline/ddim.py:stochastic_tail_entry, its noise `renoise`, else a draw
    from `generator`), then only that tail runs, with the conditioning
    channels joined at every evaluation; denoise strength = t_enc /
    num_steps. The SDXL refine takes the same entry
    (models/sdxl.py:sdxl_refine_latents)."""
    tail, x_T = stochastic_tail_entry(schedule, t_enc, z0, renoise, generator)
    return sd_concat_sample(unet, tail, x_T, c_concat, ctx_cond, ctx_uncond, scale,
                            temperature=temperature, generator=generator, noise=noise,
                            dtype=dtype, parameterization=parameterization,
                            cfg_rescale=cfg_rescale)


def inpaint_to_concat(
    vae: AutoencoderKL,
    image: torch.Tensor,
    mask: torch.Tensor,
    eps: Optional[torch.Tensor] = None,
    encode: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """(image, mask) -> the 5 inpainting conditioning channels.

    image: (B, H, W, 3) in [-1, 1]; mask: (B, H, W) or (B, H, W, 1) in
    [0, 1], 1 = region to REPAINT. The masked image (kept pixels only) is
    VAE-encoded (posterior mode without `eps`, else the sample mean + std *
    eps) and scaled to LatentDiffusion units in fp32; `encode` (masked image
    in image's dtype -> scaled latents), where given, takes the place of that
    encode, e.g. a captured encoder engine (runtime/engine.py:encoder_engine).
    The mask is downsampled to latent resolution by nearest neighbour at the
    pixel centres, as jax.image.resize(..., "nearest") takes them (source
    index 8i + 4: F.interpolate's "nearest-exact", not "nearest", which takes
    8i). Returns (B, h, w, 5) fp32: [mask, masked latent], the runway
    sd-inpainting concat order."""
    m = mask.float()
    if m.dim() == 3:
        m = m[..., None]
    masked = image.float() * (1.0 - m)
    if encode is not None:
        z = encode(masked.to(image.dtype)).float()
    else:
        dist = vae_encode(vae, masked.to(image.dtype))
        z = (dist.mode() if eps is None else dist.sample(eps)).float()
        z = z * float(np.float32(vae.cfg.scale_factor))
    m_lat = nhwc(F.interpolate(nchw(m), size=tuple(z.shape[1:3]), mode="nearest-exact"))
    return torch.cat([m_lat, z], dim=-1)


def depth_to_concat(depth: torch.Tensor, latent_hw) -> torch.Tensor:
    """MiDaS depth -> the depth2img conditioning channel (the JAX
    depth_to_concat).

    depth: (B, H, W) or (B, H, W, 1) raw (unnormalised) MiDaS output.
    Bicubic-resized to latent resolution in fp32, antialiased as
    jax.image.resize is when it shrinks (F.interpolate's antialias=True; the
    same values when it grows), then normalised per sample to [-1, 1] by its
    min and max (the LatentDepth2ImageDiffusion convention: depth is
    relative). Returns (B, h, w, 1) fp32."""
    d = depth.float()
    if d.dim() == 4:
        d = d[..., 0]
    h, w = latent_hw
    d = F.interpolate(d[:, None], size=(h, w), mode="bicubic", align_corners=False,
                      antialias=True)
    lo = d.amin(dim=(1, 2, 3), keepdim=True)
    hi = d.amax(dim=(1, 2, 3), keepdim=True)
    return nhwc(2.0 * (d - lo) / torch.clamp(hi - lo, min=1e-6) - 1.0)


DEPTH_SIZE = 384  # the MiDaS DPT-hybrid's input side in depth2img


def image_to_depth_concat(tower: torch.nn.Module, image: torch.Tensor, latent_hw,
                          size: int = DEPTH_SIZE) -> torch.Tensor:
    """The depth2img conditioning channel of an init image: image (B, H, W,
    3) in [-1, 1] (the tower's input as LatentDepth2ImageDiffusion hands it
    over: AddMiDaS maps the image to [0, 1] and normalises it by mean and
    std 0.5, which is the image itself) bicubically resized to size x size
    (384), through the MiDaS tower (models/cldm.py:Depth2ImgModel.depth) in
    its dtype, then `depth_to_concat`. The JAX package has the last step
    only; the tower's input follows the reference."""
    dtype = next(tower.parameters()).dtype
    x = F.interpolate(nchw(image.float()), size=(size, size), mode="bicubic",
                      align_corners=False)
    return depth_to_concat(tower(x.to(dtype)), latent_hw)
