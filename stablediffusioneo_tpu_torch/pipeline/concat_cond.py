"""ControlNet-free SD sampling (counterpart of
stablediffusioneo_tpu/pipeline/concat_cond.py).

`sd_txt2img` is the JAX `sd_txt2img_scan`: the stock LatentDiffusion txt2img
DDIM loop of the SD-1.x / 2.x families, the ControlNet loop without its
control branch: CFG as one batch-2 UNet evaluation a step, the context K/V
hoisted out of the loop, the fp32 update and x carried in the nets' dtype
(pipeline/ddim.py:ddim_sample with control=None).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from stablediffusioneo_tpu_torch.models.unet import UNetModel
from stablediffusioneo_tpu_torch.pipeline.ddim import ddim_sample


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
