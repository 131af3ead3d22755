"""DDIM sampler (counterpart of stablediffusioneo_tpu/pipeline/ddim.py).

The JAX package's `lax.scan` becomes a Python loop. As there:
  * classifier-free guidance runs cond and uncond as one batch-2 concat
    through ControlNet + UNet per step (guess mode: cond with control,
    uncond without, as two evaluations);
  * the hint-block embedding and every cross-attention K/V projection of
    the step-invariant contexts are computed once, before the loop;
  * x is carried in fp32 and the DDIM update runs in fp32, whatever dtype
    the nets run in.

Update (p_sample_ddim, ddim_hacked.py:208-231):
    e_t     = e_uncond + scale * (e_cond - e_uncond)
    pred_x0 = (x - sqrt(1 - a_t) * e_t) / sqrt(a_t)
    dir_xt  = sqrt(1 - a_prev - sigma_t^2) * e_t
    x_prev  = sqrt(a_prev) * pred_x0 + dir_xt + sigma_t * noise * temperature
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from stablediffusioneo_tpu_torch.models.controlnet import (
    ControlNet,
    controlled_unet_forward,
    hint_block_apply,
    precompute_controlnet_context_kv,
)
from stablediffusioneo_tpu_torch.models.unet import (
    UNetModel,
    precompute_context_kv,
)
from stablediffusioneo_tpu_torch.ops.layers import nchw, nhwc


def _tile_cfg(control_scales):
    """Per-sample (B, 13) scales tiled to the batch-2B concat; shared
    scales broadcast as they are."""
    if isinstance(control_scales, torch.Tensor) and control_scales.dim() == 2:
        return torch.cat([control_scales, control_scales], dim=0)
    return control_scales


def _bc_scale(scale, like: torch.Tensor):
    """Guidance scale, a number or a (B,) tensor, broadcast against NCHW."""
    s = torch.as_tensor(scale, dtype=like.dtype, device=like.device)
    return s.reshape(-1, 1, 1, 1) if s.dim() == 1 else s


def ddim_sample(
    unet: UNetModel,
    control: ControlNet,
    schedule: Dict[str, np.ndarray],
    x_T: torch.Tensor,
    hint: torch.Tensor,
    ctx_cond: torch.Tensor,
    ctx_uncond: torch.Tensor,
    scale,
    control_scales,
    guess_mode: bool = False,
    temperature: float = 1.0,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Sequence[torch.Tensor]] = None,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Full DDIM loop; returns the fp32 x_0 latents, NHWC (B, h, w, 4).

    schedule: DiffusionSchedule.ddim(...) (sampling order). x_T: NHWC
    latents; hint: NHWC (B, H, W, 3) in [0, 1]; ctx_*: (B, T, C) contexts in
    the nets' dtype. scale: a number or (B,) tensor; control_scales: 13
    numbers or a (B, 13) tensor. With eta > 0 the step noise comes from
    `noise[i]` (NHWC, one per step) when given, else from `generator`.
    """
    dtype = dtype or ctx_cond.dtype
    b = x_T.shape[0]
    guided_hint = hint_block_apply(control.input_hint_block,
                                   nchw(hint).to(dtype))
    if guess_mode:
        kv_cond = (precompute_context_kv(unet, ctx_cond),
                   precompute_controlnet_context_kv(control, ctx_cond))
        kv_uncond = precompute_context_kv(unet, ctx_uncond)
    else:
        ctx2 = torch.cat([ctx_cond, ctx_uncond], dim=0)
        kv2 = (precompute_context_kv(unet, ctx2),
               precompute_controlnet_context_kv(control, ctx2))
        gh2 = torch.cat([guided_hint, guided_hint], dim=0)
        cscales2 = _tile_cfg(control_scales)

    x = x_T.float()
    for i in range(len(schedule["timesteps"])):
        t = float(schedule["timesteps"][i])
        a_t = np.float32(schedule["alphas"][i])
        a_prev = np.float32(schedule["alphas_prev"][i])
        sigma = np.float32(schedule["sigmas"][i])
        sqrt_1m_at = np.float32(schedule["sqrt_one_minus_alphas"][i])
        xn = nchw(x).to(dtype)
        if guess_mode:
            tb = torch.full((b,), t, dtype=torch.float32, device=x.device)
            e_cond = controlled_unet_forward(
                unet, control, xn, None, tb, ctx_cond,
                control_scales=control_scales, guided_hint=guided_hint,
                unet_ctx_kv=kv_cond[0], ctrl_ctx_kv=kv_cond[1])
            e_uncond = controlled_unet_forward(
                unet, control, xn, None, tb, ctx_uncond, unet_ctx_kv=kv_uncond)
        else:
            tb = torch.full((2 * b,), t, dtype=torch.float32, device=x.device)
            eps2 = controlled_unet_forward(
                unet, control, torch.cat([xn, xn], dim=0), None, tb, ctx2,
                control_scales=cscales2, guided_hint=gh2,
                unet_ctx_kv=kv2[0], ctrl_ctx_kv=kv2[1])
            e_cond, e_uncond = eps2[:b], eps2[b:]
        e_t = e_uncond + _bc_scale(scale, e_uncond) * (e_cond - e_uncond)
        # fp32 state update (sqrt of the fp32 constants, as the JAX package)
        ef = nhwc(e_t).float()
        pred_x0 = (x - float(sqrt_1m_at) * ef) / float(np.sqrt(a_t))
        dir_coef = np.sqrt(np.maximum(np.float32(1.0) - a_prev - sigma * sigma,
                                      np.float32(0.0)))
        x = float(np.sqrt(a_prev)) * pred_x0 + float(dir_coef) * ef
        if sigma > 0:
            n = (noise[i].to(x.device, torch.float32) if noise is not None else
                 torch.randn(x.shape, generator=generator, device=x.device))
            x = x + float(sigma) * n * temperature
    return x
