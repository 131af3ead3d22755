"""UniPC, order 2, bh2 variant (Zhao et al. 2023, arXiv:2302.04867),
counterpart of stablediffusioneo_tpu/pipeline/unipc.py.

A DPM-Solver++-style multistep predictor and a corrector that folds the
current step's model evaluation back into the update, on the
`dpmpp_schedule` grid (either spacing). In data-prediction form, B_h =
expm1(-h):

    h       = lambda_next - lambda_cur,   phi_1 = expm1(-h)
    x_base  = (sigma_next / sigma_cur) x - alpha_next phi_1 m_cur
    D1_prev = (m_prev - m_cur) / r1,   r1 = (lambda_prev - lambda_cur) / h
    predictor: x_p = x_base - alpha_next B_h (1/2) D1_prev
    corrector: m_t = model(x_p, t_next);  D1_t = m_t - m_cur
               x_t = x_base - alpha_next B_h (c1 D1_prev + c2 D1_t)

with (c1, c2) from b1 = (phi_1 / (-h) - 1) / B_h and b2 = 2 ((phi_1 / (-h)
- 1) / (-h) - 1/2) / B_h. The first step has no D1_prev (order-1
predictor, corrector 1/2 D1_t); the last step is predictor only. One
evaluation before the loop, then one corrector evaluation for each of the
first N - 1 steps, reused as the next step's m_cur: N evaluations.

As in pipeline/dpm_solver.py: a Python loop, coefficients in float32 numpy
on the host, branches on the host, fp32 updates, x carried in the nets'
dtype.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from stablediffusioneo_tpu_torch.models.controlnet import ControlNet
from stablediffusioneo_tpu_torch.models.unet import UNetModel
from stablediffusioneo_tpu_torch.pipeline.ddim import _hoist_context_kv, guided_model
from stablediffusioneo_tpu_torch.pipeline.dpm_solver import x0_prediction

F32 = np.float32


def _coefficients(schedule: Dict[str, np.ndarray], i: int):
    """(h, phi_1, B_h, b1, b2) of step i, float32 (the JAX base_and_coeffs)."""
    h = F32(F32(schedule["lambda_next"][i]) - F32(schedule["lambda_cur"][i]))
    hh = F32(-h)
    phi_1 = F32(np.expm1(hh))
    b_h = phi_1
    b1 = F32(F32(F32(phi_1 / hh) - F32(1.0)) / b_h)
    b2 = F32(F32(2.0) * F32(F32(F32(F32(phi_1 / hh) - F32(1.0)) / hh) - F32(0.5)) / b_h)
    return h, phi_1, b_h, b1, b2


def unipc_sample(
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
    dtype=None,
    parameterization: str = "eps",
    cfg_rescale: float = 0.0,
    tome=None,
) -> torch.Tensor:
    """The UniPC-2 (bh2) loop over a `dpmpp_schedule`; deterministic.
    Arguments as pipeline/ddim.py:ddim_sample; returns the x_0 latents, NHWC
    fp32 (with bf16 nets, the bf16 values the loop carries)."""
    dtype = dtype or ctx_cond.dtype
    model = guided_model(unet, control, _hoist_context_kv(
        unet, control, hint, ctx_cond, ctx_uncond, control_scales, guess_mode,
        dtype), guess_mode, scale, cfg_rescale, tome)
    n = len(schedule["t"])
    x = x_T.to(dtype)
    m_cur = x0_prediction(model, x, schedule["t"][0], schedule["alpha_cur"][0],
                          schedule["sigma_cur"][0], parameterization)
    m_prev, lam_prev = None, None
    for i in range(n):
        h, phi_1, b_h, b1, b2 = _coefficients(schedule, i)
        a_n = F32(schedule["alpha_next"][i])
        s_c, s_n = F32(schedule["sigma_cur"][i]), F32(schedule["sigma_next"][i])
        l_c = F32(schedule["lambda_cur"][i])
        a_b = float(F32(a_n * b_h))
        x_base = (float(F32(s_n / s_c)) * x.float()
                  - float(F32(a_n * phi_1)) * m_cur)
        if m_prev is not None:
            r1 = F32(F32(lam_prev - l_c) / h)
            d1_prev = (m_prev - m_cur) / float(r1 if abs(r1) > 1e-12 else F32(1.0))
            x_p = x_base - a_b * (0.5 * d1_prev)
        else:
            x_p = x_base
        if i == n - 1:  # the last step: predictor only
            x = x_p.to(dtype)
            break
        # corrector: evaluate at the predicted point, reused as the next m_cur
        m_t = x0_prediction(model, x_p.to(dtype), schedule["t"][i + 1], a_n, s_n,
                            parameterization)
        d1_t = m_t - m_cur
        if m_prev is not None:
            one_m_r1 = F32(F32(1.0) - r1)
            c1 = F32(F32(b1 - b2) / (one_m_r1 if abs(one_m_r1) > 1e-12 else F32(1.0)))
            corr = float(c1) * d1_prev + float(F32(b1 - c1)) * d1_t
        else:
            corr = 0.5 * d1_t
        x = (x_base - a_b * corr).to(dtype)
        m_prev, m_cur, lam_prev = m_cur, m_t, l_c
    return x.float()
