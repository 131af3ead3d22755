"""PLMS, pseudo linear multistep (PNDM; Liu et al. 2022, arXiv:2202.09778),
counterpart of stablediffusioneo_tpu/pipeline/plms.py.

A 4th-order Adams-Bashforth ladder over eps predictions, stepped through the
deterministic (eta = 0) DDIM transfer x' = sqrt(a_prev) x0 + sqrt(1 - a_prev) e':

    step 0 : e' = (e_t + e(x', t_next)) / 2      (two evaluations)
    step 1 : e' = (3 e_t - e_{-1}) / 2
    step 2 : e' = (23 e_t - 16 e_{-1} + 5 e_{-2}) / 12
    step 3+: e' = (55 e_t - 59 e_{-1} + 37 e_{-2} - 9 e_{-3}) / 24

N + 1 evaluations. The JAX scan computes all three rungs and selects one by
the step counter; here the rung is chosen on the host by the step index,
with the chosen rung's arithmetic in the same order. The update is fp32 and
x is carried in the nets' dtype. PLMS is eta-0 only.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from stablediffusioneo_tpu_torch.models.controlnet import ControlNet
from stablediffusioneo_tpu_torch.models.unet import UNetModel
from stablediffusioneo_tpu_torch.pipeline.ddim import _hoist_context_kv, guided_model

F32 = np.float32


def plms_sample(
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
    """The PLMS loop over a DiffusionSchedule.ddim(steps, eta=0) schedule;
    deterministic. Arguments as pipeline/ddim.py:ddim_sample; returns the x_0
    latents, NHWC fp32 (with bf16 nets, the bf16 values the loop carries)."""
    dtype = dtype or ctx_cond.dtype
    model = guided_model(unet, control, _hoist_context_kv(
        unet, control, hint, ctx_cond, ctx_uncond, control_scales, guess_mode,
        dtype), guess_mode, scale, cfg_rescale, tome)

    def eps_at(x, t, a_t, sqrt_1m_at):
        """The guided eps prediction (a v-prediction converted), fp32."""
        m = model(x, float(t)).float()
        if parameterization == "v":
            return float(np.sqrt(a_t)) * m + float(sqrt_1m_at) * x.float()
        return m

    def transfer(x, e, a_t, a_prev, sqrt_1m_at):
        """The deterministic DDIM update (eta = 0), fp32."""
        pred_x0 = (x.float() - float(sqrt_1m_at) * e) / float(np.sqrt(a_t))
        dir_xt = float(np.sqrt(np.maximum(F32(1.0) - a_prev, F32(0.0)))) * e
        return float(np.sqrt(a_prev)) * pred_x0 + dir_xt

    ts = schedule["timesteps"].astype(np.float32)
    al, ap, s1m = (schedule[k].astype(np.float32) for k in
                   ("alphas", "alphas_prev", "sqrt_one_minus_alphas"))
    n = len(ts)
    x_T = x_T.to(dtype)
    # step 0: the mean of the predictions at x_T and at its Euler probe
    e0 = eps_at(x_T, ts[0], al[0], s1m[0])
    x_probe = transfer(x_T, e0, al[0], ap[0], s1m[0]).to(dtype)
    if n > 1:
        t1, a1, s1m1 = ts[1], al[1], s1m[1]
    else:
        t1, a1 = F32(0.0), ap[0]
        s1m1 = np.sqrt(np.maximum(F32(1.0) - ap[0], F32(0.0)))
    e_prime = 0.5 * (e0 + eps_at(x_probe, t1, a1, s1m1))
    x = transfer(x_T, e_prime, al[0], ap[0], s1m[0]).to(dtype)
    history = [e0]  # newest first
    for i in range(1, n):
        e_t = eps_at(x, ts[i], al[i], s1m[i])
        if i == 1:
            e_p = (3.0 * e_t - history[0]) / 2.0
        elif i == 2:
            e_p = (23.0 * e_t - 16.0 * history[0] + 5.0 * history[1]) / 12.0
        else:
            e_p = (55.0 * e_t - 59.0 * history[0] + 37.0 * history[1]
                   - 9.0 * history[2]) / 24.0
        x = transfer(x, e_p, al[i], ap[i], s1m[i]).to(dtype)
        history = [e_t] + history[:2]
    return x.float()
