"""DPM-Solver++(2M) (Lu et al. 2022), counterpart of
stablediffusioneo_tpu/pipeline/dpm_solver.py.

VP notation: alpha_t = sqrt(abar_t), sigma_t = sqrt(1 - abar_t),
lambda_t = log(alpha_t / sigma_t). Second-order multistep update on data
predictions x0:

    h   = lambda_{i+1} - lambda_i,   r = h_prev / h
    D   = (1 + 1/(2r)) x0_i - (1/(2r)) x0_{i-1}      (first step: D = x0_i)
    x_{i+1} = (sigma_{i+1} / sigma_i) x_i - alpha_{i+1} expm1(-h) D

The JAX scan becomes a Python loop in the idiom of pipeline/ddim.py: one
guided evaluation a step through `guided_model`, the per-step coefficients
computed on the host in float32 numpy (as the scan computes them in fp32),
the first step's branch taken on the host, the update in fp32 and x carried
in the nets' dtype. A captured graph therefore holds one schedule.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from stablediffusioneo_tpu_torch.models.controlnet import ControlNet
from stablediffusioneo_tpu_torch.models.unet import UNetModel
from stablediffusioneo_tpu_torch.ops.schedule import DiffusionSchedule
from stablediffusioneo_tpu_torch.pipeline.ddim import _hoist_context_kv, guided_model

F32 = np.float32


def dpmpp_schedule(
    schedule: DiffusionSchedule, num_steps: int,
    spacing: str = "uniform", rho: float = 7.0,
) -> Dict[str, np.ndarray]:
    """Per-step (t, alpha, sigma, lambda) in SAMPLING order, plus the final
    target (t -> 0 endpoint uses the last diffusion step's abar).

    spacing="karras" (the "DPM++ 2M Karras" variant, Karras et al.
    arXiv:2206.00364 eq. 5): the VE sigmas sigma_k = sigma/alpha follow the
    rho-7 power spacing instead of uniform timesteps — denser steps near
    the low-noise end, where 2M's quality is won. alpha/sigma derive
    exactly from sigma_k via the VP identity (alpha = 1/sqrt(1+sigma_k^2));
    the model-eval t comes from log-sigma interpolation over the trained
    discrete schedule (fractional t — the timestep embedding is continuous).
    Same array shapes/keys as uniform, so the SAME compiled engine serves
    both spacings (schedules are engine inputs)."""
    abar = schedule.alphas_cumprod
    if spacing == "karras":
        log_sig = 0.5 * (np.log1p(-abar) - np.log(abar))  # increasing in t
        sig_min, sig_max = np.exp(log_sig[0]), np.exp(log_sig[-1])
        ramp = np.linspace(0.0, 1.0, num_steps + 1)
        sigmas = (sig_max ** (1 / rho)
                  + ramp * (sig_min ** (1 / rho) - sig_max ** (1 / rho))
                  ) ** rho                                # descending
        a = (1.0 / np.sqrt(1.0 + sigmas ** 2)).astype(np.float32)
        s = (sigmas * a).astype(np.float32)
        ts_f = np.interp(np.log(sigmas), log_sig,
                         np.arange(len(abar), dtype=np.float64))
        ts_eval = ts_f[:-1].astype(np.float32)
    elif spacing == "uniform":
        # timesteps descending from T-1 to ~0, inclusive endpoints
        ts = np.linspace(schedule.num_timesteps - 1, 0,
                         num_steps + 1).round().astype(int)
        a = np.sqrt(abar[ts]).astype(np.float32)         # alpha_t
        s = np.sqrt(1.0 - abar[ts]).astype(np.float32)   # sigma_t
        ts_eval = ts[:-1].astype(np.float32)
    else:
        raise ValueError(f"unknown dpmpp spacing {spacing!r}")
    lam = np.log(np.maximum(a, 1e-12) / np.maximum(s, 1e-12)).astype(np.float32)
    return {
        "t": ts_eval,                         # model eval times
        "alpha_cur": a[:-1], "sigma_cur": s[:-1], "lambda_cur": lam[:-1],
        "alpha_next": a[1:], "sigma_next": s[1:], "lambda_next": lam[1:],
        "step_idx": np.arange(num_steps, dtype=np.int32),
    }


def x0_prediction(model, x: torch.Tensor, t, alpha, sigma,
                  parameterization: str) -> torch.Tensor:
    """The guided data prediction at x, fp32: from eps, (x - sigma m) /
    alpha; from v, alpha x - sigma m (alpha, sigma: float32 scalars)."""
    m = model(x, float(t)).float()
    xf = x.float()
    if parameterization == "v":
        return float(alpha) * xf - float(sigma) * m
    return (xf - float(sigma) * m) / float(alpha)


def dpmpp_sample(
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
    """The DPM-Solver++(2M) loop over a `dpmpp_schedule` (either spacing);
    deterministic. Arguments as pipeline/ddim.py:ddim_sample; returns the x_0
    latents, NHWC fp32 (with bf16 nets, the bf16 values the loop carries)."""
    dtype = dtype or ctx_cond.dtype
    model = guided_model(unet, control, _hoist_context_kv(
        unet, control, hint, ctx_cond, ctx_uncond, control_scales, guess_mode,
        dtype), guess_mode, scale, cfg_rescale, tome)
    x = x_T.to(dtype)
    prev_x0, prev_lam = None, None
    for i in range(len(schedule["t"])):
        a_c, s_c, l_c = (F32(schedule[k][i]) for k in
                         ("alpha_cur", "sigma_cur", "lambda_cur"))
        a_n, s_n, l_n = (F32(schedule[k][i]) for k in
                         ("alpha_next", "sigma_next", "lambda_next"))
        x0 = x0_prediction(model, x, schedule["t"][i], a_c, s_c, parameterization)
        h = F32(l_n - l_c)
        if prev_x0 is None:
            d = x0
        else:
            r = F32(F32(l_c - prev_lam) / np.maximum(h, F32(1e-12)))
            coeff = F32(F32(1.0) / (F32(2.0) * np.maximum(r, F32(1e-12))))
            d = float(F32(1.0) + coeff) * x0 - float(coeff) * prev_x0
        x = (float(F32(s_n / s_c)) * x.float()
             - float(F32(a_n * np.expm1(-h))) * d).to(dtype)
        prev_x0, prev_lam = x0, l_c
    return x.float()
