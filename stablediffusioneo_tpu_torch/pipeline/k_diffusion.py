"""k-diffusion samplers: Euler, Euler-ancestral, Heun (Karras et al.,
arXiv:2206.00364), counterpart of stablediffusioneo_tpu/pipeline/k_diffusion.py.

The latent x stays in VP space (the nets' input); the updates run over the
VE sigma sigk = sigma_t / alpha_t on xhat = x / alpha_t:

    Euler   : xhat' = xhat + (sigk_next - sigk_cur) eps
    Euler-a : xhat' = xhat + (sigk_down - sigk_cur) eps + sigk_up noise
    Heun    : d1 = eps(xhat, t); xhat_e = xhat + dk d1
              d2 = eps(xhat_e, t_next); xhat' = xhat + dk (d1 + d2) / 2
              (the last step, to sigma 0, is a plain Euler step)
    then      x' = xhat' alpha_next

The grid ends at sigma 0, so the last state is the x0 prediction.
Evaluations: Euler and Euler-a N, Heun 2N - 1. As in pipeline/ddim.py: a
Python loop, per-step constants float32 from the schedule, branches on the
host, fp32 updates, x carried in the nets' dtype; Euler-a's noise of every
step comes from `noise[i]` (NHWC) or `generator`, drawn outside any graph.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from stablediffusioneo_tpu_torch.models.controlnet import ControlNet
from stablediffusioneo_tpu_torch.models.unet import UNetModel
from stablediffusioneo_tpu_torch.ops.schedule import DiffusionSchedule
from stablediffusioneo_tpu_torch.pipeline.ddim import _hoist_context_kv, guided_model

KDIFF_SAMPLERS = ("euler", "euler-a", "heun")
F32 = np.float32


def kdiff_schedule(
    schedule: DiffusionSchedule, num_steps: int,
    spacing: str = "karras", rho: float = 7.0,
) -> Dict[str, np.ndarray]:
    """Per-step boundary constants in SAMPLING order.

    Keys (each (num_steps,) float32): t / t_next (model-eval times at the
    step's start/end boundary; t_next of the final step is 0 and unused —
    sigk_next there is 0), alpha_cur/alpha_next (VP alphas), sigk_cur/
    sigk_next (VE sigmas; sigk_next[-1] == 0), sigk_down/sigk_up (the
    ancestral noise split; zero wherever sigk_next is 0 — with eta_a = 1,
    sigk_down collapses to sigk_next^2 / sigk_cur), step_idx (int32).

    spacing="karras": rho-7 power ramp over [sigk_max, sigk_min] then a
    final 0 (k-diffusion's get_sigmas_karras convention). spacing="uniform":
    eval points on the round(linspace(T-1, 0, N)) grid, final boundary 0.
    Same shapes/keys either way -> one compiled program per sampler.
    """
    abar = schedule.alphas_cumprod
    log_sig = 0.5 * (np.log1p(-abar) - np.log(abar))  # increasing in t
    if spacing == "karras":
        sig_min, sig_max = np.exp(log_sig[0]), np.exp(log_sig[-1])
        ramp = np.linspace(0.0, 1.0, num_steps)
        sig_eval = (sig_max ** (1 / rho)
                    + ramp * (sig_min ** (1 / rho) - sig_max ** (1 / rho))
                    ) ** rho                           # descending, N points
        ts_eval = np.interp(np.log(sig_eval), log_sig,
                            np.arange(len(abar), dtype=np.float64))
    elif spacing == "uniform":
        ts_eval = np.linspace(schedule.num_timesteps - 1, 0,
                              num_steps).round().astype(np.float64)
        sig_eval = np.exp(np.interp(ts_eval, np.arange(len(abar)), log_sig))
    else:
        raise ValueError(f"unknown kdiff spacing {spacing!r}")
    sigk = np.concatenate([sig_eval, [0.0]])           # N+1 boundaries
    a = 1.0 / np.sqrt(1.0 + sigk ** 2)                 # VP alpha; a[-1]=1
    sk_c, sk_n = sigk[:-1], sigk[1:]
    # ancestral split (eta_a = 1): up = sk_n * sqrt(sk_c^2 - sk_n^2) / sk_c
    with np.errstate(invalid="ignore", divide="ignore"):
        sk_up = np.where(
            sk_n > 0.0,
            sk_n * np.sqrt(np.maximum(sk_c ** 2 - sk_n ** 2, 0.0))
            / np.maximum(sk_c, 1e-20),
            0.0,
        )
    sk_down = np.sqrt(np.maximum(sk_n ** 2 - sk_up ** 2, 0.0))
    t_next = np.concatenate([ts_eval[1:], [0.0]])
    f32 = lambda v: np.asarray(v, np.float32)  # noqa: E731
    return {
        "t": f32(ts_eval), "t_next": f32(t_next),
        "alpha_cur": f32(a[:-1]), "alpha_next": f32(a[1:]),
        "sigk_cur": f32(sk_c), "sigk_next": f32(sk_n),
        "sigk_down": f32(sk_down), "sigk_up": f32(sk_up),
        "step_idx": np.arange(num_steps, dtype=np.int32),
    }


def kdiff_sample(
    unet: UNetModel,
    control: ControlNet,
    schedule: Dict[str, np.ndarray],
    x_T: torch.Tensor,
    hint: torch.Tensor,
    ctx_cond: torch.Tensor,
    ctx_uncond: torch.Tensor,
    scale,
    control_scales,
    sampler: str = "euler",
    guess_mode: bool = False,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Sequence[torch.Tensor]] = None,
    dtype=None,
    parameterization: str = "eps",
    cfg_rescale: float = 0.0,
    tome=None,
) -> torch.Tensor:
    """The Euler / Euler-a / Heun loop over a `kdiff_schedule` (either
    spacing). Arguments as pipeline/ddim.py:ddim_sample; Euler-a's step noise
    is `noise[i]` (a sequence or a (steps, B, h, w, 4) tensor) where given,
    else a draw from `generator`, for every step with sigk_up > 0. Returns
    the x_0 latents, NHWC fp32 (with bf16 nets, the bf16 values the loop
    carries)."""
    if sampler not in KDIFF_SAMPLERS:
        raise ValueError(f"unknown k-diffusion sampler {sampler!r}")
    dtype = dtype or ctx_cond.dtype
    model = guided_model(unet, control, _hoist_context_kv(
        unet, control, hint, ctx_cond, ctx_uncond, control_scales, guess_mode,
        dtype), guess_mode, scale, cfg_rescale, tome)

    def eps_at(x, t, alpha, sigk):
        """The guided eps prediction at VP state x (a v-prediction
        converted: eps = alpha v + sigk alpha x), fp32."""
        m = model(x, float(t)).float()
        if parameterization == "v":
            return float(alpha) * m + float(F32(sigk * alpha)) * x.float()
        return m

    def const(key, i):
        return F32(schedule[key][i])

    n = len(schedule["t"])
    x = x_T.to(dtype)
    for i in range(n):
        a_c, a_n = const("alpha_cur", i), const("alpha_next", i)
        sk_c, sk_n = const("sigk_cur", i), const("sigk_next", i)
        eps = eps_at(x, schedule["t"][i], a_c, sk_c)
        xhat = x.float() / float(a_c)
        if sampler == "euler-a":
            xhat = xhat + float(F32(const("sigk_down", i) - sk_c)) * eps
            if const("sigk_up", i) > 0:
                step = (noise[i] if noise is not None else
                        torch.randn(x.shape, generator=generator, device=x.device))
                xhat = xhat + float(const("sigk_up", i)) * step.to(x.device, torch.float32)
        elif sampler == "heun" and i < n - 1:
            dk = F32(sk_n - sk_c)
            x_e = ((xhat + float(dk) * eps) * float(a_n)).to(dtype)  # Euler predictor
            eps2 = eps_at(x_e, schedule["t_next"][i], a_n, sk_n)    # corrector
            xhat = xhat + float(F32(dk * F32(0.5))) * (eps + eps2)
        else:  # Euler, and Heun's last step
            xhat = xhat + float(F32(sk_n - sk_c)) * eps
        x = (xhat * float(a_n)).to(dtype)
    return x.float()
