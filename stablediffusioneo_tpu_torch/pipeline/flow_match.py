"""Rectified-flow sampling: diffusers' FlowMatchEulerDiscreteScheduler
(stabilityai/stable-diffusion-3.5-medium, scheduler/scheduler_config.json:
1000 training steps, shift 3.0, no dynamic shifting) with classifier-free
guidance, as StableDiffusion3Pipeline runs it.

Schedule (`flow_match_sigmas`): with shift(s) = shift*s / (1 + (shift-1)*s),
the training sigmas are shift(t / 1000) for t = 1000, ..., 1; N steps take
the timesteps linspace(1000 * shift(1), 1000 * shift(1/1000), N), divide them
by 1000 and shift them again (diffusers shifts the end points once at
construction and the spaced values once more), then append a final 0. The
model's timestep at step i is 1000 * sigma_i.

Update (`flow_match_sample`): v = v_u + scale * (v_c - v_u) and x <- x +
(sigma_{i+1} - sigma_i) * v, in fp32, the latents carried in the nets' dtype
and rounded once a step (diffusers' step upcasts the sample and casts the
result back). The step's scalars are device tensors made once, before a
capture (`flow_match_steps`), so the loop captures into one CUDA graph.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

NUM_TRAIN_TIMESTEPS = 1000


def shifted(s, shift: float):
    """The time shift of SD3's flow schedule: shift*s / (1 + (shift-1)*s)."""
    return shift * s / (1.0 + (shift - 1.0) * s)


def flow_match_sigmas(num_steps: int, shift: float = 3.0,
                      num_train_timesteps: int = NUM_TRAIN_TIMESTEPS) -> np.ndarray:
    """The num_steps + 1 sigmas of a request, float64, from 1 down to the
    final 0 (see the module docstring)."""
    if num_steps < 1:
        raise ValueError(f"flow matching needs at least one step, got {num_steps}")
    t_max = num_train_timesteps * shifted(1.0, shift)
    t_min = num_train_timesteps * shifted(1.0 / num_train_timesteps, shift)
    s = np.linspace(t_max, t_min, num_steps) / num_train_timesteps
    return np.concatenate([shifted(s, shift), [0.0]])


def flow_match_steps(sigmas: np.ndarray, device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Each step's (model timestep 1000 * sigma_i, sigma_{i+1} - sigma_i) as
    0-dim fp32 tensors on `device`. A captured loop reads them at every
    replay, so its owner holds the list for as long as the graph lives."""
    return [(torch.tensor(NUM_TRAIN_TIMESTEPS * float(a), dtype=torch.float32, device=device),
             torch.tensor(float(b) - float(a), dtype=torch.float32, device=device))
            for a, b in zip(sigmas[:-1], sigmas[1:])]


def flow_match_sample(velocity: Callable, steps, x: torch.Tensor, scale: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    """The Euler loop over `steps` (`flow_match_steps`) with guidance.
    velocity(x2 (2B, ...) in `dtype`, t (2B,) fp32 model timesteps) ->
    (v_cond, v_uncond); x (B, ...) the initial noise; scale (B,) fp32, one
    guidance scale a row. Returns the fp32 widening of the last latents."""
    x = x.to(dtype)
    b = x.shape[0]
    g = scale.float().reshape((b,) + (1,) * (x.dim() - 1))
    for t, dt in steps:
        v_c, v_u = velocity(torch.cat([x, x]), t.expand(2 * b))
        v = v_u.float() + g * (v_c.float() - v_u.float())
        x = (x.float() + dt * v).to(dtype)
    return x.float()
