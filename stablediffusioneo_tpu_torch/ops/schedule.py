"""Diffusion schedule math (counterpart of stablediffusioneo_tpu/ops/schedule.py).

The DDPM/DDIM constants are host-side numpy, as in the JAX package; the
sinusoidal timestep embedding runs on the tensors' device in fp32.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def make_beta_schedule(n_timestep: int = 1000, linear_start: float = 0.00085,
                       linear_end: float = 0.0120) -> np.ndarray:
    """SD's "linear" schedule: linear in sqrt(beta), float64."""
    return np.linspace(linear_start ** 0.5, linear_end ** 0.5, n_timestep,
                       dtype=np.float64) ** 2


def make_ddim_timesteps(num_ddim_timesteps: int,
                        num_ddpm_timesteps: int) -> np.ndarray:
    """Uniform DDIM discretisation with the reference's +1 offset (ceil
    stride, as the JAX package, so non-divisor step counts stay in range)."""
    c = -(-num_ddpm_timesteps // num_ddim_timesteps)
    return np.asarray(list(range(0, num_ddpm_timesteps, c))) + 1


class DiffusionSchedule:
    """alphas_cumprod of the DDPM schedule and the per-step DDIM constants."""

    def __init__(self, timesteps: int = 1000, linear_start: float = 0.00085,
                 linear_end: float = 0.0120, schedule: str = "linear"):
        if schedule != "linear":
            raise NotImplementedError(
                f"beta schedule {schedule!r}: the port has SD's 'linear' only")
        self.num_timesteps = timesteps
        betas = make_beta_schedule(timesteps, linear_start, linear_end)
        self.alphas_cumprod = np.cumprod(1.0 - betas, axis=0)

    def ddim(self, num_steps: int, eta: float = 0.0) -> Dict[str, np.ndarray]:
        """Per-step float32 arrays in SAMPLING order (t high -> low)."""
        ts = make_ddim_timesteps(num_steps, self.num_timesteps)
        ac = self.alphas_cumprod
        alphas = ac[ts]
        alphas_prev = np.asarray([ac[0]] + ac[ts[:-1]].tolist())
        sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas)
                               * (1 - alphas / alphas_prev))
        rev = slice(None, None, -1)
        return {
            "timesteps": np.ascontiguousarray(ts[rev]).astype(np.int32),
            "alphas": np.ascontiguousarray(alphas[rev]).astype(np.float32),
            "alphas_prev": np.ascontiguousarray(alphas_prev[rev]).astype(np.float32),
            "sigmas": np.ascontiguousarray(sigmas[rev]).astype(np.float32),
            "sqrt_one_minus_alphas": np.sqrt(
                1.0 - np.ascontiguousarray(alphas[rev])).astype(np.float32),
        }


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """(N,) timesteps -> (N, dim) fp32, laid out as [cos(args), sin(args)]."""
    half = dim // 2
    freqs = np.exp((-np.log(max_period) * np.arange(half, dtype=np.float32)
                    / half).astype(np.float32)).astype(np.float32)
    args = (timesteps.float()[:, None]
            * torch.from_numpy(freqs).to(timesteps.device)[None, :])
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb
