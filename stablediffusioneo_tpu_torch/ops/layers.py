"""Primitive layers on tensors (counterpart of stablediffusioneo_tpu/ops/layers.py).

Layouts: torch's own. Conv weights are OIHW and linear weights (out, in), as
in the original checkpoints; activations inside a network are NCHW (convs
are the modules' own nn.Conv2d). The model-level entry points (models/*)
take and return the JAX package's NHWC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def linear(x, weight, bias=None):
    """x (..., in) @ weight (out, in)^T + bias; weights follow x's dtype."""
    return F.linear(x, weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype))


def silu(x):
    return F.silu(x)


def gelu(x):
    """Exact (erf) GELU."""
    return F.gelu(x, approximate="none")


def geglu(x, weight, bias=None):
    """GEGLU feed-forward gate (ldm/modules/attention.py GEGLU)."""
    a, gate = linear(x, weight, bias).chunk(2, dim=-1)
    return a * gelu(gate)


def upsample_nearest_2x(x):
    """Nearest-neighbour 2x upsample of NCHW."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)
