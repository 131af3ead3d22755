"""Primitive layers on tensors (counterpart of stablediffusioneo_tpu/ops/layers.py).

Layouts: torch's own. Conv weights are OIHW and linear weights (out, in), as
in the original checkpoints; activations inside a network are NCHW (convs
are the modules' own nn.Conv2d). The model-level entry points (models/*)
take and return the JAX package's NHWC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stablediffusioneo_tpu_torch.ops.quant import QuantizedLinear


def linear(x, weight, bias=None):
    """x (..., in) @ weight (out, in)^T + bias; weights follow x's dtype."""
    return F.linear(x, weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype))


def dense(x, layer):
    """x through an nn.Linear, or through the int8 form that
    ops/quant.py:quantize_linear_modules put in its place (the JAX
    package's linear(x, p) on a {"w_q", "scale"} leaf)."""
    if isinstance(layer, QuantizedLinear):
        return layer(x)
    return linear(x, layer.weight, layer.bias)


def silu(x):
    return F.silu(x)


def gelu(x):
    """Exact (erf) GELU."""
    return F.gelu(x, approximate="none")


def geglu(x, layer):
    """GEGLU feed-forward gate (ldm/modules/attention.py GEGLU); layer is the
    (dim, 2 * inner) projection."""
    a, gate = dense(x, layer).chunk(2, dim=-1)
    return a * gelu(gate)


def upsample_nearest_2x(x):
    """Nearest-neighbour 2x upsample of NCHW."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


def resize_latent_bilinear(z: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear upscale of NHWC latents to (h, w) in fp32: the hires fix's
    jax.image.resize(z.astype(f32), shape, "bilinear"). For upscaling the
    two agree: half-pixel centres, and the edge clamp of F.interpolate gives
    what JAX's renormalised triangle kernel gives. Downscaling (where JAX
    antialiases) is refused."""
    if h < z.shape[1] or w < z.shape[2]:
        raise ValueError(f"upscaling only: {tuple(z.shape[1:3])} -> {(h, w)}")
    out = F.interpolate(nchw(z.float()), size=(h, w), mode="bilinear",
                        align_corners=False)
    return nhwc(out).contiguous()


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)
