"""Primitive layers on tensors (counterpart of stablediffusioneo_tpu/ops/layers.py).

Layouts: torch's own. Conv weights are OIHW and linear weights (out, in), as
in the original checkpoints; activations inside a network are NCHW (convs
are the modules' own nn.Conv2d). The model-level entry points (models/*)
take and return the JAX package's NHWC.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from stablediffusioneo_tpu_torch.ops.quant import QuantizedLinear
from stablediffusioneo_tpu_torch.parallel.mesh import copy_to, row_linear


def linear(x, weight, bias=None):
    """x (..., in) @ weight (out, in)^T + bias; weights follow x's dtype."""
    return F.linear(x, weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype))


def dense(x, layer):
    """x through an nn.Linear, or through the int8 form that
    ops/quant.py:quantize_linear_modules put in its place (the JAX
    package's linear(x, p) on a {"w_q", "scale"} leaf). A linear that
    parallel/mesh.py:shard_params made tensor-parallel runs as such:
    row-parallel (`tp_row`) through `row_linear`, column-parallel
    (`tp_col`) with its input through `copy_to`."""
    if isinstance(layer, QuantizedLinear):
        return layer(x)
    row = getattr(layer, "tp_row", None)
    if row is not None:
        return row_linear(x, layer.weight, layer.bias, row)
    return linear(copy_to(x, getattr(layer, "tp_col", None)), layer.weight, layer.bias)


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


class FrozenBatchNorm2d(nn.Module):
    """Inference BatchNorm over NCHW with torch's parameter names (weight,
    bias, running_mean, running_var) and no num_batches_tracked buffer, for
    the files that carry none (pytorch_fid's pt_inception) or whose loader
    reads none (YOLOv5's): x - mean over sqrt(var + eps), then the affine."""

    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)
