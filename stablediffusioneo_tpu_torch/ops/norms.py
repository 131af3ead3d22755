"""GroupNorm and LayerNorm with fp32 statistics
(counterpart of stablediffusioneo_tpu/ops/norms.py).

The JAX package leaves both norms to XLA (its Pallas GN and LN kernels are
off by default), so here they are plain PyTorch on an fp32 upcast of the
input, cast back to the input's dtype.

Eps differs by site in SD-1.5: UNet/ControlNet ResBlock GroupNorm 1e-5,
SpatialTransformer GroupNorm 1e-6, transformer LayerNorm 1e-5, VAE
GroupNorm 1e-6.
"""

from __future__ import annotations

import torch.nn.functional as F


def group_norm(x, weight, bias, groups: int, eps: float, swish: bool = False):
    """GroupNorm over NCHW (N, C, ...) in fp32, optional fused SiLU."""
    out = F.group_norm(x.float(), groups, weight.float(), bias.float(), eps)
    if swish:
        out = F.silu(out)
    return out.to(x.dtype)


def layer_norm(x, weight, bias, eps: float):
    """LayerNorm over the last dim in fp32."""
    out = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(),
                       eps)
    return out.to(x.dtype)
