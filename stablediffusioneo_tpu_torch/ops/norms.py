"""GroupNorm and LayerNorm with fp32 statistics
(counterpart of stablediffusioneo_tpu/ops/norms.py).

By default, as in the JAX package, neither norm goes to a kernel: both are
plain PyTorch on an fp32 upcast of the input, cast back to the input's
dtype. With the fused-norm configuration on
(`dispatch.set_kernels(groupnorm=True, layernorm=True)`), the sites the JAX
package's gates admit go to the hand-written kernels
(ops/kernels/groupnorm.py, ops/kernels/layernorm.py): GroupNorm on 4-D
input whose slab takes the one-pass kernel, LayerNorm on bfloat16 input of
at least 256K row-chunkable elements.

Eps differs by site in SD-1.5: UNet/ControlNet ResBlock GroupNorm 1e-5,
SpatialTransformer GroupNorm 1e-6, transformer LayerNorm 1e-5, VAE
GroupNorm 1e-6.
"""

from __future__ import annotations

import torch.nn.functional as F

from stablediffusioneo_tpu_torch.ops import dispatch
from stablediffusioneo_tpu_torch.ops.kernels.groupnorm import (
    fused_group_norm,
    group_norm_supported,
)
from stablediffusioneo_tpu_torch.ops.kernels.layernorm import (
    fused_layer_norm,
    layer_norm_supported,
)


def group_norm(x, weight, bias, groups: int, eps: float, swish: bool = False):
    """GroupNorm over NCHW (N, C, ...) in fp32, optional fused SiLU."""
    if (dispatch.kernels_enabled("groupnorm") and x.dim() == 4
            and group_norm_supported(x.shape, groups)):
        return fused_group_norm(x, weight, bias, groups, eps, swish)
    out = F.group_norm(x.float(), groups, weight.float(), bias.float(), eps)
    if swish:
        out = F.silu(out)
    return out.to(x.dtype)


def layer_norm(x, weight, bias, eps: float):
    """LayerNorm over the last dim in fp32."""
    if (dispatch.kernels_enabled("layernorm")
            and layer_norm_supported(x.shape, x.dtype)):
        return fused_layer_norm(x, weight, bias, eps)
    out = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(),
                       eps)
    return out.to(x.dtype)
