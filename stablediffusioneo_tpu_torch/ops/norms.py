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
    chunk_rows,
    fused_group_norm,
    group_norm_apply,
    group_norm_stats,
    group_norm_supported,
)
from stablediffusioneo_tpu_torch.ops.kernels.layernorm import (
    fused_layer_norm,
    layer_norm_supported,
)
from stablediffusioneo_tpu_torch.parallel.mesh import (
    all_reduce,
    sp_group_norm,
    spatial_axis,
)


def group_norm(x, weight, bias, groups: int, eps: float, swish: bool = False):
    """GroupNorm over NCHW (N, C, ...) in fp32, optional fused SiLU. Inside
    a mesh engine whose rows are split over sp, the fp32 moments are
    all-reduced over sp: with the kernel flag on and the whole image's slab
    gated in, the stats kernel's partial sums of this rank's rows, then the
    apply kernel on the summed partials and the whole image's count; else
    plain (parallel/mesh.py:sp_group_norm)."""
    sp = spatial_axis()
    if sp is not None and x.dim() == 4:
        n, c, h, w = x.shape
        if (dispatch.kernels_enabled("groupnorm")
                and group_norm_supported((n, c, h * sp.size, w), groups)):
            rows = chunk_rows(x, groups)
            partials = all_reduce(group_norm_stats(x, groups, rows), sp)
            return group_norm_apply(x, partials, weight, bias, rows, eps, swish,
                                    count=c // groups * h * sp.size * w)
        return sp_group_norm(x, weight, bias, groups, eps, swish, sp)
    if (dispatch.kernels_enabled("groupnorm") and x.dim() == 4
            and group_norm_supported(x.shape, groups)):
        return fused_group_norm(x, weight, bias, groups, eps, swish)
    out = F.group_norm(x.float(), groups, weight.float(), bias.float(), eps)
    if swish:
        out = F.silu(out)
    return out.to(x.dtype)


def layer_norm(x, weight, bias, eps: float):
    """LayerNorm over the last dim in fp32. Inside a mesh engine the kernel
    takes this rank's tokens as they are: each row is whole under dp, tp and
    sp. (The JAX package keeps its kernel off under a mesh, because GSPMD
    has no partitioning rule for that pallas_call and would gather its
    operands; the port has no such limit.)"""
    if (dispatch.kernels_enabled("layernorm")
            and layer_norm_supported(x.shape, x.dtype)):
        return fused_layer_norm(x, weight, bias, eps)
    out = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(),
                       eps)
    return out.to(x.dtype)
