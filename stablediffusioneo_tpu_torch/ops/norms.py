"""GroupNorm and LayerNorm with fp32 statistics
(counterpart of stablediffusioneo_tpu/ops/norms.py).

Where a norm runs is one rule (`group_norm_route`, `layer_norm_route`, pure
functions of what a call's input shows and of the flag), and the call runs
the route the rule returns:
- On CUDA tensors outside autograd every call that the hand-written kernel
  takes goes to it, whatever the flags say, as attention does
  (ops/dispatch.py): GroupNorm(+SiLU) on 4-D input to `fused_group_norm`,
  which picks the one-pass kernel (`one_pass`) or the stats + apply pair
  (`pair`) by shape; LayerNorm to `fused_layer_norm` (`kernel`). What the
  kernels take is their own rule (`refusal` and `affine_refusal` in
  ops/kernels/groupnorm.py, `refusal` in ops/kernels/layernorm.py: dtype,
  size, memory layout, the affine pair), which their entries raise on, not
  the JAX package's gates, which size the TPU's VMEM. A call the kernel
  does not take (say, a layout that is neither contiguous NCHW nor
  channels-last) runs the plain version below (`plain_refused`) and raises
  nothing.
- On CPU tensors and under autograd the flags decide, as in the JAX
  package: by default neither norm goes to a kernel (`plain_cpu`,
  `plain_grad`), both are plain PyTorch on an fp32 upcast of the input,
  cast back to the input's dtype. With the fused-norm configuration on
  (`dispatch.set_kernels(groupnorm=True, layernorm=True)`), the sites the
  JAX package's gates admit go to the kernel entries: on CPU tensors their
  plain versions (`flag_cpu`); under autograd on CUDA the LayerNorm kernel
  through its autograd Function (`kernel`), while the GroupNorm entry
  (`one_pass`) refuses the gradient. Those gates: GroupNorm on 4-D input
  whose slab takes the one-pass kernel, LayerNorm on bfloat16 input of at
  least 256K row-chunkable elements. So in `train()` every norm a gradient
  flows through stays plain by default; a frozen net's norm on inputs that
  need no gradient (the UNet's encoder in ControlNet training) is outside
  autograd and takes its kernel.

`route_counts` counts the calls by (norm, route), "group_norm" or
"layer_norm" and the route above; it is registered with the dispatch
counters, so a captured engine adds its calls at every replay. The sp
branch of `group_norm` (mesh engines) keeps its own route and is not
counted.

Eps differs by site in SD-1.5: UNet/ControlNet ResBlock GroupNorm 1e-5,
SpatialTransformer GroupNorm 1e-6, transformer LayerNorm 1e-5, VAE
GroupNorm 1e-6.
"""

from __future__ import annotations

import collections

import torch
import torch.nn.functional as F

from stablediffusioneo_tpu_torch.ops import dispatch
from stablediffusioneo_tpu_torch.ops.kernels import groupnorm as kg
from stablediffusioneo_tpu_torch.ops.kernels import layernorm as kl
from stablediffusioneo_tpu_torch.ops.kernels.groupnorm import (
    affine_refusal,
    chunk_rows,
    fused_group_norm,
    group_norm_apply,
    group_norm_stats,
    group_norm_supported,
    memory_layout,
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

# norm calls by (norm, route) since the last clear()
route_counts: "collections.Counter[tuple]" = collections.Counter()
dispatch.register_counter(route_counts)

_GN_ENTRY_ROUTES = ("one_pass", "pair", "flag_cpu")
_LN_ENTRY_ROUTES = ("kernel", "flag_cpu")


def group_norm_route(shape, groups: int, dtype: torch.dtype, layout: str,
                     device_type: str, needs_grad: bool, affine: bool = True,
                     flag: bool = False) -> str:
    """The route of a GroupNorm call: "one_pass" or "pair" (the kernels),
    "plain_refused", or where the flag decides "flag_cpu", "plain_cpu" or
    "plain_grad". layout: `memory_layout`'s name; affine: whether the
    kernels take the weight and bias as they are; flag: the groupnorm
    flag."""
    if device_type == "cuda" and not needs_grad:
        if not affine or kg.refusal(shape, groups, dtype, layout) is not None:
            return "plain_refused"
        # fused_group_norm's own choice: one pass where the JAX entry runs one
        return "one_pass" if group_norm_supported(shape, groups) else "pair"
    if flag and group_norm_supported(shape, groups):
        return "one_pass" if device_type == "cuda" else "flag_cpu"
    return "plain_grad" if device_type == "cuda" else "plain_cpu"


def layer_norm_route(shape, dtype: torch.dtype, layout: str, device_type: str,
                     needs_grad: bool, affine: bool = True, flag: bool = False) -> str:
    """The route of a LayerNorm call: "kernel", "plain_refused", or where
    the flag decides "flag_cpu", "plain_cpu" or "plain_grad"; the arguments
    as for `group_norm_route`, flag the layernorm flag."""
    if device_type == "cuda" and not needs_grad:
        if not affine or kl.refusal(shape, dtype, layout) is not None:
            return "plain_refused"
        return "kernel"
    if flag and layer_norm_supported(shape, dtype):
        return "kernel" if device_type == "cuda" else "flag_cpu"
    return "plain_grad" if device_type == "cuda" else "plain_cpu"


def group_norm(x, weight, bias, groups: int, eps: float, swish: bool = False):
    """GroupNorm over NCHW (N, C, ...) in fp32, optional fused SiLU, routed
    by `group_norm_route`. Inside a mesh engine whose rows are split over
    sp, the fp32 moments are all-reduced over sp: with the kernel flag on
    and the whole image's slab gated in, the stats kernel's partial sums of
    this rank's rows, then the apply kernel on the summed partials and the
    whole image's count; else plain (parallel/mesh.py:sp_group_norm)."""
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
    route = group_norm_route(
        x.shape, groups, x.dtype, memory_layout(x), x.device.type,
        dispatch.needs_grad(x, weight, bias),
        affine_refusal("group norm", x.shape[1], x.device, weight, bias) is None,
        dispatch.kernels_enabled("groupnorm"))
    route_counts["group_norm", route] += 1
    if route in _GN_ENTRY_ROUTES:
        return fused_group_norm(x, weight, bias, groups, eps, swish)
    out = F.group_norm(x.float(), groups, weight.float(), bias.float(), eps)
    if swish:
        out = F.silu(out)
    return out.to(x.dtype)


def layer_norm(x, weight, bias, eps: float):
    """LayerNorm over the last dim in fp32, routed by `layer_norm_route`.
    Inside a mesh engine the kernel takes this rank's tokens as they are:
    each row is whole under dp, tp and sp. (The JAX package keeps its kernel
    off under a mesh, because GSPMD has no partitioning rule for that
    pallas_call and would gather its operands; the port has no such limit.)"""
    route = layer_norm_route(
        x.shape, x.dtype, memory_layout(x), x.device.type,
        dispatch.needs_grad(x, weight, bias),
        affine_refusal("layer norm", x.shape[-1], x.device, weight, bias) is None,
        dispatch.kernels_enabled("layernorm"))
    route_counts["layer_norm", route] += 1
    if route in _LN_ENTRY_ROUTES:
        return fused_layer_norm(x, weight, bias, eps)
    out = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(),
                       eps)
    return out.to(x.dtype)
