"""Int8 weight-only linears (counterpart of the non-kernel half of
stablediffusioneo_tpu/ops/pallas/quant.py).

  * `quantize_weights`: per-output-channel symmetric int8, as the JAX
    package's: scale = max(amax / 127, 1e-8), round half to even, clip to
    +-127. In torch's (out, in) layout the amax runs over `in`.
  * `quantize_linear_modules`: replace, in place, the nn.Linear modules that
    the JAX package's `quantize_linear_tree` converts (both dims >= min_dim,
    not an attention projection) with `QuantizedLinear`. In SD-1.5 those are
    the time-embedding MLP, each ResBlock's `emb` projection and the GEGLU
    feed-forward pair of every transformer block.
  * `quantized_linear`: the int8 linear. With `set_kernels(int8_linear=True)`
    and blocks that tile (M, N) as the JAX package picks them, the kernel
    (ops/kernels/quant.py); otherwise the dequantised weights rounded to x's
    dtype and a plain F.linear. The bias is added after the cast back to x's
    dtype in both branches.
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from stablediffusioneo_tpu_torch.ops import dispatch
from stablediffusioneo_tpu_torch.ops.kernels.quant import pick_blocks, quantized_matmul

# attention projections stay in the compute dtype, as the JAX package's
# _QUANT_EXCLUDE ("wq", "wk", "wv", "wo") leaves them
_ATTN_PROJECTION = re.compile(r"(^|\.)(to_q|to_k|to_v|to_out\.0)$")


def quantize_weights(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, in) float -> (int8 (out, in), fp32 (out,) scales)."""
    wf = w.float()
    scale = torch.clamp(wf.abs().amax(dim=1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(wf / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


class QuantizedLinear(nn.Module):
    """An nn.Linear's int8 weight-only form: buffers w_q (out, in) int8 and
    scale (out,) fp32, the bias as it was."""

    def __init__(self, linear: nn.Linear):
        super().__init__()
        q, scale = quantize_weights(linear.weight.detach())
        self.register_buffer("w_q", q)
        self.register_buffer("scale", scale)
        self.bias = linear.bias

    def forward(self, x):
        return quantized_linear(x, self.w_q, self.scale, self.bias)


def quantize_linear_modules(module: nn.Module, min_dim: int = 256) -> int:
    """Convert the eligible nn.Linear modules under `module` in place;
    returns how many were converted."""
    picked = [(name, m) for name, m in module.named_modules()
              if isinstance(m, nn.Linear) and min(m.weight.shape) >= min_dim
              and not _ATTN_PROJECTION.search(name)]
    for name, m in picked:
        parent, _, child = name.rpartition(".")
        setattr(module.get_submodule(parent), child, QuantizedLinear(m))
    return len(picked)


def quantized_linear(x, w_q, scale, bias: Optional[torch.Tensor] = None):
    """x (..., in) through int8 weights (out, in) with fp32 scales (out,)."""
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k)
    if dispatch.kernels_enabled("int8_linear") and pick_blocks(x2.shape[0], w_q.shape[0]):
        out = quantized_matmul(x2.contiguous(), w_q, scale)
    else:
        out = F.linear(x2, (w_q.float() * scale[:, None]).to(x.dtype))
    out = out.reshape(*lead, w_q.shape[0])
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out
