"""The reference computed one precision below the configurations' bf16:
every product (linear, convolution, einsum, matmul, bmm) takes its two
operands rounded to float8 e4m3, each scaled per tensor so that its largest
magnitude is the format's largest finite value (448), and accumulates in
float32, as an FP8 tensor-core GEMM with per-tensor scales does. This is the
output check's control: the step below bf16 that a later change might take."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0


def round_e4m3(x: torch.Tensor) -> torch.Tensor:
    if not x.is_floating_point():
        return x
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / E4M3_MAX
    return (x.float() / scale).to(torch.float8_e4m3fn).float() * scale


PRODUCTS = {F.linear: (0, 1), F.conv2d: (0, 1), torch.matmul: (0, 1), torch.bmm: (0, 1),
            torch.Tensor.__matmul__: (0, 1), torch.Tensor.matmul: (0, 1)}


class RoundedProducts(TorchFunctionMode):
    """Within the mode, the operands of every product are rounded as above."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.einsum:
            eq, *ops = args
            if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
                ops = list(ops[0])
            return func(eq, *[round_e4m3(o) for o in ops], **kwargs)
        if func in PRODUCTS:
            args = list(args)
            for i in PRODUCTS[func]:
                if i < len(args):
                    args[i] = round_e4m3(args[i])
            if func in (F.linear, F.conv2d) and "weight" in kwargs:
                kwargs["weight"] = round_e4m3(kwargs["weight"])
        return func(*args, **kwargs)
