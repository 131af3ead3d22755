"""Kernel dispatch: the device rule and the launch counters.

Counterpart of stablediffusioneo_tpu/ops/dispatch.py. The rule has no
switches: a kernel-gated site given CUDA tensors launches the hand-written
kernel (or raises when the kernel does not take the input); given CPU
tensors it runs the kernel's plain PyTorch version. The gates themselves are
the JAX package's defaults (ops/attention.py: no mask and at least
`ATTN_MIN_TQ` query tokens).

`launches` holds one plain integer per kernel entry. A wrapper adds one
exactly where it launches its kernel, so a run can show that its main path
went through the kernels.
"""

from __future__ import annotations

from typing import Dict

import torch

# query tokens from which attention goes to the fused kernel
# (the JAX package's _min_tq default, stablediffusioneo_tpu/ops/attention.py)
ATTN_MIN_TQ = 1024

KERNELS = ("fused_attention_packed", "fused_attention")

launches: Dict[str, int] = {name: 0 for name in KERNELS}


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0


def count_launch(name: str) -> None:
    launches[name] += 1


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when the inputs live on a CUDA device (then the kernel must run);
    False when they all live on the CPU (then the plain version runs)."""
    devices = {t.device.type for t in tensors}
    if devices == {"cuda"}:
        return True
    if devices == {"cpu"}:
        return False
    raise ValueError(f"kernel inputs on mixed or unsupported devices: {devices}")
