"""Kernel dispatch: the kernel flags, the device rule and the launch counters.

Counterpart of stablediffusioneo_tpu/ops/dispatch.py. Attention has no
switch: its gate is the JAX package's default (ops/attention.py: no mask and
at least `ATTN_MIN_TQ` query tokens). The norm kernels and the int8
dequant-matmul are behind the JAX package's flags of the same names, off by
default as there: `set_kernels(groupnorm=True, layernorm=True)` is the
fused-norm configuration (the JAX package's SDEO_FORCE_GN_PALLAS=1
SDEO_FORCE_LN_PALLAS=1), `set_kernels(int8_linear=True)` sends the linears
that `quantize_linears=True` converted to the kernel (SDEO_INT8_PALLAS=1).
`set_kernels(remat=True)` is the JAX package's SDEO_REMAT: under grad, the
UNet's and ControlNet's ResBlocks and SpatialTransformers keep no
activations and run their forward again in the backward
(models/unet.py:remat). The flags are process-wide; the port reads no
environment variable.

The device rule: a kernel-gated site given CUDA tensors launches the
hand-written kernel (or raises when the kernel does not take the input);
given CPU tensors it runs the kernel's plain PyTorch version. Under
autograd (`needs_grad`) the attention and LayerNorm entries run through
their torch.autograd.Function, the same on both devices; the GroupNorm and
int8 matmul entries, which have no VJP in the JAX package, raise
(`refuse_grad`): no entry returns a tensor cut off from an input that
requires grad.

`launches` holds one plain integer per kernel entry. A wrapper adds one
exactly where it launches its kernel, so a run can show that its main path
went through the kernels. The wrappers' counters by variant or plan register
here too (`register_counter`), so that a captured engine (runtime/engine.py)
can take back what its capture counted (`counts` before and after, `add_counts`
of the negated difference: a capture puts nothing on the device) and add the
same difference at every replay: the counters go on meaning "kernels put on
the device".
"""

from __future__ import annotations

import functools
from typing import Dict, List, MutableMapping, Tuple

import torch

# query tokens from which attention goes to the fused kernel
# (the JAX package's _min_tq default, stablediffusioneo_tpu/ops/attention.py)
ATTN_MIN_TQ = 1024

KERNELS = ("fused_attention_packed", "fused_attention_packed_stream",
           "fused_attention", "fused_group_norm", "group_norm_stats",
           "group_norm_apply", "fused_layer_norm", "quantized_matmul")

launches: Dict[str, int] = {name: 0 for name in KERNELS}

_FLAGS: Dict[str, bool] = {"groupnorm": False, "layernorm": False,
                           "int8_linear": False, "remat": False}

# every launch counter of the package: `launches` and the wrappers' counters
# by variant or plan
_COUNTERS: List[MutableMapping] = [launches]


def set_kernels(**flags: bool) -> None:
    """Turn kernel families on or off, e.g. set_kernels(groupnorm=True)."""
    for name, on in flags.items():
        if name not in _FLAGS:
            raise KeyError(f"unknown kernel flag {name!r}; have {sorted(_FLAGS)}")
        _FLAGS[name] = bool(on)


def kernels_enabled(name: str) -> bool:
    return _FLAGS.get(name, False)


def kernel_flags() -> Tuple[Tuple[str, bool], ...]:
    """The flags as a sorted tuple: part of a captured engine's key, since
    they change which kernels a capture holds."""
    return tuple(sorted(_FLAGS.items()))


def register_counter(counter: MutableMapping) -> None:
    _COUNTERS.append(counter)


def counts() -> List[dict]:
    """A copy of every registered counter, in registration order."""
    return [dict(c) for c in _COUNTERS]


def counts_since(before: List[dict]) -> List[dict]:
    """What every counter gained since `before = counts()` (non-zero entries)."""
    return [{k: v - was.get(k, 0) for k, v in c.items() if v != was.get(k, 0)}
            for was, c in zip(before, _COUNTERS)]


def add_counts(delta: List[dict], times: int = 1) -> None:
    """Add `times` x `delta` (from `counts_since`) to the counters."""
    for c, d in zip(_COUNTERS, delta):
        for k, v in d.items():
            c[k] = c.get(k, 0) + times * v


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


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records an op on these inputs: grad mode is on and
    one of them requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def vjp(fn, inputs, g):
    """The gradients of fn(*inputs) against the cotangent g, by autograd
    through fn: the JAX `jax.vjp(fn, *inputs)[1](g)`, which the kernels'
    backward passes take of their plain versions."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_() for t in inputs]
        return torch.autograd.grad(fn(*xs), xs, g)


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise where autograd would need a gradient through kernel entry
    `name`, which has none: the JAX package defines no VJP for its Pallas
    kernel (jax.grad fails to linearise the pallas_call), so the port gives
    it none either, on either device, rather than a detached output."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{name} has no gradient (as in the JAX package, whose kernel has no "
            "VJP); turn its kernel flag off (ops/dispatch.py:set_kernels) to "
            "differentiate through this site")


@functools.lru_cache(maxsize=256)
def const_tensor(value: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A 0-dim tensor holding `value` rounded to `dtype`, made once for each
    (value, dtype, device) and never written. A loop that multiplies by such a
    scalar every step copies nothing from the host after its first pass, which
    a CUDA graph capture requires; the rounding to `dtype` stays where a fresh
    torch.tensor(value, dtype=dtype) put it."""
    return torch.tensor(value, dtype=dtype, device=device)
