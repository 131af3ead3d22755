"""Annotator-net compute dtype policy of the port (counterpart of
stablediffusioneo_tpu/annotators/_dtype.py).

The reference runs every annotator net in fp32 (annotator/midas/__init__.py,
annotator/hed/__init__.py). The JAX package runs them in bf16 on its
accelerator and in fp32 elsewhere: the nets (HED's VGG trunk, the DPT ViTs,
the CMU pose nets) are conditioning preprocessors whose outputs are
quantised to uint8 hints, the same precision argument that runs the
diffusion UNet in bf16, with more headroom. The port follows the JAX
package's accelerator rule, not the reference's: bf16 when the detector's
device is CUDA, fp32 on the CPU (which keeps the CPU parity tests exact).
SDEO_ANNOTATOR_DTYPE=float32|bfloat16 overrides either, as in the JAX
package.

The statistics stay safe in bf16 by construction: the nets' norms and
softmax go through ops/norms.py and ops/attention.py, whose fp32 islands
(norm moments, softmax) are the UNet's.
"""

from __future__ import annotations

import os

import torch

_NAMES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def annotator_dtype(device) -> torch.dtype:
    """Compute dtype for an annotator net on `device` (see the docstring)."""
    env = os.environ.get("SDEO_ANNOTATOR_DTYPE")
    if env:
        if env not in _NAMES:
            raise ValueError(f"SDEO_ANNOTATOR_DTYPE={env!r}; takes {sorted(_NAMES)}")
        return _NAMES[env]
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


def cast_module(module: torch.nn.Module, device, dtype=None) -> torch.nn.Module:
    """The module's floating parameters and buffers in `dtype` (default
    annotator_dtype(device)) on `device`, eval mode, no gradients."""
    dtype = annotator_dtype(device) if dtype is None else dtype
    return module.to(device=device, dtype=dtype).eval().requires_grad_(False)


def default_device(device=None) -> torch.device:
    """The detectors' device: the card unless the caller names another."""
    return torch.device("cuda" if device is None else device)
