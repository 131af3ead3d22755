"""Exponential moving average of params (counterpart of
stablediffusioneo_tpu/training/ema.py; LitEma, ldm/modules/ema.py:5-76).

The EMA state is a (shadow, num_updates) tuple; decay warms up as
min(decay, (1+n)/(10+n)), computed in fp32 as the JAX package computes it.
`params` is a trainer state's tree ({name: tensor}, or a LoRA adapter tree);
the shadow is a tree of new tensors of the same structure, never tracked by
autograd.
"""

from __future__ import annotations

from typing import Tuple

import torch

from stablediffusioneo_tpu_torch.training.lora import tree_map


@torch.no_grad()
def ema_init(params) -> Tuple:
    return (tree_map(lambda p: p.detach().clone(), params), 0)


@torch.no_grad()
def ema_update(ema_state: Tuple, params, decay: float = 0.9999) -> Tuple:
    shadow, n = ema_state
    n = n + 1
    f32 = torch.float32
    d = torch.minimum(torch.tensor(decay, dtype=f32),
                      torch.tensor(1.0 + n, dtype=f32) / torch.tensor(10.0 + n, dtype=f32))
    one_minus = float(torch.tensor(1.0, dtype=f32) - d)
    d = float(d)
    return (tree_map(lambda s, p: s * d + one_minus * p.detach(), shadow, params), n)
