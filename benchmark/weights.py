"""Seeded weights under the checkpoint's key names, drawn on the device in
a few large calls, in the type the program serves them in.

The rule is the port's seeded initialiser's (`models/cldm.py:init_weights`),
restated here so that the benchmark, not the program, owns it: every conv
and linear weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the convs a
fresh net zero-initialises included (a trained net has non-zero weights
there, so a dropped ControlNet or residual branch shows in the output);
OpenCLIP's packed q/k/v the same with fan_in = width; norms weight 1, bias 0;
token embeddings N(0, 0.02), position embeddings N(0, 0.01), text_projection
N(0, 1/width). One uniform and one normal draw cover every leaf; each leaf
is a scaled slice of them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn as nn


def leaf_rules(module: nn.Module) -> List[Tuple[str, str, float]]:
    """(key, kind, scale) of every parameter in state-dict order: kind
    "uniform" (scale = bound), "normal" (scale = std), "one" or "zero"."""
    rules = {}
    for name, m in module.named_modules():
        pre = name + "." if name else ""
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            bound = m.weight[0].numel() ** -0.5
            for p in ("weight", "bias"):
                if getattr(m, p) is not None:
                    rules[pre + p] = ("uniform", bound)
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            rules[pre + "weight"] = ("one", 0.0)
            rules[pre + "bias"] = ("zero", 0.0)
        elif isinstance(m, nn.Embedding):
            rules[pre + "weight"] = ("normal", 0.01 if name.endswith("position_embedding")
                                     else 0.02)
        for pname, p in m.named_parameters(recurse=False):
            key = pre + pname
            if key in rules:
                continue
            if pname == "in_proj_weight" or pname == "in_proj_bias":
                rules[key] = ("uniform", m.in_proj_weight.shape[1] ** -0.5)
            elif pname == "positional_embedding":
                rules[key] = ("normal", 0.01)
            elif pname == "text_projection":
                rules[key] = ("normal", p.shape[0] ** -0.5)
    keys = [k for k, _ in module.named_parameters()]
    missing = [k for k in keys if k not in rules]
    if missing:
        raise RuntimeError(f"no initialisation rule for {missing[:8]}")
    return [(k, *rules[k]) for k in keys]


@torch.no_grad()
def draw_state_dict(module: nn.Module, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """The checkpoint of `module`'s structure (it may live on the meta
    device) drawn from `seed` on `device` in `dtype`: the same seed gives the
    same values on the same device."""
    shapes = {k: p.shape for k, p in module.named_parameters()}
    rules = leaf_rules(module)
    g = torch.Generator(device=device).manual_seed(int(seed))
    n_uni = sum(shapes[k].numel() for k, kind, _ in rules if kind == "uniform")
    n_norm = sum(shapes[k].numel() for k, kind, _ in rules if kind == "normal")
    uni = torch.rand(n_uni, generator=g, device=device, dtype=dtype).mul_(2).sub_(1)
    norm = torch.randn(n_norm, generator=g, device=device, dtype=dtype)
    out, offs = {}, {"uniform": 0, "normal": 0}
    for key, kind, scale in rules:
        shape = shapes[key]
        if kind in offs:
            flat = uni if kind == "uniform" else norm
            o = offs[kind]
            out[key] = flat[o:o + shape.numel()].view(shape).mul_(scale)
            offs[kind] = o + shape.numel()
        else:
            out[key] = torch.full(shape, 1.0 if kind == "one" else 0.0, device=device,
                                  dtype=dtype)
    return out
