"""HED (soft-edge) annotator of the port (counterpart of
stablediffusioneo_tpu/annotators/hed.py).

The reference's ControlNetHED_Apache2 net (annotator/hed/__init__.py:17-81)
under its own names (`norm`, `block{i}.convs.{j}`, `block{i}.projection`;
the 37 keys of ControlNetHED.pth): a VGG-like tower of 5 DoubleConvBlocks
(3x3 conv + ReLU stacks, a 2x2 max-pool before blocks 2-5, floor at odd
sizes as the JAX VALID pool) with a 1x1 single-channel projection a block.
The edge map is sigmoid(mean of the 5 projections bilinearly resized to the
input size).

`HEDdetector` keeps the JAX package's fused epilogue: uint8 pixels go up,
the five side maps are upsampled in fp32 on the device, averaged and
squashed there, and only the one-channel uint8 map comes down.
"""

from __future__ import annotations

from typing import List, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from stablediffusioneo_tpu_torch.annotators._dtype import cast_module, default_device

# (cin, cout, n_convs) a block (hed/__init__.py:40-44)
BLOCKS = ((3, 64, 2), (64, 128, 2), (128, 256, 3), (256, 512, 3), (512, 512, 3))


class DoubleConvBlock(nn.Module):
    def __init__(self, cin: int, cout: int, n: int):
        super().__init__()
        self.convs = nn.Sequential(*[nn.Conv2d(cin if i == 0 else cout, cout, 3, padding=1)
                                     for i in range(n)])
        self.projection = nn.Conv2d(cout, 1, 1)

    def forward(self, h):
        for conv in self.convs:
            h = F.relu(conv(h))
        return h, self.projection(h)


class ControlNetHED(nn.Module):
    """x (N, 3, H, W) raw 0-255 values -> the 5 side maps (N, 1, h_i, w_i)."""

    def __init__(self):
        super().__init__()
        self.norm = nn.Parameter(torch.zeros((1, 3, 1, 1)))
        for i, (cin, cout, n) in enumerate(BLOCKS):
            setattr(self, f"block{i + 1}", DoubleConvBlock(cin, cout, n))

    def init_bare_(self, generator):
        """The parameters init_weights does not reach: `norm` at zero, as
        the JAX init_hed."""
        self.norm.zero_()
        return (self.norm,)

    def forward(self, x) -> List[torch.Tensor]:
        h = x - self.norm.to(x.dtype)
        projections = []
        for i in range(len(BLOCKS)):
            if i:
                h = F.max_pool2d(h, 2, 2)
            h, p = getattr(self, f"block{i + 1}")(h)
            projections.append(p)
        return projections


def init_hed(generator: Optional[torch.Generator] = None) -> ControlNetHED:
    """A ControlNetHED with weights drawn from `generator` (default seed 0),
    on the generator's device."""
    from stablediffusioneo_tpu_torch.models.cldm import init_weights

    generator = generator or torch.Generator().manual_seed(0)
    with torch.device(generator.device):
        net = ControlNetHED()
    init_weights(net, generator)
    return net


def hed_edges(net: ControlNetHED, u8: torch.Tensor) -> torch.Tensor:
    """The fused detector: (1, H, W, 3) uint8 on the net's device -> (H, W)
    uint8. The trunk runs in the net's dtype; the upsample (half-pixel
    bilinear, the JAX resize for upscaling), mean and sigmoid in fp32."""
    dtype = net.norm.dtype
    h, w = u8.shape[1:3]
    edges = net(u8.permute(0, 3, 1, 2).to(dtype))
    ups = [F.interpolate(e.float(), size=(h, w), mode="bilinear", align_corners=False)
           for e in edges]
    edge = torch.sigmoid(torch.stack(ups).mean(dim=0))[0, 0]
    return (edge * 255.0).clamp(0, 255).to(torch.uint8)


class HEDdetector:
    """Drop-in HEDdetector (hed/__init__.py:57-81): uint8 HWC image in, uint8
    edge map out. params: a state dict under the upstream names (e.g.
    checkpoint/convert.py:annotator_state_dict_from_jax("hed", tree));
    ckpt_path: ControlNetHED.pth, read by checkpoint/torch_reader.py; neither:
    seeded weights (seed 0). device: the card unless the caller names
    another; the dtype follows annotators/_dtype.py."""

    def __init__(self, params: Optional[Mapping] = None, ckpt_path: Optional[str] = None,
                 device=None):
        from stablediffusioneo_tpu_torch.checkpoint.accounting import load_strict
        from stablediffusioneo_tpu_torch.checkpoint.torch_reader import load_torch_state_dict

        self.device = default_device(device)
        if params is None and ckpt_path is not None:
            params = load_torch_state_dict(ckpt_path)
        if params is None:
            net = init_hed()
        else:
            net = ControlNetHED()
            load_strict(net, params, "hed")
        self.net = cast_module(net, self.device)

    @torch.no_grad()
    def __call__(self, input_image: np.ndarray) -> np.ndarray:
        assert input_image.ndim == 3
        u8 = torch.from_numpy(np.ascontiguousarray(input_image[None])).to(self.device)
        return hed_edges(self.net, u8).cpu().numpy()
