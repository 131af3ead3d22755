"""MobileV2-MLSD-Large of the port (counterpart of
stablediffusioneo_tpu/annotators/mlsd_net.py).

The JAX package's network as an nn.Module under the upstream names of
`mlsd_large_512_fp32.pth` (the 344 keys of the `mlsd_large` universe):
  * `backbone.features.{0..13}`: torchvision's MobileNetV2 layout on a
    4-channel input (RGB and a plane of ones). features.0 is Conv+BN+ReLU6
    (stride 2); features.1-13 are inverted residuals, `.conv` holding the
    1x1 expansion (Conv+BN+ReLU6, absent where t = 1), the 3x3 depthwise
    conv (Conv+BN+ReLU6) and the 1x1 projection (Conv, BN), with the
    residual where the stride is 1 and the width is kept. The features
    after modules 1, 3, 6, 10 and 13 feed the decoder;
  * `block{15,17,19,21}` (type A): 1x1 Conv+BN+ReLU on the deeper input
    (`conv1`) and on the shallower tap (`conv2`), the first upsampled 2x
    (half-pixel bilinear, the JAX resize) except in block 15, concatenated;
  * `block{16,18,20,22}` (type B): 3x3 Conv+BN+ReLU, then 3x3 Conv+BN;
  * `block23` (type C): a 3x3 conv dilated by 5 (padding 5) +BN+ReLU, a
    3x3 Conv+BN+ReLU and a 1x1 conv with bias to the 16-channel tpMap at
    half the input's size.
Every conv before a BatchNorm has no bias, as upstream. The BatchNorms are
nn.BatchNorm2d in eval mode; the JAX converter folds them into the convs,
and checkpoint/convert.py:annotator_state_dict_from_jax carries a folded
tree back as identity BatchNorms (weight 1, the folded shift as bias, mean
0, variance 1 - eps). The paddings are the JAX package's (symmetric 1 at
stride 2): the wiring follows it, as its docstring says it follows the
public mlsd repository.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

# MobileNetV2 inverted-residual table: (expand t, out c, repeats n, stride s)
_MBV2_CFG = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
]
# feature modules whose outputs feed the decoder (c1 16@/2, c2 24@/4, c3 32@/8,
# c4 64@/16, c5 96@/16)
_TAPS = (1, 3, 6, 10, 13)
STEM = 32
DECODER = 64


def _conv_bn_relu(cin, cout, k=3, stride=1, groups=1, padding=None, dilation=1, act=nn.ReLU6):
    """Sequential(Conv (no bias), BN, activation): torchvision's ConvBNReLU."""
    padding = (k - 1) // 2 if padding is None else padding
    return nn.Sequential(nn.Conv2d(cin, cout, k, stride, padding, dilation=dilation,
                                   groups=groups, bias=False),
                         nn.BatchNorm2d(cout), act())


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, t: int):
        super().__init__()
        hidden = cin * t
        layers = [_conv_bn_relu(cin, hidden, 1)] if t != 1 else []
        layers += [_conv_bn_relu(hidden, hidden, 3, stride, groups=hidden),
                   nn.Conv2d(hidden, cout, 1, bias=False), nn.BatchNorm2d(cout)]
        self.conv = nn.Sequential(*layers)
        self.residual = stride == 1 and cin == cout

    def forward(self, x):
        h = self.conv(x)
        return x + h if self.residual else h


class MobileNetV2(nn.Module):
    def __init__(self):
        super().__init__()
        features: List[nn.Module] = [_conv_bn_relu(4, STEM, 3, 2)]
        cin = STEM
        for t, c, n, s in _MBV2_CFG:
            for i in range(n):
                features.append(InvertedResidual(cin, c, s if i == 0 else 1, t))
                cin = c
        self.features = nn.Sequential(*features)

    def forward(self, x) -> List[torch.Tensor]:
        taps = []
        for i, f in enumerate(self.features):
            x = f(x)
            if i in _TAPS:
                taps.append(x)
        return taps


class BlockTypeA(nn.Module):
    def __init__(self, in_shallow: int, in_deep: int, upscale: bool = True):
        super().__init__()
        self.conv1 = _conv_bn_relu(in_deep, DECODER, 1, act=nn.ReLU)
        self.conv2 = _conv_bn_relu(in_shallow, DECODER, 1, act=nn.ReLU)
        self.upscale = upscale

    def forward(self, shallow, deep):
        a = self.conv1(deep)
        b = self.conv2(shallow)
        if self.upscale:
            a = F.interpolate(a, scale_factor=2.0, mode="bilinear", align_corners=False)
        return torch.cat([a, b], dim=1)


class BlockTypeB(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = _conv_bn_relu(2 * DECODER, DECODER, 3, act=nn.ReLU)
        self.conv2 = nn.Sequential(nn.Conv2d(DECODER, DECODER, 3, padding=1, bias=False),
                                   nn.BatchNorm2d(DECODER))

    def forward(self, x):
        return self.conv2(self.conv1(x))


class BlockTypeC(nn.Module):
    def __init__(self, out: int = 16):
        super().__init__()
        self.conv1 = _conv_bn_relu(DECODER, DECODER, 3, padding=5, dilation=5, act=nn.ReLU)
        self.conv2 = _conv_bn_relu(DECODER, DECODER, 3, act=nn.ReLU)
        self.conv3 = nn.Conv2d(DECODER, out, 1)

    def forward(self, x):
        return self.conv3(self.conv2(self.conv1(x)))


class MobileV2MLSDLarge(nn.Module):
    """x (N, 4, H, W) in [-1, 1] -> tpMap (N, 16, H/2, W/2)."""

    def __init__(self):
        super().__init__()
        self.backbone = MobileNetV2()
        widths = [c for _, c, _, _ in _MBV2_CFG]  # c1..c5: 16, 24, 32, 64, 96
        self.block15 = BlockTypeA(widths[3], widths[4], upscale=False)
        self.block16 = BlockTypeB()
        self.block17 = BlockTypeA(widths[2], DECODER)
        self.block18 = BlockTypeB()
        self.block19 = BlockTypeA(widths[1], DECODER)
        self.block20 = BlockTypeB()
        self.block21 = BlockTypeA(widths[0], DECODER)
        self.block22 = BlockTypeB()
        self.block23 = BlockTypeC()

    def forward(self, x):
        c1, c2, c3, c4, c5 = self.backbone(x)
        h = self.block16(self.block15(c4, c5))  # both /16
        h = self.block18(self.block17(c3, h))   # -> /8
        h = self.block20(self.block19(c2, h))   # -> /4
        h = self.block22(self.block21(c1, h))   # -> /2
        return self.block23(h)


def init_mlsd_large(generator: Optional[torch.Generator] = None) -> MobileV2MLSDLarge:
    """A MobileV2-MLSD-Large with weights drawn from `generator` (default
    seed 0; BatchNorms at identity), on the generator's device."""
    from stablediffusioneo_tpu_torch.models.cldm import init_weights

    generator = generator or torch.Generator().manual_seed(0)
    with torch.device(generator.device):
        net = MobileV2MLSDLarge()
    init_weights(net, generator)
    return net
