"""YOLOv5 detector of the port (counterpart of stablediffusioneo_tpu/yolo/
model.py).

YOLOv5s (v6.0 scaling: depth 0.33, width 0.50) as an nn.Module under the
upstream `model.{i}.` names, the key set the JAX convert_yolov5 reads: Conv
blocks (`conv` without bias, `bn` with eps 1e-3, SiLU; padding (k - 1) // 2,
so the 6x6 stem pads 2), C3 blocks (`cv1`, `cv2`, `cv3`, bottlenecks
`m.{j}.cv1` 1x1 / `m.{j}.cv2` 3x3, with the shortcut in the backbone and
without it in the head), SPPF (`model.9`: three chained 5x5 max pools) and
the Detect convs `model.24.m.{0,1,2}` (with bias). Modules 11, 12, 15, 16,
19 and 22 (nearest 2x upsamples and concatenations) hold no weights. The
BatchNorms are ops/layers.py:FrozenBatchNorm2d (no num_batches_tracked; an
upstream file's counters and its Detect `anchors` buffer are documented
leftovers, YOLO_LEFTOVERS).

`yolov5_apply` decodes the boxes in fp32 with the JAX package's grid and
anchor arithmetic, rows ordered (level, y, x, anchor) as its NHWC reshape:
    xy = (2 * sigmoid(txy) - 0.5 + grid) * stride
    wh = (2 * sigmoid(twh))^2 * anchor
`yolov5_detect` is the deployment entry: the uint8 letterboxed image goes
up, /255 on the device, and only the top-k rows by objectness (torch.topk,
descending) come back, (N, k, 85) fp32, for yolo/pipeline.py:PostProcessor.
`load_yolov5` and `init_yolov5` follow the detectors' device and dtype
policy (annotators/_dtype.py): the card in bf16 unless the caller names
another device or dtype, fp32 on the CPU.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from stablediffusioneo_tpu_torch.annotators._dtype import cast_module, default_device
from stablediffusioneo_tpu_torch.ops.layers import FrozenBatchNorm2d

DEPTH, WIDTH = 0.33, 0.50
ANCHORS = (
    ((10, 13), (16, 30), (33, 23)),
    ((30, 61), (62, 45), (59, 119)),
    ((116, 90), (156, 198), (373, 326)),
)
STRIDES = (8, 16, 32)
BN_EPS = 1e-3
# an upstream model.state_dict()'s keys that convert_yolov5 does not read
YOLO_LEFTOVERS = (r".*\.num_batches_tracked", r"model\.24\.anchors")


def _d(n: int) -> int:
    return max(round(n * DEPTH), 1)


def _w(c: int) -> int:
    return int(math.ceil(c * WIDTH / 8) * 8)


class Conv(nn.Module):
    """conv (no bias) + BatchNorm (eps 1e-3) + SiLU, padding (k - 1) // 2."""

    def __init__(self, cin: int, cout: int, k: int = 1, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride, (k - 1) // 2, bias=False)
        self.bn = FrozenBatchNorm2d(cout, BN_EPS)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, c: int, shortcut: bool):
        super().__init__()
        self.cv1 = Conv(c, c, 1)
        self.cv2 = Conv(c, c, 3)
        self.shortcut = shortcut

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.shortcut else y


class C3(nn.Module):
    def __init__(self, cin: int, cout: int, n: int, shortcut: bool = True):
        super().__init__()
        ch = cout // 2
        self.cv1 = Conv(cin, ch, 1)
        self.cv2 = Conv(cin, ch, 1)
        self.cv3 = Conv(2 * ch, cout, 1)
        self.m = nn.Sequential(*[Bottleneck(ch, shortcut) for _ in range(n)])

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], dim=1))


class SPPF(nn.Module):
    def __init__(self, cin: int, cout: int, k: int = 5):
        super().__init__()
        self.cv1 = Conv(cin, cin // 2, 1)
        self.cv2 = Conv(cin * 2, cout, 1)
        self.k = k

    def forward(self, x):
        x = self.cv1(x)
        pools = [x]
        for _ in range(3):
            pools.append(F.max_pool2d(pools[-1], self.k, 1, self.k // 2))
        return self.cv2(torch.cat(pools, dim=1))


class Detect(nn.Module):
    def __init__(self, channels, num_classes: int):
        super().__init__()
        self.m = nn.ModuleList([nn.Conv2d(c, 3 * (num_classes + 5), 1) for c in channels])


def _upsample2(x):
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


class YOLOv5(nn.Module):
    """x (N, 3, H, W) in [0, 1] (H, W multiples of 32) -> the three Detect
    convs' raw maps, (N, 3 * (5 + nc), H / s, W / s) for s = 8, 16, 32."""

    def __init__(self, num_classes: int = 80):
        super().__init__()
        self.num_classes = num_classes
        c1, c2, c3, c4, c5 = _w(64), _w(128), _w(256), _w(512), _w(1024)
        layers = {
            0: Conv(3, c1, 6, 2), 1: Conv(c1, c2, 3, 2), 2: C3(c2, c2, _d(3)),
            3: Conv(c2, c3, 3, 2), 4: C3(c3, c3, _d(6)),
            5: Conv(c3, c4, 3, 2), 6: C3(c4, c4, _d(9)),
            7: Conv(c4, c5, 3, 2), 8: C3(c5, c5, _d(3)), 9: SPPF(c5, c5),
            10: Conv(c5, c4, 1), 13: C3(c5, c4, _d(3), False),
            14: Conv(c4, c3, 1), 17: C3(c4, c3, _d(3), False),
            18: Conv(c3, c3, 3, 2), 20: C3(c4, c4, _d(3), False),
            21: Conv(c4, c4, 3, 2), 23: C3(c5, c5, _d(3), False),
            24: Detect((c3, c4, c5), num_classes),
        }
        # the weightless modules keep their upstream indices free
        self.model = nn.ModuleList([layers.get(i, nn.Identity()) for i in range(25)])

    def forward(self, x):
        m = self.model
        p3 = m[4](m[3](m[2](m[1](m[0](x)))))
        p4 = m[6](m[5](p3))
        p5 = m[9](m[8](m[7](p4)))
        t10 = m[10](p5)
        h13 = m[13](torch.cat([_upsample2(t10), p4], dim=1))
        t14 = m[14](h13)
        out3 = m[17](torch.cat([_upsample2(t14), p3], dim=1))              # /8
        out4 = m[20](torch.cat([m[18](out3), t14], dim=1))                  # /16
        out5 = m[23](torch.cat([m[21](out4), t10], dim=1))                  # /32
        return [conv(f) for conv, f in zip(m[24].m, (out3, out4, out5))]


def yolov5_apply(net: YOLOv5, x: torch.Tensor) -> torch.Tensor:
    """x (N, 3, H, W) in [0, 1], in the net's dtype -> (N, anchors, 5 + nc)
    decoded predictions, fp32."""
    nc = net.num_classes
    preds = []
    for li, raw in enumerate(net(x)):
        n, _, gh, gw = raw.shape
        sig = torch.sigmoid(raw.float().permute(0, 2, 3, 1).reshape(n, gh, gw, 3, 5 + nc))
        gy, gx = torch.meshgrid(torch.arange(gh, dtype=torch.float32, device=x.device),
                                torch.arange(gw, dtype=torch.float32, device=x.device),
                                indexing="ij")
        grid = torch.stack([gx, gy], dim=-1)[None, :, :, None, :]  # (1, gh, gw, 1, 2)
        anchors = torch.tensor(ANCHORS[li], dtype=torch.float32, device=x.device)
        xy = (sig[..., 0:2] * 2.0 - 0.5 + grid) * float(STRIDES[li])
        wh = torch.square(sig[..., 2:4] * 2.0) * anchors
        pred = torch.cat([xy, wh, sig[..., 4:]], dim=-1)
        preds.append(pred.reshape(n, gh * gw * 3, 5 + nc))
    return torch.cat(preds, dim=1)


@torch.no_grad()
def yolov5_detect(net: YOLOv5, img_u8: torch.Tensor, k: int = 300) -> torch.Tensor:
    """Deployment entry: (N, H, W, 3) uint8 letterboxed image on the net's
    device -> (N, k, 5 + nc) fp32, the top-k rows by objectness in
    descending order (torch.topk), for PostProcessor unchanged."""
    dtype = next(net.parameters()).dtype
    x = (img_u8.float() / 255.0).permute(0, 3, 1, 2).to(dtype)
    pred = yolov5_apply(net, x)
    idx = torch.topk(pred[..., 4], k, dim=1).indices
    return torch.gather(pred, 1, idx[..., None].expand(-1, -1, pred.shape[-1]))


def init_yolov5(seed: int = 0, num_classes: int = 80, device=None, dtype=None) -> YOLOv5:
    """YOLOv5s with weights drawn on the CPU from a generator seeded by `seed`
    (the same draws for every device; BatchNorms at identity), eval mode, on
    `device` (the card unless the caller names another) in `dtype` (default:
    annotators/_dtype.py's policy, bf16 on the card and fp32 on the CPU)."""
    from stablediffusioneo_tpu_torch.models.cldm import init_weights

    net = YOLOv5(num_classes)
    init_weights(net, torch.Generator().manual_seed(seed))
    return cast_module(net, default_device(device), dtype)


def load_yolov5(params=None, ckpt_path: Optional[str] = None, num_classes: int = 80,
                device=None, dtype=None) -> YOLOv5:
    """YOLOv5s from a state dict under the upstream names (`params`) or a file
    (`ckpt_path`, an upstream model.state_dict() export), with strict
    accounting (YOLO_LEFTOVERS ignored); eval mode, on `device` (the card
    unless the caller names another) in `dtype` (default: annotators/
    _dtype.py's policy, bf16 on the card and fp32 on the CPU; the decode of
    yolov5_apply stays fp32 either way)."""
    from stablediffusioneo_tpu_torch.checkpoint.accounting import load_strict
    from stablediffusioneo_tpu_torch.checkpoint.torch_reader import load_torch_state_dict

    if params is None:
        if ckpt_path is None:
            raise ValueError("load_yolov5 needs params or ckpt_path")
        params = load_torch_state_dict(ckpt_path)
    net = YOLOv5(num_classes)
    load_strict(net, params, "yolov5", ignore=YOLO_LEFTOVERS)
    return cast_module(net, default_device(device), dtype)
