"""MLSD line-segment annotator of the port (counterpart of
stablediffusioneo_tpu/annotators/mlsd.py).

  - `decode_center_and_displacement` and `pred_lines`: the JAX package's
    numpy / cv2 decode, copied as they stand (held to the originals by
    tests/test_torch_imports.py): a sigmoid centre heatmap, 3x3 max-pool
    NMS, the top 200 centres, the 4-channel displacement map, then lines
    over the score and length thresholds rescaled to the image;
  - `TinyMLSD` / `init_tiny_mlsd`: the compact net of the MLSD output
    contract ((N, 4, H, W) -> (N, 16, H/2, W/2)) for flow tests, the JAX
    init_tiny_mlsd / tiny_mlsd_apply;
  - `MLSDdetector` (annotator/mlsd/__init__.py:21-44): white lines on black,
    one uint8 channel.

The detector's net is `model_fn: (N, H, W, 4) float32 numpy -> (N, h, w,
>=5)`, as in the JAX package: given, or the MobileV2-MLSD-Large of
annotators/mlsd_net.py on `params` (a state dict under the upstream names)
or `ckpt_path` (mlsd_large_512_fp32.pth, loaded with strict accounting), or
else the tiny net on seeded weights. The net runs on the detector's device
in the dtype of annotators/_dtype.py; the decode runs on the fp32 map. The
JAX detector's blanket `except Exception: pass` around the net and the
decode is left out: it would hide a device or kernel failure, and an image
with no segment over the thresholds gives the black map without one.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Tuple

import cv2
import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from stablediffusioneo_tpu_torch.annotators._dtype import cast_module, default_device


def decode_center_and_displacement(
    tp_map: np.ndarray, topk: int = 200, ksize: int = 3
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(1, h, w, C>=5) NHWC map -> (pts (k,2) [y,x], scores (k,), disp
    (h, w, 4)). Channel 0 center logit, 1:5 displacement."""
    assert tp_map.shape[0] == 1
    center = tp_map[0, :, :, 0]
    disp = tp_map[0, :, :, 1:5]
    heat = 1.0 / (1.0 + np.exp(-center))
    pad = (ksize - 1) // 2
    padded = np.pad(heat, pad, constant_values=-np.inf)
    windows = np.lib.stride_tricks.sliding_window_view(padded, (ksize, ksize))
    hmax = windows.max(axis=(2, 3))
    heat = np.where(hmax == heat, heat, 0.0).reshape(-1)
    k = min(topk, heat.size)
    idx = np.argpartition(-heat, k - 1)[:k]
    idx = idx[np.argsort(-heat[idx], kind="stable")]
    w = center.shape[1]
    pts = np.stack([idx // w, idx % w], axis=-1)
    return pts, heat[idx], disp


def pred_lines(
    image: np.ndarray,
    model_fn: Callable[[np.ndarray], np.ndarray],
    input_shape=(512, 512),
    score_thr: float = 0.10,
    dist_thr: float = 20.0,
) -> np.ndarray:
    """Run the net + decode into (n, 4) [x0, y0, x1, y1] image-space lines."""
    h, w, _ = image.shape
    h_ratio, w_ratio = h / input_shape[0], w / input_shape[1]
    resized = cv2.resize(
        image, (input_shape[1], input_shape[0]), interpolation=cv2.INTER_AREA
    )
    x = np.concatenate(
        [resized, np.ones([input_shape[0], input_shape[1], 1])], axis=-1
    )[None].astype(np.float32)
    x = x / 127.5 - 1.0
    tp_map = np.asarray(model_fn(x), np.float32)  # (1, h/2, w/2, >=5)
    pts, scores, disp = decode_center_and_displacement(tp_map, 200, 3)
    start = disp[:, :, :2]
    end = disp[:, :, 2:]
    dist_map = np.sqrt(np.sum((start - end) ** 2, axis=-1))

    segments = []
    for (y, x_), score in zip(pts, scores):
        if score > score_thr and dist_map[y, x_] > dist_thr:
            dxs, dys, dxe, dye = disp[y, x_]
            segments.append([x_ + dxs, y + dys, x_ + dxe, y + dye])
    lines = 2.0 * np.asarray(segments, np.float32).reshape(-1, 4)
    lines[:, 0] *= w_ratio
    lines[:, 1] *= h_ratio
    lines[:, 2] *= w_ratio
    lines[:, 3] *= h_ratio
    return lines


# -------------------------------------------------------- the contract net


class TinyMLSD(nn.Module):
    """(N, 4, H, W) -> (N, 16, H/2, W/2) honoring the MLSD output contract
    (a 3x3 stride-2 conv, two 3x3 convs, ReLUs, a 1x1 head)."""

    def __init__(self, width: int = 32):
        super().__init__()
        self.conv1 = nn.Conv2d(4, width, 3, 2, 1)
        self.conv2 = nn.Conv2d(width, width, 3, padding=1)
        self.conv3 = nn.Conv2d(width, width, 3, padding=1)
        self.head = nn.Conv2d(width, 16, 1)

    def forward(self, x):
        h = F.relu(self.conv1(x))
        h = F.relu(self.conv2(h))
        h = F.relu(self.conv3(h))
        return self.head(h)


def init_tiny_mlsd(generator: Optional[torch.Generator] = None, width: int = 32) -> TinyMLSD:
    """The contract net with weights drawn from `generator` (default seed 0)."""
    from stablediffusioneo_tpu_torch.models.cldm import init_weights

    generator = generator or torch.Generator().manual_seed(0)
    with torch.device(generator.device):
        net = TinyMLSD(width)
    init_weights(net, generator)
    return net


def net_model_fn(net: nn.Module, device) -> Callable[[np.ndarray], np.ndarray]:
    """`model_fn` of an MLSD net on `device`: the (N, H, W, 4) fp32 input
    goes up, runs in the net's dtype, and the fp32 (N, h, w, 16) map comes
    down."""
    dtype = next(net.parameters()).dtype

    @torch.no_grad()
    def model_fn(x: np.ndarray) -> np.ndarray:
        t = torch.from_numpy(np.ascontiguousarray(x)).to(device)
        out = net(t.permute(0, 3, 1, 2).to(dtype))
        return out.float().permute(0, 2, 3, 1).cpu().numpy()

    return model_fn


class MLSDdetector:
    """Drop-in MLSDdetector (annotator/mlsd/__init__.py:21-44): uint8 HWC
    image, value and distance thresholds -> uint8 (H, W) line map. See the
    module docstring for model_fn, params and ckpt_path. device: the card
    unless the caller names another."""

    def __init__(self, model_fn: Optional[Callable] = None,
                 ckpt_path: Optional[str] = None, device=None,
                 params: Optional[Mapping] = None):
        self.device = default_device(device)
        self.net = None
        if model_fn is None:
            if params is None and ckpt_path is not None:
                from stablediffusioneo_tpu_torch.checkpoint.torch_reader import (
                    load_torch_state_dict,
                )

                params = load_torch_state_dict(ckpt_path)
            if params is not None:
                from stablediffusioneo_tpu_torch.annotators.mlsd_net import MobileV2MLSDLarge
                from stablediffusioneo_tpu_torch.checkpoint.accounting import load_strict

                net = MobileV2MLSDLarge()
                load_strict(net, params, "mlsd_large")
            else:
                net = init_tiny_mlsd()
            self.net = cast_module(net, self.device)
            model_fn = net_model_fn(self.net, self.device)
        self.model_fn = model_fn

    def __call__(self, input_image: np.ndarray, thr_v: float, thr_d: float
                 ) -> np.ndarray:
        assert input_image.ndim == 3
        img_output = np.zeros_like(input_image)
        lines = pred_lines(
            input_image, self.model_fn,
            (input_image.shape[0], input_image.shape[1]), thr_v, thr_d,
        )
        for x0, y0, x1, y1 in lines.astype(int):
            cv2.line(img_output, (x0, y0), (x1, y1), (255, 255, 255), 1)
        return img_output[:, :, 0]
