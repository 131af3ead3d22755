"""Shared annotator utilities (reference annotator/util.py:9-38).

`resize_image` rounds H and W to multiples of 64, so that the latent side
(H / 8) is a multiple of the UNet's three stride-2 stages.
"""

from __future__ import annotations

import cv2
import numpy as np


def HWC3(x: np.ndarray) -> np.ndarray:
    """Any uint8 image -> (H, W, 3) uint8. Gray is broadcast; alpha is
    composited over white (annotator/util.py:9-25)."""
    assert x.dtype == np.uint8
    if x.ndim == 2:
        x = x[:, :, None]
    assert x.ndim == 3
    h, w, c = x.shape
    assert c in (1, 3, 4)
    if c == 3:
        return x
    if c == 1:
        return np.concatenate([x, x, x], axis=2)
    color = x[:, :, 0:3].astype(np.float32)
    alpha = x[:, :, 3:4].astype(np.float32) / 255.0
    y = color * alpha + 255.0 * (1.0 - alpha)
    return y.clip(0, 255).astype(np.uint8)


def resize_image(input_image: np.ndarray, resolution: int) -> np.ndarray:
    """Resize so the SHORT side is `resolution`, then round H,W to
    multiples of 64 (annotator/util.py:28-38)."""
    h, w = input_image.shape[:2]
    k = float(resolution) / min(h, w)
    new_h = float(h) * k
    new_w = float(w) * k
    new_h = int(np.round(new_h / 64.0)) * 64
    new_w = int(np.round(new_w / 64.0)) * 64
    interp = cv2.INTER_LANCZOS4 if k > 1 else cv2.INTER_AREA
    return cv2.resize(input_image, (new_w, new_h), interpolation=interp)
