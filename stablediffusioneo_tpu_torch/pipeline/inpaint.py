"""Inpainting host-side preprocessing (the port's own copy of
stablediffusioneo_tpu/pipeline/inpaint.py, held to it by
tests/test_torch_checkpoint.py)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from stablediffusioneo_tpu_torch.annotators.util import HWC3


def prepare_inpaint(
    src_img: np.ndarray,
    mask: np.ndarray,
    H: int,
    W: int,
    downsample_factor: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """(source image, mask; nonzero = REGENERATE) ->
    (src (H, W, 3) f32 in [-1, 1], mask (H/f, W/f, 1) f32 in [0, 1]).

    The mask is area-averaged to latent resolution — soft edges survive,
    which is what the blended-latent update expects."""
    import cv2

    src = cv2.resize(HWC3(src_img), (W, H), interpolation=cv2.INTER_AREA)
    src_f = src.astype(np.float32) / 127.5 - 1.0
    m = np.asarray(mask)
    if m.ndim == 3:
        m = m[..., 0]
    m = m.astype(np.float32)
    if m.max() > 1.0:
        m = m / 255.0
    f = downsample_factor
    m = cv2.resize(m, (W // f, H // f),
                   interpolation=cv2.INTER_AREA)[..., None]
    return src_f, m
