"""Misc utilities (counterpart of stablediffusioneo_tpu/utils/misc.py).

- seed_everything: the pytorch-lightning seed_everything the app layer
  calls per request (canny2image_TRT.py:42): seeds Python, numpy and torch,
  and returns a torch.Generator seeded the same (the port's draws take an
  explicit generator, as the JAX package's take a PRNGKey).
- log_txt_as_img: prompt-text rendering for training grids
  (ldm/util.py log_txt_as_img equivalent), the JAX package's code.
- count_params: param census (training/lora.py:count_params).
"""

from __future__ import annotations

import random
from typing import List, Tuple

import numpy as np
import torch

from stablediffusioneo_tpu_torch.training.lora import count_params

__all__ = ["count_params", "log_txt_as_img", "seed_everything"]


def seed_everything(seed: int) -> torch.Generator:
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def log_txt_as_img(wh: Tuple[int, int], captions: List[str]) -> np.ndarray:
    """Render captions onto white canvases -> (B, H, W, 3) uint8."""
    import cv2

    w, h = wh
    out = np.full((len(captions), h, w, 3), 255, np.uint8)
    for i, text in enumerate(captions):
        chars_per_line = max(1, w // 12)
        lines = [
            text[j : j + chars_per_line]
            for j in range(0, len(text), chars_per_line)
        ][: max(1, h // 24)]
        for li, line in enumerate(lines):
            cv2.putText(
                out[i], line, (8, 24 + 24 * li),
                cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 0), 1,
            )
    return out
