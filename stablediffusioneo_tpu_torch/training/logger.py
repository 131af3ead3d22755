"""Training image logger + metrics logging (counterpart of
stablediffusioneo_tpu/training/logger.py, whose code this is, function by
function, apart from the rank test).

The reference's PL `ImageLogger` callback (cldm/logger.py:11-77): every N
steps, render current-model samples for a fixed batch into an image_log/
directory grid, rank-zero only. Here it is a plain callable hook driven by
the train loop (no Lightning), with the grid assembly in numpy. The port
trains in one process; a process of a torch.distributed group logs only at
rank 0.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np


def make_grid(images: np.ndarray, cols: int = 4, pad: int = 2) -> np.ndarray:
    """(N, H, W, C) uint8 -> single grid image."""
    n, h, w, c = images.shape
    cols = min(cols, n)
    rows = -(-n // cols)
    grid = np.zeros(
        (rows * (h + pad) - pad, cols * (w + pad) - pad, c), np.uint8
    )
    for i in range(n):
        r, cc = divmod(i, cols)
        grid[r * (h + pad) : r * (h + pad) + h, cc * (w + pad) : cc * (w + pad) + w] = images[i]
    return grid


class ImageLogger:
    """Periodic sample-grid dumper (cldm/logger.py:11-77 equivalent)."""

    def __init__(
        self,
        log_dir: str = "image_log",
        every_n_steps: int = 300,
        max_images: int = 4,
        sample_fn: Optional[Callable[[], np.ndarray]] = None,
    ):
        self.log_dir = log_dir
        self.every_n_steps = every_n_steps
        self.max_images = max_images
        self.sample_fn = sample_fn

    def _rank_zero(self) -> bool:
        import torch.distributed as dist

        return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0

    def on_step(self, step: int, split: str = "train") -> Optional[str]:
        if step % self.every_n_steps or not self._rank_zero():
            return None
        if self.sample_fn is None:
            return None
        images = np.asarray(self.sample_fn())[: self.max_images]
        grid = make_grid(images)
        os.makedirs(os.path.join(self.log_dir, split), exist_ok=True)
        path = os.path.join(
            self.log_dir, split, f"samples_step-{step:09d}.png"
        )
        try:
            from PIL import Image

            Image.fromarray(grid.squeeze()).save(path)
        except ImportError:
            import cv2

            cv2.imwrite(path, grid[..., ::-1])
        return path


class MetricsLogger:
    """JSONL metrics stream (the print-based logging of the reference,
    upgraded to a parseable format)."""

    def __init__(self, path: str = "train_metrics.jsonl"):
        self.path = path
        self._t0 = time.time()

    def log(self, step: int, **metrics: float) -> None:
        rec = {"step": int(step), "t": round(time.time() - self._t0, 3)}
        rec.update({k: float(v) for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
