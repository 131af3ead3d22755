"""Canny edge annotator (reference annotator/canny/__init__.py:4-6)."""

from __future__ import annotations

import cv2
import numpy as np


class CannyDetector:
    def __call__(
        self, img: np.ndarray, low_threshold: int, high_threshold: int
    ) -> np.ndarray:
        return cv2.Canny(img, low_threshold, high_threshold)
