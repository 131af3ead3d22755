"""Score harness of the port: perceptual distance and the hackathon score
formula (counterpart of stablediffusioneo_tpu/scoring/score.py, whose code
this is: backend-free, held to the original by tests/test_torch_imports.py).

  - `PD` = L2 between feature vectors of the output and of its golden image
    (compute_score.py:11-17, pytorch_fid's InceptionV3 pool3 activations
    there: scoring/inception.py:InceptionFeatureExtractor here, on a local
    pt_inception / torchvision checkpoint);
  - `get_score(t_ms, pd) = pdFactor * 7000/t_ms` with the piecewise pdFactor
    falloff (compute_score.py:19-38);
  - `PixelFeatureExtractor`: the self-contained default extractor
    (Gaussian-pyramid pixel statistics), monotone in perceptual difference
    for same-pipeline A/B comparisons, not the Inception PD scale;
  - `ScoreHarness`: the compute_score.py:40-73 loop over a process()
    function, fixture images and their goldens.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np


def get_score(t_ms: float, p: float) -> float:
    """Hackathon score formula (compute_score.py:19-38)."""
    t_factor = 7000.0 / t_ms
    if 0 <= p < 4:
        pd_factor = 1.0 - 0.1 * p
    elif 4 <= p < 8:
        pd_factor = 0.6 - 0.0125 * (p - 4)
    elif 8 <= p <= 12:
        pd_factor = 0.55 - 0.1375 * (p - 8)
    else:
        pd_factor = 0.0
    return pd_factor * t_factor


class PixelFeatureExtractor:
    """Self-contained fallback features: multi-scale (Gaussian pyramid)
    mean/std pooled pixel statistics -> fixed-length vector."""

    def __init__(self, levels: int = 4, grid: int = 8):
        self.levels = levels
        self.grid = grid

    def __call__(self, img: np.ndarray) -> np.ndarray:
        import cv2

        x = img.astype(np.float32) / 255.0
        feats: List[np.ndarray] = []
        for _ in range(self.levels):
            h, w = x.shape[:2]
            g = cv2.resize(x, (self.grid, self.grid), interpolation=cv2.INTER_AREA)
            feats.append(g.reshape(-1))
            if min(h, w) <= self.grid:
                break
            x = cv2.pyrDown(x)
        return np.concatenate(feats)


def perceptual_distance(
    base_img: np.ndarray,
    new_img: np.ndarray,
    extractor: Optional[Callable[[np.ndarray], np.ndarray]] = None,
) -> float:
    """L2 between feature activations (PD, compute_score.py:11-17)."""
    extractor = extractor or PixelFeatureExtractor()
    a = np.asarray(extractor(base_img), np.float64)
    b = np.asarray(extractor(new_img), np.float64)
    return float(np.linalg.norm(a - b))


class ScoreHarness:
    """End-to-end scoring loop (compute_score.py:40-73): run the pipeline on
    fixture images, compare to goldens, score latency x fidelity."""

    def __init__(
        self,
        process_fn: Callable[..., List[np.ndarray]],
        extractor: Optional[Callable] = None,
    ):
        self.process_fn = process_fn
        self.extractor = extractor or PixelFeatureExtractor()

    def run(
        self,
        images: List[np.ndarray],
        goldens: List[np.ndarray],
        prompt: str = "a bird",
        ddim_steps: int = 20,
        image_resolution: int = 256,
        seed: int = 2946901,
        scale: float = 9.0,
        strength: float = 1.0,
    ) -> Dict:
        import time

        assert len(images) == len(goldens)
        records = []
        for img, golden in zip(images, goldens):
            t0 = time.perf_counter()
            outs = self.process_fn(
                img,
                prompt,
                num_samples=1,
                image_resolution=image_resolution,
                ddim_steps=ddim_steps,
                strength=strength,
                scale=scale,
                seed=seed,
            )
            t_ms = (time.perf_counter() - t0) * 1e3
            new_img = outs[-1]
            pd = perceptual_distance(golden, new_img, self.extractor)
            records.append(
                {"t_ms": t_ms, "pd": pd, "score": get_score(t_ms, pd)}
            )
        return {
            "records": records,
            "mean_t_ms": float(np.mean([r["t_ms"] for r in records])),
            "mean_pd": float(np.mean([r["pd"] for r in records])),
            "mean_score": float(np.mean([r["score"] for r in records])),
        }
