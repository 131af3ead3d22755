"""Scoring harness of the port (counterpart of stablediffusioneo_tpu/scoring/;
the reference's compute_score.py): the score formula, the perceptual
distance, its two feature extractors and the harness loop."""

from stablediffusioneo_tpu_torch.scoring.inception import InceptionFeatureExtractor
from stablediffusioneo_tpu_torch.scoring.score import (
    PixelFeatureExtractor,
    ScoreHarness,
    get_score,
    perceptual_distance,
)

__all__ = [
    "get_score",
    "perceptual_distance",
    "PixelFeatureExtractor",
    "ScoreHarness",
    "InceptionFeatureExtractor",
]
