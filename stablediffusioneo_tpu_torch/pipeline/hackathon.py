"""`hackathon`: the reference's public surface (counterpart of
stablediffusioneo_tpu/pipeline/hackathon.py).

The reference's entry is a class named `hackathon` with `initialize()` and a
`process()` of 14 positional arguments that returns the generated images
(canny2image_TRT.py:18-92; consumed by compute_score.py:42-61). This wrapper
gives that surface over Canny2ImagePipeline, dropping the detected map that
Canny2ImagePipeline puts first.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from stablediffusioneo_tpu_torch.config import PipelineConfig
from stablediffusioneo_tpu_torch.models.cldm import ControlLDM
from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline


class hackathon:  # noqa: N801, the reference's name
    def __init__(self, model: ControlLDM, tokenizer: Callable,
                 cfg: Optional[PipelineConfig] = None, device="cuda"):
        self._model = model
        self._tokenizer = tokenizer
        self._cfg = cfg
        self._device = device
        self.pipe: Optional[Canny2ImagePipeline] = None

    def initialize(self):
        """Build the pipeline and run its start-up self-test (every engine
        built and run once at 256x256, 1 step)."""
        self.pipe = Canny2ImagePipeline(self._model, self._tokenizer, self._cfg,
                                        device=self._device)
        self.pipe.initialize()

    def process(self, input_image: np.ndarray, prompt: str, a_prompt: str,
                n_prompt: str, num_samples: int, image_resolution: int,
                ddim_steps: int, guess_mode: bool, strength: float, scale: float,
                seed: int, eta: float, low_threshold: int,
                high_threshold: int) -> List[np.ndarray]:
        if self.pipe is None:
            raise RuntimeError("call initialize() first")
        results = self.pipe.process(
            input_image, prompt, a_prompt=a_prompt, n_prompt=n_prompt,
            num_samples=num_samples, image_resolution=image_resolution,
            ddim_steps=ddim_steps, guess_mode=guess_mode, strength=strength,
            scale=scale, seed=seed, eta=eta, low_threshold=low_threshold,
            high_threshold=high_threshold)
        return results[1:]  # the reference returns the generated images only
