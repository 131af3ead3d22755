"""Host-side annotators of the PyTorch port (cv2 and numpy only).

The port's own copies of the JAX package's `annotators/canny.py` and the
image helpers of `annotators/util.py`; `tests/test_torch_imports.py` holds
them to the same bytes on a seeded image.
"""

from stablediffusioneo_tpu_torch.annotators.canny import CannyDetector
from stablediffusioneo_tpu_torch.annotators.util import HWC3, resize_image

__all__ = ["CannyDetector", "HWC3", "resize_image"]
