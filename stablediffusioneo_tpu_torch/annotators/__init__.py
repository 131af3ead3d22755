"""Annotators of the PyTorch port (counterpart of
stablediffusioneo_tpu/annotators/).

  canny    -> annotators.canny    (cv2; the JAX package's code)
  HED      -> annotators.hed      (ControlNetHED on the device)
  MiDaS    -> annotators.midas    (DPT-L), annotators.midas_hybrid (DPT-hybrid)
  OpenPose -> annotators.openpose (body and hand nets on the device, the JAX
                                   package's numpy decode)
  MLSD     -> annotators.mlsd     (MobileV2-MLSD-Large, annotators.mlsd_net,
                                   on the device; the JAX package's decode)
  UniFormer-> annotators.uniformer (UniFormer-S + UperNet on the device)
plus the image helpers of annotators/util.py and the native preprocessing
library's wrappers (annotators/native.py). The host-side copies are held to
the JAX package's by tests/test_torch_imports.py; the nets by
tests/test_torch_annotators.py and tests/test_torch_mlsd_uniformer.py. The
detectors load lazily, as the JAX package's.
"""

from stablediffusioneo_tpu_torch.annotators.canny import CannyDetector
from stablediffusioneo_tpu_torch.annotators.util import HWC3, resize_image

_LAZY = {
    "HEDdetector": "stablediffusioneo_tpu_torch.annotators.hed",
    "MidasDetector": "stablediffusioneo_tpu_torch.annotators.midas",
    "OpenposeDetector": "stablediffusioneo_tpu_torch.annotators.openpose",
    "MLSDdetector": "stablediffusioneo_tpu_torch.annotators.mlsd",
    "UniformerDetector": "stablediffusioneo_tpu_torch.annotators.uniformer",
}


def __getattr__(name):
    """Lazy detector exports (each pulls its own model module)."""
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(name)


__all__ = ["CannyDetector", "HWC3", "resize_image", "HEDdetector", "MidasDetector",
           "OpenposeDetector", "MLSDdetector", "UniformerDetector"]
