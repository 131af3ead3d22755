"""Annotators of the PyTorch port (counterpart of
stablediffusioneo_tpu/annotators/).

  canny    -> annotators.canny    (cv2; the JAX package's code)
  HED      -> annotators.hed      (ControlNetHED on the device)
  MiDaS    -> annotators.midas    (DPT-L), annotators.midas_hybrid (DPT-hybrid)
  OpenPose -> annotators.openpose (body and hand nets on the device, the JAX
                                   package's numpy decode)
plus the image helpers of annotators/util.py. The host-side copies are held
to the JAX package's by tests/test_torch_imports.py; the nets by
tests/test_torch_annotators.py. The detectors load lazily, as the JAX
package's. MLSD and UniFormer are not ported yet (ROADMAP.md, queue 1
item 5): their names raise NotImplementedError.
"""

from stablediffusioneo_tpu_torch.annotators.canny import CannyDetector
from stablediffusioneo_tpu_torch.annotators.util import HWC3, resize_image

_LAZY = {
    "HEDdetector": "stablediffusioneo_tpu_torch.annotators.hed",
    "MidasDetector": "stablediffusioneo_tpu_torch.annotators.midas",
    "OpenposeDetector": "stablediffusioneo_tpu_torch.annotators.openpose",
}
_NOT_PORTED = ("MLSDdetector", "UniformerDetector")


def __getattr__(name):
    """Lazy detector exports (each pulls its own model module)."""
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"{name} is not ported to the PyTorch package yet: ROADMAP.md, queue 1 "
            "item 5 (MLSD and UniFormer)")
    raise AttributeError(name)


__all__ = ["CannyDetector", "HWC3", "resize_image", "HEDdetector", "MidasDetector",
           "OpenposeDetector"]
