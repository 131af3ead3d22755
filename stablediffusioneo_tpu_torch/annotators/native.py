"""ctypes bindings for the native preprocessing library, native/preproc.cpp
(counterpart of stablediffusioneo_tpu/annotators/native.py).

The library covers the host side of the annotator layer: HWC3, the bilinear
resize, RGB to gray and Canny. It is built by the port's own loader
(utils/native.py: g++ at first use into stablediffusioneo_tpu_torch/csrc/
build/, never `make -C native`), and a failed build raises there. The
wrappers keep the JAX package's signatures; unlike its wrappers they have no
cv2 fallback, so a missing or broken library shows at the first call.
"""

from __future__ import annotations

import ctypes

import numpy as np

from stablediffusioneo_tpu_torch.utils.native import load_native_lib

_U8P = ctypes.POINTER(ctypes.c_uint8)


def _configure(lib: ctypes.CDLL) -> None:
    lib.sdeo_hwc3.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8P]
    lib.sdeo_resize_bilinear.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                         _U8P, ctypes.c_int, ctypes.c_int]
    lib.sdeo_canny.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, ctypes.c_double,
                               ctypes.c_double, _U8P]
    lib.sdeo_gaussian5.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, _U8P]
    lib.sdeo_rgb2gray.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, _U8P]
    for fn in (lib.sdeo_hwc3, lib.sdeo_resize_bilinear, lib.sdeo_canny,
               lib.sdeo_gaussian5, lib.sdeo_rgb2gray):
        fn.restype = ctypes.c_int


def _lib() -> ctypes.CDLL:
    return load_native_lib("sdeo_preproc", _configure)


def native_available() -> bool:
    """Whether the library builds and loads here (a g++ and the source)."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


def _u8(x: np.ndarray):
    return x.ctypes.data_as(_U8P)


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} failed (return code {rc})")


def hwc3(x: np.ndarray) -> np.ndarray:
    """Any uint8 image -> (H, W, 3) uint8 (annotators/util.py:HWC3)."""
    if x.ndim == 2:
        x = x[:, :, None]
    h, w, c = x.shape
    x = np.ascontiguousarray(x)
    out = np.empty((h, w, 3), np.uint8)
    _check(_lib().sdeo_hwc3(_u8(x), h, w, c, _u8(out)), "sdeo_hwc3")
    return out


def resize_bilinear(x: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """uint8 (H, W[, C]) -> (dh, dw[, C]), cv2.INTER_LINEAR's arithmetic."""
    squeeze = x.ndim == 2
    if squeeze:
        x = x[:, :, None]
    h, w, c = x.shape
    x = np.ascontiguousarray(x)
    out = np.empty((dh, dw, c), np.uint8)
    _check(_lib().sdeo_resize_bilinear(_u8(x), h, w, c, _u8(out), dh, dw),
           "sdeo_resize_bilinear")
    return out[:, :, 0] if squeeze else out


def rgb2gray(x: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) RGB -> (H, W) gray, cv2.COLOR_RGB2GRAY's weights."""
    h, w, _ = x.shape
    x = np.ascontiguousarray(x)
    out = np.empty((h, w), np.uint8)
    _check(_lib().sdeo_rgb2gray(_u8(x), h, w, _u8(out)), "sdeo_rgb2gray")
    return out


def canny(img: np.ndarray, low: float, high: float) -> np.ndarray:
    """Canny edges on uint8 gray or RGB (H,W[,3]) -> uint8 {0,255}."""
    gray = rgb2gray(img) if img.ndim == 3 else img
    h, w = gray.shape
    gray = np.ascontiguousarray(gray)
    out = np.empty((h, w), np.uint8)
    _check(_lib().sdeo_canny(_u8(gray), h, w, float(low), float(high), _u8(out)),
           "sdeo_canny")
    return out
