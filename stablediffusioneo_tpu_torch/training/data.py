"""Training data pipeline: fill50k-style (source, target, prompt) triplets
(counterpart of stablediffusioneo_tpu/training/data.py, whose functions
these are, apart from the library loader and the adapter's device side).

The reference trains through torch's C++-backed DataLoader over the
upstream ControlNet tutorial dataset (prompt.json lines with
`{"source": ..., "target": ..., "prompt": ...}` PNG pairs). Here, as in the
JAX package: a C++ prefetching loader (native/loader.cpp, libpng/libjpeg
decode + half-pixel bilinear resize + bounded in-order reorder buffer)
delivering uint8 batches; normalization happens on the device, the same
uint8-upload discipline as the inference engines. The port builds the
library itself at first use (utils/native.py, with libpng and libjpeg
linked), and `backend="native"` raises where the build fails. A pure-Python
(PIL) path implements the identical contract; tests hold the two to equal
bytes.

`controlnet_batches` adapts raw (hint, target, prompt) batches into the
`{x0, hint, ctx}` dict `training.loop.train` consumes: CLIP-encode the
prompts and VAE-encode the targets on the device, where the latents and
contexts stay.
"""

from __future__ import annotations

import ctypes
import json
import os
from typing import Callable, Dict, Iterator, List, Sequence, Tuple

import numpy as np

from stablediffusioneo_tpu_torch.utils.native import load_native_lib


def _configure(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.sdeo_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
    ]
    lib.sdeo_loader_create.restype = ctypes.c_void_p
    lib.sdeo_loader_next.argtypes = [ctypes.c_void_p, u8p, u8p, i32p]
    lib.sdeo_loader_next.restype = ctypes.c_longlong
    lib.sdeo_loader_error_count.argtypes = [ctypes.c_void_p]
    lib.sdeo_loader_error_count.restype = ctypes.c_longlong
    lib.sdeo_loader_destroy.argtypes = [ctypes.c_void_p]


def _load_lib():
    """The loader library, built at first use; raises where it does not
    build (no g++, libpng or libjpeg)."""
    return load_native_lib("sdeo_loader", _configure)


def native_available() -> bool:
    """Whether the loader library builds and loads here."""
    try:
        _load_lib()
    except (RuntimeError, OSError):
        return False
    return True


def read_prompt_json(root: str) -> Tuple[List[str], List[str], List[str]]:
    """Parse fill50k `prompt.json` (JSON lines) under `root`; returns
    (source_paths, target_paths, prompts) with paths resolved to root."""
    src, tgt, prompts = [], [], []
    with open(os.path.join(root, "prompt.json")) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            src.append(os.path.join(root, rec["source"]))
            tgt.append(os.path.join(root, rec["target"]))
            prompts.append(rec["prompt"])
    return src, tgt, prompts


def _epoch_perm(n: int, epoch: int, seed: int, shuffle: bool) -> np.ndarray:
    if not shuffle:
        return np.arange(n, dtype=np.int32)
    # mirrors loader.cpp: std::mt19937(seed + epoch * 2654435761) shuffle —
    # NOT bit-compatible with numpy's shuffle, so deterministic-order tests
    # run with shuffle=False; shuffled runs only need a valid permutation.
    rng = np.random.default_rng(seed + epoch * 2654435761 % (2 ** 63))
    return rng.permutation(n).astype(np.int32)


class ImagePairLoader:
    """Batched (source, target) image loader: uint8 (B, H, W, 3) pairs plus
    the per-sample dataset indices (for prompt lookup).

    backend="native" uses the C++ prefetcher (built at first use; a failed
    build raises); "python" is the in-process PIL path; "auto" picks native
    where the library builds. Both decode with identical semantics; the
    native path additionally overlaps decode of the next `prefetch_depth`
    batches with consumer work.
    """

    def __init__(
        self,
        src_paths: Sequence[str],
        tgt_paths: Sequence[str],
        batch: int,
        resolution: int,
        shuffle: bool = True,
        seed: int = 0,
        threads: int = 4,
        prefetch_depth: int = 4,
        backend: str = "auto",
    ):
        assert len(src_paths) == len(tgt_paths) and src_paths
        self.src_paths = [str(p) for p in src_paths]
        self.tgt_paths = [str(p) for p in tgt_paths]
        self.batch = int(batch)
        self.res = int(resolution)
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self._pos = 0  # python-backend global sample position
        self._py_errors = 0  # python-backend decode failures (zero-filled)
        self._perm_cache: Tuple[int, np.ndarray] = (-1, None)
        if backend == "auto":
            backend = "native" if native_available() else "python"
        self.backend = backend
        self._handle = None
        if backend == "native":
            lib = _load_lib()
            n = len(self.src_paths)
            c_src = (ctypes.c_char_p * n)(
                *[p.encode() for p in self.src_paths])
            c_tgt = (ctypes.c_char_p * n)(
                *[p.encode() for p in self.tgt_paths])
            self._c_src, self._c_tgt = c_src, c_tgt  # keep alive
            self._handle = lib.sdeo_loader_create(
                c_src, c_tgt, n, self.batch, self.res, self.res,
                1 if self.shuffle else 0, self.seed, int(threads),
                int(prefetch_depth))
            if not self._handle:
                raise RuntimeError("sdeo_loader_create failed")

    # ------------------------------------------------------------------ api

    def next(self) -> Dict[str, np.ndarray]:
        """Blocking: returns {"source": u8 (B,R,R,3), "target": u8,
        "indices": i32 (B,)} — an infinite epoch-reshuffled stream."""
        if self.backend == "native":
            lib = _load_lib()
            src = np.empty((self.batch, self.res, self.res, 3), np.uint8)
            tgt = np.empty((self.batch, self.res, self.res, 3), np.uint8)
            idx = np.empty((self.batch,), np.int32)
            rc = lib.sdeo_loader_next(
                self._handle,
                src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                tgt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            if rc < 0:  # destroy() raced the wait: buffers are untouched
                raise RuntimeError("loader closed while waiting for a batch")
            return {"source": src, "target": tgt, "indices": idx}
        return self._next_python()

    def _next_python(self) -> Dict[str, np.ndarray]:
        n = len(self.src_paths)
        src = np.empty((self.batch, self.res, self.res, 3), np.uint8)
        tgt = np.empty((self.batch, self.res, self.res, 3), np.uint8)
        idx = np.empty((self.batch,), np.int32)
        for b in range(self.batch):
            pos = self._pos + b
            epoch = pos // n
            if self._perm_cache[0] != epoch:  # once per epoch, not sample
                self._perm_cache = (
                    epoch, _epoch_perm(n, epoch, self.seed, self.shuffle))
            si = int(self._perm_cache[1][pos % n])
            idx[b] = si
            src[b] = self._decode_py(self.src_paths[si])
            tgt[b] = self._decode_py(self.tgt_paths[si])
        self._pos += self.batch
        return {"source": src, "target": tgt, "indices": idx}

    def _decode_py(self, path: str) -> np.ndarray:
        from PIL import Image

        try:
            img = np.asarray(Image.open(path).convert("RGB"))
        except Exception:  # noqa: BLE001 — mirror native: zero-fill + count
            self._py_errors += 1
            return np.zeros((self.res, self.res, 3), np.uint8)
        if img.shape[:2] != (self.res, self.res):
            import cv2

            # cv2.INTER_LINEAR == loader.cpp's half-pixel bilinear
            img = cv2.resize(img, (self.res, self.res),
                             interpolation=cv2.INTER_LINEAR)
        return img

    def error_count(self) -> int:
        if self.backend == "native" and self._handle:
            return int(_load_lib().sdeo_loader_error_count(self._handle))
        return self._py_errors

    def close(self):
        if self.backend == "native" and self._handle:
            _load_lib().sdeo_loader_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def fill50k_loader(root: str, batch: int, resolution: int,
                   **kwargs) -> Tuple[ImagePairLoader, List[str]]:
    """Loader + prompt table for a fill50k-layout dataset directory."""
    src, tgt, prompts = read_prompt_json(root)
    return ImagePairLoader(src, tgt, batch, resolution, **kwargs), prompts


def controlnet_batches(
    loader: ImagePairLoader,
    prompts: List[str],
    tokenizer: Callable[[List[str]], np.ndarray],
    encode_text: Callable,
    encode_image: Callable,
) -> Iterator[Dict]:
    """Adapt raw image batches to train()'s {x0, hint, ctx} contract.

    encode_text: token ids (B, T) -> context (B, T, C) (CLIP tower).
    encode_image: uint8 target (B, H, W, 3) + step -> scaled latents
    (B, H/8, W/8, 4) (VAE encode, sampled posterior). Both typically run on
    the device (CNSDRuntime.encode_prompt / encode_image), and their
    tensors stay there (the JAX adapter fetches them to the host; train()
    puts every batch on the device either way). The hint stays uint8 on the
    host: the train step normalizes it on the device."""
    step = 0
    while True:
        raw = loader.next()
        ids = np.asarray(tokenizer([prompts[i] for i in raw["indices"]]))
        yield {
            "x0": encode_image(raw["target"], step),
            "hint": raw["source"],
            "ctx": encode_text(ids),
        }
        step += 1
