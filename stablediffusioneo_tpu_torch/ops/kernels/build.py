"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each library is compiled at first use from the `.cu` files under
`stablediffusioneo_tpu_torch/csrc/` into `csrc/build/`, named by a hash of
its sources and flags, so an edited source rebuilds and an unchanged one
loads the library already built. The libraries export plain C functions
(no PyTorch headers), which keeps a build to seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
# seconds each library took to compile in this process (absent when loaded
# from an earlier build)
build_seconds: Dict[str, float] = {}


def find_nvcc() -> str:
    candidates = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                               "bin", "nvcc"), shutil.which("nvcc")]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def library_path(name: str, sources: Sequence[str]) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def load_library(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Compile (if needed) and load `lib<name>.so` from csrc sources."""
    if name in _LIBS:
        return _LIBS[name]
    out = library_path(name, sources)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *[str(CSRC / s) for s in sources]]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{res.stderr}")
        build_seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(res.stderr)  # ptxas -v report
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    _LIBS[name] = ctypes.CDLL(str(out))
    return _LIBS[name]

