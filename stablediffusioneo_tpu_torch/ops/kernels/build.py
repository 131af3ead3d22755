"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each library is compiled at first use from the `.cu` files under
`stablediffusioneo_tpu_torch/csrc/` into `csrc/build/`, named by a hash of
its sources, the shared headers (`csrc/*.cuh`) and the flags, so an edited
source or header rebuilds and an unchanged one loads the library already
built. The libraries export plain C functions
(no PyTorch headers), which keeps a build to seconds. The libraries every
inference launches (attention, GroupNorm, LayerNorm) are registered, and the
first build of a process builds every one of them that is missing, one nvcc
each, all started together.
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
# the libraries every inference launches, built together with any other that
# has to be built, so that a checkout's first request waits for one nvcc
# rather than one after another ({name: sources}, by `register`)
_TOGETHER: Dict[str, Sequence[str]] = {}
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
    """Where `lib<name>.so` of these sources is built. The headers are hashed
    with the sources (any source may include any of them) but are not nvcc
    inputs: a source finds them beside itself."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / src for src in sources] + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def load_libraries(specs: Dict[str, Sequence[str]]) -> Dict[str, ctypes.CDLL]:
    """Compile the missing libraries of {name: csrc sources}, one nvcc for
    each, all started together, then load every `lib<name>.so`."""
    pending = []
    for name, sources in specs.items():
        if name in _LIBS:
            continue
        out = library_path(name, sources)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *[str(CSRC / s) for s in sources]]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        pending.append((name, out, tmp, time.perf_counter(), proc))
    failed = []
    for name, out, tmp, t0, proc in pending:  # wait for every build
        _, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}:\n{stderr}")
            continue
        build_seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(stderr)  # ptxas -v report
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    for name, sources in specs.items():
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(library_path(name, sources)))
    return {name: _LIBS[name] for name in specs}


def register(name: str, sources: Sequence[str]) -> None:
    """Name a library that the first `load_library` of this process loads,
    building it beside the one asked for where it is missing."""
    _TOGETHER[name] = tuple(sources)


def load_library(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Compile (if needed) and load `lib<name>.so` from csrc sources, and
    with it every registered library; called at every launch, so a loaded
    library returns at once."""
    lib = _LIBS.get(name)
    return lib if lib is not None else load_libraries({**_TOGETHER, name: sources})[name]
