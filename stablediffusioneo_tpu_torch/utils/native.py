"""Build and load the repository's native/ C++ libraries with ctypes
(counterpart of stablediffusioneo_tpu/utils/native.py).

One thread-safe loader a library: `load_native_lib(name, configure)` compiles
`native/<source>` with g++ at first use into
`stablediffusioneo_tpu_torch/csrc/build/`, named by a hash of the source and
the flags (an edited source rebuilds, an unchanged one loads the library
already built), loads it with ctypes, runs the caller's one-time signature
configuration and caches the handle. The JAX package's loader reads
`native/build/` (made by `make -C native`) and returns None when the library
is missing, and its callers fall back to their Python mirrors; this one
builds the library, and a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Optional

NATIVE = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parents[1] / "csrc" / "build"
# library name -> its source under native/
SOURCES = {"sdeo_sched": "scheduler.cpp"}
# native/Makefile's flags without -march=native: a library built on one
# machine may be loaded on another from the same directory
CXX_FLAGS = ("-O3", "-fno-math-errno", "-std=c++17", "-fPIC", "-Wall", "-shared")

_lock = threading.Lock()
_cache: Dict[str, ctypes.CDLL] = {}


def library_path(name: str) -> Path:
    source = NATIVE / SOURCES[name]
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(source.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _build(name: str, out: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError(f"no C++ compiler (g++ or $CXX) to build lib{name}.so")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(NATIVE / SOURCES[name])],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building lib{name}.so failed:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never leaves half a file


def load_native_lib(
    name: str,
    configure: Optional[Callable[[ctypes.CDLL], None]] = None,
) -> ctypes.CDLL:
    """Build (if needed) and load lib<name>.so once (thread-safe).

    `configure` runs exactly once, on the first load: set argtypes and
    restypes there, so that concurrent first callers never see a
    half-configured library."""
    with _lock:
        lib = _cache.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                _build(name, path)
            lib = ctypes.CDLL(str(path))
            if configure is not None:
                configure(lib)
            _cache[name] = lib
        return lib
