"""Batch-formation policy (native core + exact Python mirror; counterpart
of stablediffusioneo_tpu/serving/scheduler.py, its functions copied line for
line).

The decision functions live in native/scheduler.cpp (`libsdeo_sched`, built
at first use by utils/native.py and loaded with ctypes). Every function has
a 1:1 Python mirror, reached only with `_force_python=True`: the library is
always there (a failed build raises), so the port never falls back to the
mirror quietly. tests/test_torch_serving.py holds native == mirror, and the
mirror to the JAX package's, over randomized inputs.

Policy (see native/scheduler.cpp for the full rationale):
  * dispatch at the largest engine batch bucket the queue can fill;
  * while the oldest request's batching window (`max_wait_ms`) has time
    left AND a larger bucket is still reachable, hold (throughput);
  * once the window is spent, cut at the largest fillable bucket (latency);
  * across compatibility groups, serve the one with the oldest request
    (starvation-free).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np

from stablediffusioneo_tpu_torch.utils.native import load_native_lib


def _configure(lib: ctypes.CDLL) -> None:
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.sdeo_decide_cut.argtypes = [dp, ctypes.c_int, ip, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_double]
    lib.sdeo_decide_cut.restype = ctypes.c_int
    lib.sdeo_pick_group.argtypes = [dp, ctypes.c_int]
    lib.sdeo_pick_group.restype = ctypes.c_int
    lib.sdeo_next_deadline_ms.argtypes = [dp, ctypes.c_int, ctypes.c_double]
    lib.sdeo_next_deadline_ms.restype = ctypes.c_double


def _load() -> ctypes.CDLL:
    return load_native_lib("sdeo_sched", _configure)


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def decide_cut(
    ages_ms: Sequence[float],
    buckets: Sequence[int],
    max_batch: int,
    max_wait_ms: float,
    _force_python: bool = False,
) -> int:
    """How many requests to dispatch from one compatibility group now.

    ages_ms: waiting times oldest-first. Returns 0 (keep waiting) or a
    batch-bucket size."""
    ages = np.ascontiguousarray(ages_ms, np.float64)
    n = len(ages)
    lib = None if _force_python else _load()
    if lib is not None:
        bk = np.ascontiguousarray(sorted(buckets), np.int32)
        return int(lib.sdeo_decide_cut(
            _dptr(ages), n,
            bk.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(bk),
            int(max_batch), float(max_wait_ms)))
    # Python mirror of sdeo_decide_cut
    if n <= 0 or not buckets:
        return 0
    fillable = [b for b in buckets if b <= n and b <= max_batch]
    if not fillable:
        return 0
    best = max(fillable)
    if best >= max_batch:
        return best
    return best if ages[0] >= max_wait_ms else 0


def pick_group(oldest_ages_ms: Sequence[float],
               _force_python: bool = False) -> int:
    """Index of the compatibility group to serve next (-1 = all empty).
    oldest_ages_ms[k] < 0 marks group k empty."""
    ages = np.ascontiguousarray(oldest_ages_ms, np.float64)
    lib = None if _force_python else _load()
    if lib is not None:
        return int(lib.sdeo_pick_group(_dptr(ages), len(ages)))
    best, best_age = -1, -1.0
    for k, a in enumerate(ages):
        if a >= 0.0 and a > best_age:
            best, best_age = k, a
    return best


def next_deadline_ms(ages_ms: Sequence[float], max_wait_ms: float,
                     _force_python: bool = False) -> float:
    """Remaining batching window of a group's oldest request (ms); -1 when
    the group is empty (no deadline)."""
    ages = np.ascontiguousarray(ages_ms, np.float64)
    lib = None if _force_python else _load()
    if lib is not None:
        return float(lib.sdeo_next_deadline_ms(_dptr(ages), len(ages),
                                               float(max_wait_ms)))
    if len(ages) == 0:
        return -1.0
    return max(0.0, max_wait_ms - float(ages[0]))
