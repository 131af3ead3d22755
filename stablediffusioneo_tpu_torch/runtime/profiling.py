"""Profiling and timing helpers (counterpart of
stablediffusioneo_tpu/runtime/profiling.py).

  - `trace(dir)`: a torch.profiler trace of the enclosed block (CPU and,
    where there is one, CUDA activity), exported as a Chrome trace;
  - `timed(fn)`: the median seconds of a call, device-synchronised;
  - `device_memory_stats()`: the card's allocator counters under the JAX
    package's keys.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict, Tuple

import torch


@contextlib.contextmanager
def trace(log_dir: str = "sdeo_trace"):
    """Profile the enclosed block with torch.profiler; the trace goes to
    `log_dir`/trace.json (Chrome trace format). Yields the profiler (its
    key_averages() tables the ops)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _first_tensor(result):
    if isinstance(result, torch.Tensor):
        return result
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (list, tuple)):
        for r in result:
            t = _first_tensor(r)
            if t is not None:
                return t
    return None


def _hard_sync(result) -> None:
    """A device barrier that provably completes: one scalar of the result
    copied to the host (the JAX package's device->host fetch; the copy
    waits for the work that made the tensor, on its stream)."""
    t = _first_tensor(result)
    if t is not None and t.numel():
        t.reshape(-1)[:1].cpu()


def timed(fn: Callable, *args, iters: int = 1, warmup: int = 1, **kwargs
          ) -> Tuple[float, Any]:
    """Median wall-clock seconds per call (device-synchronised) and the last
    result."""
    result = None
    for _ in range(warmup):
        result = fn(*args, **kwargs)
    _hard_sync(result)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        _hard_sync(result)
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2], result


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """{device: {bytes_in_use, peak_bytes_in_use, bytes_limit}} of every
    visible card, from torch.cuda.memory_stats (allocated bytes, their
    peak) and the card's total memory; {} without CUDA."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out
