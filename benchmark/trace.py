"""One torch.profiler trace of a traced segment, reduced to what the
per-layer metrics and the ledger's `breakdown` read: the device's busy time
(the union of kernel, copy and memset intervals) within the segment's wall
window, the device time by kernel name, and the idle gaps, each named by
what the host was doing (the innermost host event that covers the gap's
middle: the benchmark's own `bench.*` spans, the program's ops, CUDA
runtime calls)."""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch


@dataclass
class Trace:
    window_s: float
    busy_s: float
    by_name: Dict[str, float] = field(default_factory=dict)   # device seconds by kernel
    gaps: List[Tuple[str, float]] = field(default_factory=list)  # longest idle gaps

    def family_s(self, marks) -> float:
        """Device seconds of the kernels whose names hold one of `marks`."""
        return sum(s for n, s in self.by_name.items() if any(m in n for m in marks))

    def breakdown(self, n=10):
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in self.gaps[:n]]}


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_events(device, host, window, n_gaps=10) -> Trace:
    """device, host: (name, start_us, end_us) triples; window: (start_us,
    end_us) of the segment."""
    w0, w1 = window
    by_name = defaultdict(float)
    clipped = []
    for name, a, b in device:
        by_name[name] += (b - a) / 1e6
        a, b = max(a, w0), min(b, w1)
        if b > a:
            clipped.append((a, b))
    busy = _union(clipped)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    longest = sorted(((b - a, a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a),
                     reverse=True)[:n_gaps]
    gaps = []
    for length, a, b in longest:
        mid = (a + b) / 2
        covering = [(e - s, n) for n, s, e in host if s <= mid <= e]
        gaps.append((min(covering)[1] if covering else "host: none", length / 1e6))
    return Trace(window_s=(w1 - w0) / 1e6, busy_s=sum(b - a for a, b in busy) / 1e6,
                 by_name=dict(by_name), gaps=gaps)


def traced(fn, attempts=4) -> Trace:
    """Run fn() (which ends synchronised) under torch.profiler inside a
    `bench.segment` span. The profiler now and then returns a trace without
    device events; such a trace is taken again after a pause, and where
    every attempt comes back empty the result is None."""
    from torch.profiler import ProfilerActivity, profile, record_function

    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("bench.segment"):
                fn()
                torch.cuda.synchronize()
        device, host, window = [], [], None
        for e in prof.events():
            a, b = e.time_range.start, e.time_range.end
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if not e.name.startswith("bench."):  # an annotation's device range
                    device.append((e.name, a, b))
            else:
                host.append((e.name, a, b))
                if e.name == "bench.segment":
                    window = (a, b)
        if device and window is not None:
            return reduce_events(device, host, window)
        time.sleep(0.5 * (attempt + 1))
    return None
