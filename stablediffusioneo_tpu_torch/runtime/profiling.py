"""Profiling and timing helpers (counterpart of
stablediffusioneo_tpu/runtime/profiling.py).

  - `trace(dir)`: a torch.profiler trace of the enclosed block (CPU and,
    where there is one, CUDA activity), exported as a Chrome trace;
  - `timed(fn)`: the median seconds of a call, device-synchronised;
  - `device_memory_stats()`: the card's allocator counters under the JAX
    package's keys;
  - the span recorder: `span(name, ...)` around a phase, `record(...)` of a
    phase timed elsewhere, read back with `spans()`; `clear()`,
    `set_tracing(on)`. The pipeline's `last_timings`, the server's
    `ServerStats` timings and the benchmark's per-layer spans are computed
    from these spans.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

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


# ------------------------------------------------------------------- spans

SPAN_BUFFER = 16384  # spans kept in memory; the oldest are dropped first


class Span:
    """One phase: `name`, host start and end `t0` / `t1` on
    time.perf_counter() (the clock of the benchmark's request records), its
    own `id` and its `parent`'s (None at a root), the request ids it serves
    (`requests`, a tuple; a nested span takes its parent's), `attrs`, and
    `device_ms`: with a CUDA device, the device time between two timing
    events recorded on the current stream at entry and exit, None until the
    end event has completed (and without a device). `children`: the spans
    opened inside this one on its thread (None when there are none).

    Entered on a thread, a span nests under the span open there. While a
    torch profiler is active it also opens a profiler range of its name on
    the host timeline, beside the ops and on the device trace's clock. The
    range is a plain function range (`_RecordFunctionFast`), not a user
    annotation, since the profiler draws a user annotation a second time as
    a device range, which a reader of the device intervals would count as
    device work. Another thread's profiler sees the range when the profiler
    records all threads (`_ExperimentalConfig(profile_all_threads=True)`).
    No event is recorded while the stream is being captured into a graph,
    and nothing here waits for the device: a device time is read only once
    its end event has completed (`resolve`)."""

    __slots__ = ("name", "id", "parent", "requests", "attrs", "t0", "t1", "device_ms",
                 "children", "_rec", "_up", "_dev", "_start", "_end", "_rf")

    def __init__(self, rec: "SpanRecorder", name: str, requests, device, parent, attrs):
        self.name, self.requests, self.parent, self.attrs = name, requests, parent, attrs
        self.id = next(rec._ids)
        self.t0 = self.t1 = self.device_ms = None
        self.children = self._up = self._start = self._end = self._rf = None
        self._rec = rec
        self._dev = device if device is not None and device.type == "cuda" else None

    @property
    def ms(self) -> float:
        """Host milliseconds from start to end."""
        return (self.t1 - self.t0) * 1e3

    @property
    def end_event(self):
        """The CUDA event recorded at exit (None without one, or once the
        device time is resolved): the point after the span's device work on
        its stream."""
        return self._end

    def __enter__(self) -> "Span":
        self.t0 = time.perf_counter()
        stack = self._rec._stack()
        if stack:
            up = stack[-1]
            if self.parent is None:
                self.parent, self._up = up.id, up
            if self.requests is None:
                self.requests = up.requests
        stack.append(self)
        if torch.autograd.profiler._is_profiler_enabled:
            self._rf = torch._C._profiler._RecordFunctionFast(self.name)
            self._rf.__enter__()
        if self._dev is not None and not torch.cuda.is_current_stream_capturing():
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(torch.cuda.current_stream(self._dev))
        return self

    def __exit__(self, *exc) -> bool:
        if self._start is not None:
            if torch.cuda.is_current_stream_capturing():
                self._start = None
            else:
                self._end = torch.cuda.Event(enable_timing=True)
                self._end.record(torch.cuda.current_stream(self._dev))
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        self._rec._stack().pop()
        self.t1 = time.perf_counter()
        if self._up is not None:
            if self._up.children is None:
                self._up.children = []
            self._up.children.append(self)
            self._up = None
        self._rec._buf.append(self)
        return False

    def resolve(self) -> Optional[float]:
        """The device milliseconds once the end event has completed (an event
        query: this never waits); None before, and without a device."""
        start, end = self._start, self._end
        if end is not None and end.query():
            self.device_ms = start.elapsed_time(end)
            self._start = self._end = None
        return self.device_ms


class _NullSpan:
    """What `span` returns with tracing off: a context that records nothing."""

    __slots__ = ()
    end_event = None

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False


NULL_SPAN = _NullSpan()


class SpanRecorder:
    """A bounded in-memory buffer of spans (the newest `capacity`), their
    ids and the open spans of each thread. On by default."""

    def __init__(self, capacity: int = SPAN_BUFFER):
        self.on = True
        self._buf: "collections.deque[Span]" = collections.deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._local = threading.local()

    def _stack(self) -> List[Span]:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def span(self, name: str, requests: Optional[Sequence[int]] = None, device=None,
             parent: Optional[int] = None, attrs: Optional[Dict[str, Any]] = None):
        """A context around one phase (see Span). device: the torch.device
        whose current stream times the phase (a CUDA device; anything else
        records host times only). parent: the id of a span not open on this
        thread (one recorded later, on another thread). With tracing off,
        one flag check that returns the shared NULL_SPAN."""
        if not self.on:
            return NULL_SPAN
        return Span(self, name, requests, device, parent, attrs)

    def record(self, name: str, t0: float, t1: float,
               requests: Optional[Sequence[int]] = None, parent: Optional[int] = None,
               id: Optional[int] = None, device_ms: Optional[float] = None) -> Optional[Span]:
        """Record a phase timed elsewhere (a wait, a phase derived from
        others, or one seen end to end by another thread); `id` one taken
        earlier with `new_id()`, for children recorded first. None with
        tracing off."""
        if not self.on:
            return None
        sp = Span(self, name, requests, None, parent, None)
        if id is not None:
            sp.id = id
        sp.t0, sp.t1, sp.device_ms = t0, t1, device_ms
        self._buf.append(sp)
        return sp

    def new_id(self) -> int:
        """A fresh span id: for a span recorded later (`record(id=)`), or as
        a request id."""
        return next(self._ids)

    def spans(self) -> List[Span]:
        """The buffer's spans, oldest first, each device time resolved where
        its end event has completed."""
        out = list(self._buf)
        for sp in out:
            if sp._end is not None:
                sp.resolve()
        return out

    def clear(self) -> None:
        self._buf.clear()


RECORDER = SpanRecorder()


# the process's recorder
span = RECORDER.span
record = RECORDER.record
new_id = RECORDER.new_id
spans = RECORDER.spans
clear = RECORDER.clear


def set_tracing(on: bool) -> None:
    """Turn the process's span recorder on (the default) or off."""
    RECORDER.on = bool(on)


def resolve(root: Span) -> None:
    """Resolve the device times of `root` and of every span opened inside
    it. Call it on a thread that has waited for the spans' stream (their end
    events have completed); it only queries."""
    todo = [root]
    while todo:
        sp = todo.pop()
        sp.resolve()
        todo.extend(sp.children or ())
