"""The open loop: the arrival schedule drawn from the seed, requests started
at their scheduled times whatever earlier ones are doing, latency taken from
the scheduled arrival, no arrival after the window, an arrival over
`max_outstanding` counted as failed, the entry that takes one caller
refused, and the reader of the batch-cut policy it exercises."""

from __future__ import annotations

import math
import statistics
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).parent))

from benchmark import harness  # noqa: E402
from benchmark import traffic as traffic_mod  # noqa: E402
from benchmark.families import Output, controlnet_sd  # noqa: E402
from tiny import tiny, tiny_traffic  # noqa: E402

OPEN = traffic_mod.load("served-open")


class Fake:
    """An entry that serves one request at a time in `service_s` seconds,
    or that holds every request until `gate` is set."""

    clients_max = None

    def __init__(self, service_s=0.0, gate=None):
        self.service_s, self.gate = service_s, gate
        self.lock = threading.Lock()
        self.starts = []

    def run(self, req):
        with self.lock:
            self.starts.append(time.perf_counter())
            time.sleep(self.service_s)
        if self.gate is not None:
            assert self.gate.wait(timeout=30)
        return Output(np.zeros((1, 1, 3), np.uint8), None, {})


def reqs(n=4):
    return [traffic_mod.Request(i, i, "a b c", None) for i in range(n)]


def test_schedule_is_the_seeds():
    a, b = traffic_mod.arrivals(4.6, 200, 2 ** 33 + 1), traffic_mod.arrivals(4.6, 200, 2 ** 33 + 1)
    c = traffic_mod.arrivals(4.6, 200, 2 ** 33 + 2)
    assert a == b and a != c
    assert len(a) == len(c) == 200
    assert all(0 <= x < y for x, y in zip(a, a[1:])) and a[-1] < 200 / 4.6


def test_gaps_are_exponential_at_the_rate():
    rate, n = 4.6, 2000
    t = traffic_mod.arrivals(rate, n, 2 ** 31 + 11)
    gaps = np.diff([0.0] + t)
    assert abs(gaps.mean() * rate - 1) < 0.05
    assert abs(gaps.std() / gaps.mean() - 1) < 0.1  # exponential: sd = mean; uniform spacing: 0
    assert abs(np.median(gaps) * rate - math.log(2)) < 0.1


def test_latency_runs_from_the_scheduled_arrival():
    """Arrivals at twice what a serial entry serves: each request waits for
    the ones before it, so latency grows through the run, and each record
    starts at its scheduled time, not when a worker took it."""
    entry = Fake(service_s=0.02)
    offsets = traffic_mod.arrivals(100.0, 40, 5)
    records, t_start, t_end = harness.open_loop(entry, reqs(), offsets, max_outstanding=64)
    assert len(records) == 40 and all(r.out is not None for r in records)
    assert sorted(r.t0 - t_start for r in records) == pytest.approx(offsets, abs=1e-9)
    by_arrival = sorted(records, key=lambda r: r.t0)
    lat = [r.t1 - r.t0 for r in by_arrival]
    assert min(lat) >= 0.02
    assert statistics.mean(lat[-10:]) > statistics.mean(lat[:10]) + 0.15
    assert t_end == max(r.t1 for r in records)


def test_nothing_is_sent_after_the_window():
    entry = Fake()
    traffic = dict(OPEN, rate_per_s=50.0, max_outstanding=8)
    records, t_start, _ = harness.drive(entry, reqs(), traffic, seconds=0.5)
    assert len(records) == len(entry.starts) == math.floor(50.0 * 0.5)
    assert max(r.t0 for r in records) < t_start + 0.5
    assert all(r.late_s >= 0 for r in records)


def test_every_run_has_the_traffic_files_schedule():
    """The schedule comes from the file's `arrivals_seed`, not the run's
    seed: two runs offer the same arrivals."""
    traffic = dict(OPEN, rate_per_s=40.0)
    offsets = []
    for _ in range(2):
        records, t_start, _ = harness.drive(Fake(), reqs(), traffic, count=12)
        offsets.append(sorted(r.t0 - t_start for r in records))
    want = traffic_mod.arrivals(40.0, 12, OPEN["arrivals_seed"])
    for got in offsets:
        assert got == pytest.approx(want, abs=1e-9)


def test_an_arrival_over_the_cap_fails():
    gate = threading.Event()
    entry = Fake(gate=gate)
    timer = threading.Timer(0.5, gate.set)
    timer.start()
    try:
        records, _, _ = harness.open_loop(entry, reqs(), [0.0, 0.01, 0.02, 0.03, 0.04], 2)
    finally:
        timer.cancel()
        gate.set()
    assert len(records) == 5
    failed = [r for r in records if r.out is None]
    assert len(failed) == 3 and all(r.t1 == r.t0 for r in failed)
    assert len(entry.starts) == 2


def test_open_loop_refuses_the_single_caller_entry():
    with pytest.raises(ValueError, match="closed loops only"):
        harness.check_loop(dict(OPEN, entry="pipeline"), controlnet_sd.PipelineEntry)
    harness.check_loop(OPEN, controlnet_sd.ServerEntry)
    cfg = tiny("sd15-controlnet-canny")
    traffic = dict(tiny_traffic(OPEN), entry="pipeline")
    with pytest.raises(ValueError, match="closed loops only"):  # before anything is built
        harness.run_cell({}, {"name": "x", "chips": 1}, cfg, traffic, 1, 1.0, False, None, 0.0)
    with pytest.raises(ValueError, match="loop 'burst'"):
        harness.check_loop(dict(OPEN, loop="burst"), controlnet_sd.ServerEntry)


@pytest.mark.parametrize("cuts,share", [({"full": 3, "window": 1}, 25.0),
                                        ({"full": 0, "window": 5}, 100.0),
                                        ({"full": 7, "window": 0}, 0.0),
                                        ({"full": 0, "window": 0}, None), (None, None)])
def test_window_cut_share(cuts, share):
    counters = {} if cuts is None else {"server": {"cuts": cuts}}
    run = harness.Run(cfg={}, traffic={}, setup_s=1.0, window_s=1.0, records=[], failed=0,
                      engines={}, counters=counters, peak_reserved=0)
    assert harness.load_metric("serving.window_cut_share").read(run) == share
