"""The per-layer metrics that read the program's spans, on synthetic spans
and counters: the window filter leaves out the warm-up's spans and the
traced segment's after the window, the text encoder's engine is the text's,
the served readers take the server's tallies, and every reader returns None
where the program records nothing (as at a commit without the recorder)."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from stablediffusioneo_tpu_torch.runtime import profiling  # noqa: E402

NEW = ("serving.dispatch_ms", "serving.behind_ms", "runtime.engine_device_ms",
       "pipeline.text_device_ms", "pipeline.host_gap_ms")


def read(name, run):
    return harness.load_metric(name).read(run)


def make_run(records, counters=None):
    return harness.Run(cfg={}, traffic={}, setup_s=1.0, window_s=2.0,
                       records=[harness.Record(None, t0, t1, object()) for t0, t1 in records],
                       failed=0, engines={}, counters=counters or {}, peak_reserved=0)


def request(t0, text_ms, engine_ms):
    """One request's spans from t0 (seconds): its text encoding (with the
    text encoder's engine inside) and the sample+decode engine."""
    root = profiling.record("pipeline.request", t0, t0 + 0.5)
    text = profiling.record("text.encode", t0 + 0.01, t0 + 0.02, parent=root.id,
                            device_ms=text_ms)
    profiling.record("runtime.engine", t0 + 0.011, t0 + 0.019, parent=text.id,
                     device_ms=text_ms / 2)
    profiling.record("runtime.engine", t0 + 0.02, t0 + 0.4, parent=root.id,
                     device_ms=engine_ms)


@pytest.fixture
def recorded():
    profiling.clear()
    request(5.0, 99.0, 999.0)    # warm-up
    request(10.0, 2.0, 300.0)    # the window: two requests
    request(11.0, 3.0, 310.0)
    request(20.0, 99.0, 999.0)   # the traced segment after the window
    yield make_run([(10.0, 10.5), (11.0, 11.5)])
    profiling.clear()


def test_single_cell_readers_keep_the_windows_spans(recorded):
    assert read("runtime.engine_device_ms", recorded) == pytest.approx(305.0)
    assert read("pipeline.text_device_ms", recorded) == pytest.approx(2.5)
    # 500 ms a request less its outermost device spans (text, engine)
    assert read("pipeline.host_gap_ms", recorded) == pytest.approx((198.0 + 187.0) / 2)
    assert read("serving.dispatch_ms", recorded) is None
    assert read("serving.behind_ms", recorded) is None


def test_served_readers_take_the_servers_tallies():
    def tally(count, mean_ms, mean_device_ms):
        return {"count": count, "mean_ms": mean_ms,
                "device_count": count if mean_device_ms is not None else 0,
                "mean_device_ms": mean_device_ms}

    server = {"rows": 8, "spans": {
        "serving.dispatch": tally(2, 5.0, 900.0), "serving.behind": tally(2, 700.0, None),
        "runtime.engine": tally(2, 1.0, 1000.0), "text.encode": tally(2, 3.0, 4.0)}}
    run = make_run([(0.0, 1.0)], {"server": server})
    assert read("serving.dispatch_ms", run) == 5.0
    assert read("serving.behind_ms", run) == 700.0
    assert read("runtime.engine_device_ms", run) == pytest.approx(2000.0 / 8)
    assert read("pipeline.text_device_ms", run) == pytest.approx(8.0 / 8)


@pytest.mark.parametrize("case", ["no spans", "no records", "no recorder",
                                  "server without spans"])
def test_readers_return_none_where_nothing_is_recorded(case, monkeypatch):
    profiling.clear()
    counters = {"server": {"rows": 4, "mean_queue_ms": 1.0}} if "server" in case else None
    run = make_run([] if case == "no records" else [(0.0, 1.0)], counters)
    if case == "no recorder":
        request(0.1, 1.0, 2.0)
        monkeypatch.delattr(profiling, "spans")
    try:
        assert {name: read(name, run) for name in NEW} == dict.fromkeys(NEW)
    finally:
        profiling.clear()
