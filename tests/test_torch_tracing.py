"""The port's span recorder (runtime/profiling.py) on the CPU: nesting and
parent ids, the bounded buffer, tracing off, many threads at once, the
pipeline's `last_timings` from its spans, one served request's id through
prep -> queue -> dispatch -> fetch with the parts adding up to the request,
and the profiler's trace holding the spans of the server's own threads."""

import sys
import threading

import numpy as np
import pytest
import torch

from stablediffusioneo_tpu_torch.runtime import profiling
from stablediffusioneo_tpu_torch.runtime.engine import Engine

from test_torch_serving import RES, STEPS, _canny_image, _req, port_pipe, tiny_server  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture
def tracing_off():
    profiling.set_tracing(False)
    try:
        yield
    finally:
        profiling.set_tracing(True)


def _by_name(spans):
    out = {}
    for sp in spans:
        out.setdefault(sp.name, []).append(sp)
    return out


def test_spans_nest_under_the_open_span_and_take_its_requests():
    rec = profiling.SpanRecorder()
    with rec.span("outer", requests=(7, 8), attrs={"k": 1}) as outer:
        with rec.span("inner") as inner:
            with rec.span("leaf", requests=(9,)) as leaf:
                pass
        with rec.span("second") as second:
            pass
    late = rec.record("derived", outer.t0, inner.t1, parent=outer.id, device_ms=2.5)
    assert outer.parent is None and outer.attrs == {"k": 1}
    assert inner.parent == outer.id and second.parent == outer.id and leaf.parent == inner.id
    assert inner.requests == (7, 8) and leaf.requests == (9,)
    assert outer.children == [inner, second] and inner.children == [leaf]
    assert leaf.children is None and late.device_ms == 2.5 and late.parent == outer.id
    assert len({outer.id, inner.id, leaf.id, second.id, late.id}) == 5
    assert outer.t0 <= inner.t0 <= leaf.t0 <= leaf.t1 <= inner.t1 <= second.t0
    assert second.t1 <= outer.t1 and outer.ms >= inner.ms >= 0
    # spans land in the buffer as they end, oldest first
    assert [sp.name for sp in rec.spans()] == ["leaf", "inner", "second", "outer", "derived"]
    assert all(sp.device_ms is None for sp in (outer, inner, leaf))  # no device here
    rec.clear()
    assert rec.spans() == []


def test_an_explicit_parent_wins_over_the_open_span():
    rec = profiling.SpanRecorder()
    root = rec.new_id()
    with rec.span("open"):
        with rec.span("child", requests=(3,), parent=root) as child:
            pass
    assert child.parent == root and child.requests == (3,)


def test_the_buffer_keeps_the_newest_spans():
    rec = profiling.SpanRecorder(capacity=3)
    for i in range(5):
        with rec.span(f"s{i}"):
            pass
    rec.record("r", 0.0, 1.0)
    assert [sp.name for sp in rec.spans()] == ["s3", "s4", "r"]


def test_tracing_off_records_nothing(tracing_off, port_pipe):  # noqa: F811
    profiling.clear()
    assert not profiling.RECORDER.on
    cm = profiling.span("x", requests=(1,), device=torch.device("cpu"))
    assert cm is profiling.NULL_SPAN and not cm and cm.end_event is None
    with cm as sp:
        assert sp is profiling.NULL_SPAN
    assert profiling.record("y", 0.0, 1.0) is None
    out = port_pipe.process(_canny_image(5), "a bird", num_samples=1,
                            image_resolution=RES, ddim_steps=STEPS, seed=5)
    assert out[1].shape == (RES, RES, 3)
    assert port_pipe.last_timings == {} and profiling.spans() == []


def test_many_threads_record_their_own_nesting():
    """More threads than cores, a short switch interval: every span is kept
    and every inner span's parent is the outer span of its own thread."""
    rec = profiling.SpanRecorder()
    threads_n, per_thread = 16, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(k):
        for i in range(per_thread):
            with rec.span("outer", requests=(k,)):
                with rec.span("inner"):
                    pass

    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    spans = rec.spans()
    by_id = {sp.id: sp for sp in spans}
    assert len(spans) == len(by_id) == 2 * threads_n * per_thread
    inner = [sp for sp in spans if sp.name == "inner"]
    assert all(by_id[sp.parent].name == "outer" and by_id[sp.parent].requests == sp.requests
               and by_id[sp.parent].t0 <= sp.t0 <= sp.t1 <= by_id[sp.parent].t1
               for sp in inner)


def test_engine_call_is_a_runtime_engine_span():
    eng = Engine(lambda x: x * 2.0, name="double")
    profiling.clear()
    eng(torch.ones(3, 2))
    (sp,) = profiling.spans()
    assert sp.name == "runtime.engine" and sp.attrs == {"engine": "double", "batch": 3}


def test_last_timings_come_from_the_requests_spans(port_pipe):  # noqa: F811
    profiling.clear()
    port_pipe.process(_canny_image(6), "a bird", num_samples=1, image_resolution=RES,
                      ddim_steps=STEPS, seed=6)
    spans = profiling.spans()
    (req,) = _by_name(spans)["pipeline.request"]
    names = [sp.name for sp in req.children]
    assert names == ["pipeline.preprocess", "text.encode", "runtime.engine", "pipeline.fetch"]
    text = req.children[1]
    assert [sp.name for sp in text.children] == ["runtime.engine"]  # the text encoder's
    assert {sp.requests for sp in spans} == {req.requests} and len(req.requests) == 1
    t = port_pipe.last_timings
    assert list(t) == ["preprocess_ms", "clip_ms", "sample_decode_fetch_ms", "total_ms"]
    fetch = req.children[-1]
    assert t["total_ms"] == pytest.approx((fetch.t1 - req.t0) * 1e3)
    assert t["total_ms"] <= req.ms
    assert t["preprocess_ms"] == req.children[0].ms
    assert t["clip_ms"] == pytest.approx((text.t1 - req.children[0].t1) * 1e3)
    assert t["preprocess_ms"] + t["clip_ms"] + t["sample_decode_fetch_ms"] <= t["total_ms"]


def test_one_request_id_through_the_server_and_the_parts_add_up(tiny_server):  # noqa: F811
    server, _ = tiny_server
    server.drain(timeout=120)
    server.stats.reset()
    profiling.clear()
    server.submit(_req(70)).result(timeout=120)
    server.drain(timeout=120)
    spans = profiling.spans()
    (req,) = _by_name(spans)["serving.request"]
    rid = req.requests
    mine = _by_name([sp for sp in spans if sp.requests == rid])
    (prep,), (queue,), (disp,), (fetch,) = (mine[n] for n in (
        "serving.prep", "serving.queue", "serving.dispatch", "serving.fetch"))
    assert rid == (req.id,)  # the request id is its root span's
    assert req.parent is None and prep.parent == req.id and queue.parent == req.id
    assert disp.parent is None and fetch.parent == disp.id
    assert disp.attrs == {"batch": 1}
    # the dispatch's own work carries the request id too
    assert [sp.name for sp in disp.children] == ["text.encode", "runtime.engine"]
    assert all(sp.requests == rid for sp in disp.children)
    assert "serving.behind" not in mine  # no device, no device start
    assert req.t0 <= prep.t0 <= prep.t1 <= queue.t0 <= queue.t1 <= disp.t0
    assert disp.t1 <= fetch.t0 <= fetch.t1 <= req.t1
    parts = prep.ms + queue.ms + disp.ms + fetch.ms
    assert abs(req.ms - parts) <= max(0.01 * req.ms, 2.0), (req.ms, parts)
    st = server.stats.snapshot()
    assert st["cuts"] == {"full": 0, "window": 1}  # a lone request waits out the window
    assert st["spans"]["serving.request"]["mean_ms"] == pytest.approx(req.ms)
    assert st["spans"]["runtime.engine"]["count"] == 1  # the dispatch's, not CLIP's
    assert st["spans"]["serving.dispatch"]["mean_device_ms"] is None


def test_server_stats_keep_their_counts_with_tracing_off(tiny_server, tracing_off):  # noqa: F811
    server, _ = tiny_server
    server.drain(timeout=120)
    server.stats.reset()
    futures = [server.submit(_req(80 + i)) for i in range(3)]
    for f in futures:
        f.result(timeout=120)
    server.drain(timeout=120)
    st = server.stats.snapshot()
    assert st["rows"] == 3 and st["mean_queue_ms"] > 0 and st["spans"] == {}
    assert sum(st["cuts"].values()) == st["batches"]


def test_profiler_trace_holds_the_server_threads_spans(tiny_server):  # noqa: F811
    """With the profiler recording every thread, the dispatcher's and the
    pipeline's spans are host ranges of the trace, and none is a user
    annotation (which the profiler would draw as a device range too)."""
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    server, _ = tiny_server
    server.drain(timeout=120)
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        server.submit(_req(90)).result(timeout=120)
        server.drain(timeout=120)
    events = [e for e in prof.events() if e.name.startswith(("serving.", "text.", "runtime."))]
    threads = {}
    for e in events:
        threads.setdefault(e.name, set()).add(e.thread)
    # submit's host work on this thread; the device work on the dispatcher's
    assert threads["serving.prep"].isdisjoint(threads["serving.dispatch"])
    assert threads["text.encode"] == threads["runtime.engine"] == threads["serving.dispatch"]
    assert not any(e.is_user_annotation for e in events)


def test_profiler_trace_holds_the_pipelines_spans(port_pipe):  # noqa: F811
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        port_pipe.process(_canny_image(7), "a bird", num_samples=1, image_resolution=RES,
                          ddim_steps=STEPS, seed=7)
    names = {e.name for e in prof.events()}
    assert {"pipeline.request", "pipeline.preprocess", "text.encode", "runtime.engine",
            "pipeline.fetch"} <= names
    assert np.isfinite(port_pipe.last_timings["total_ms"])
