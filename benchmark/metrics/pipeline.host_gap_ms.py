"""pipeline.host_gap_ms: the host's share of a request's critical path, the
mean over the window's requests of (its host-clock latency) less (the device
ms of the program's outermost device spans that start inside it)."""

from benchmark.spans import window_spans


def read(run):
    spans = window_spans(run)
    if spans is None:
        return None
    by_id = {sp.id: sp for sp in spans}
    top = [sp for sp in spans if sp.device_ms is not None
           and not (sp.parent in by_id and by_id[sp.parent].device_ms is not None)]
    if not top:
        return None
    gaps = [(r.t1 - r.t0) * 1e3 - sum(sp.device_ms for sp in top if r.t0 <= sp.t0 <= r.t1)
            for r in run.records]
    return sum(gaps) / len(gaps)
