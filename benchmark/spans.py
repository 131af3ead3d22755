"""The program's spans (`stablediffusioneo_tpu_torch/runtime/profiling.py`)
as the per-layer metrics read them. A served cell reads the server's tallies,
`ServerStats.snapshot()["spans"]` (reset at the window's start); a cell
without a server reads the recorder's spans whose host interval lies inside
the window, from the first request's start to the last request's end, which
leaves out the warm-up and the traced segment after the window. Each reader
returns None where the program records no such span."""

from __future__ import annotations


def server_tally(run, name):
    """The served window's tally of span `name` (count, mean_ms,
    device_count, mean_device_ms) and the window's rows, or None."""
    server = run.counters.get("server")
    tally = (server.get("spans") or {}).get(name) if server else None
    return (tally, server["rows"]) if tally and tally["count"] and server["rows"] else None


def window_spans(run):
    """The recorder's spans inside the window (device times resolved), or
    None: no records, a program without the recorder, or no span there."""
    if not run.records:
        return None
    try:
        from stablediffusioneo_tpu_torch.runtime import profiling

        spans = profiling.spans()
    except (ImportError, AttributeError):
        return None
    t0, t1 = min(r.t0 for r in run.records), max(r.t1 for r in run.records)
    return [sp for sp in spans if sp.t1 is not None and t0 <= sp.t0 and sp.t1 <= t1] or None


def device_sum(run, name):
    """Device ms of the window's spans `name`, and what they are over: the
    served window's rows, else the window's requests. runtime.engine spans
    inside a text.encode span (the text encoder's engine) are the text's and
    are left out. None where there is nothing to read."""
    if "server" in run.counters:
        found = server_tally(run, name)
        if found is None or not found[0]["device_count"]:
            return None
        tally, rows = found
        return tally["mean_device_ms"] * tally["device_count"], rows
    spans = window_spans(run)
    if spans is None:
        return None
    by_id = {sp.id: sp for sp in spans}
    dev = [sp.device_ms for sp in spans if sp.name == name and sp.device_ms is not None
           and not (name == "runtime.engine" and sp.parent in by_id
                    and by_id[sp.parent].name == "text.encode")]
    return (sum(dev), len(run.records)) if dev else None
