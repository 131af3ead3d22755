"""serving.window_cut_share: the share of the window's batches that the
server cut because the oldest request's batching window (`max_wait_ms`) ran
out, rather than because the largest bucket filled, percent
(`ServerStats.snapshot()["cuts"]`, the stats reset at the window's start).
A closed loop at its knee fills every batch; arrivals below capacity are cut
by the window. None where the server cut no batch."""


def read(run):
    server = run.counters.get("server")
    cuts = server.get("cuts") if server else None
    total = sum(cuts.values()) if cuts else 0
    return 100.0 * cuts["window"] / total if total else None
