"""serving.dispatch_ms: mean host ms of a batch's `serving.dispatch` span,
the cut to its device work enqueued (text encoder and engine calls), over
the window (`ServerStats.snapshot()["spans"]`)."""

from benchmark.spans import server_tally


def read(run):
    found = server_tally(run, "serving.dispatch")
    return None if found is None else found[0]["mean_ms"]
