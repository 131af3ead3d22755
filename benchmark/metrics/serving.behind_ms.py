"""serving.behind_ms: mean ms from a batch's dispatch start to its device
start (the host time the completion thread saw the batch's `ready` event,
less the batch's device time): its wait behind the batch in flight, over
the window (the `serving.behind` spans of `ServerStats.snapshot()`)."""

from benchmark.spans import server_tally


def read(run):
    found = server_tally(run, "serving.behind")
    return None if found is None else found[0]["mean_ms"]
