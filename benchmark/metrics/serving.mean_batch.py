"""serving.mean_batch: requests per engine call the server cut over the
window (`ServerStats.snapshot()["mean_batch"]`, the stats reset at the
window's start). Only the server entry counts batches."""


def read(run):
    server = run.counters.get("server")
    return None if not server or not server["batches"] else server["mean_batch"]
