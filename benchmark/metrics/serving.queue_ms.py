"""serving.queue_ms: mean time a request waited in the server's queue
before its batch was cut, over the window (`ServerStats` mean_queue_ms)."""


def read(run):
    server = run.counters.get("server")
    return None if not server or not server["batches"] else server["mean_queue_ms"]
