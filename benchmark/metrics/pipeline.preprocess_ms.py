"""pipeline.preprocess_ms: the pipeline's host preprocessing (resize,
Canny, bit-pack) of a request, `last_timings["preprocess_ms"]`, mean over
the window's requests."""


def read(run):
    values = run.span("pipeline.preprocess_ms")
    return sum(values) / len(values) if values else None
