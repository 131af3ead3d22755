"""pipeline.text_ms: the text towers' conditioning of a request, the
benchmark's own span around the eager conditioning call, ended by a device
synchronisation; mean over the window's requests."""


def read(run):
    values = run.span("pipeline.text_ms")
    return sum(values) / len(values) if values else None
