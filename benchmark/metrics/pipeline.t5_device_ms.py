"""pipeline.t5_device_ms: device ms of the `text.t5` spans (SD3's T5-XXL
tower, eager, inside `text.encode`) a request, over the window: CUDA events
on the stream at the span's start and end. None where the program records
no such span (a family without T5, or a program before the span)."""

from benchmark.spans import device_sum


def read(run):
    found = device_sum(run, "text.t5")
    return None if found is None or not found[1] else found[0] / found[1]
