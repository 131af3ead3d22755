"""pipeline.text_device_ms: device ms of the `text.encode` spans (the text
encoders: SD-1.5's captured CLIP, SDXL's eager towers) a request, over the
window; served, a batch's encoding over its requests. CUDA events on the
stream at the span's start and end, so a launch-bound encoder's device idle
time between its kernels counts."""

from benchmark.spans import device_sum


def read(run):
    found = device_sum(run, "text.encode")
    return None if found is None or not found[1] else found[0] / found[1]
