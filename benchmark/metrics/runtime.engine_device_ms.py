"""runtime.engine_device_ms: device ms of the sample+decode engine's
`runtime.engine` spans (those inside `text.encode` left out) an image, over
the window: CUDA events on the stream at the replay's start and end."""

from benchmark.spans import device_sum


def read(run):
    found = device_sum(run, "runtime.engine")
    return None if found is None or not found[1] else found[0] / found[1]
