"""device.idle_share: the share of the traced segment's wall time in which
no kernel, copy or memset ran on the card, percent (1 - union of the device
intervals / the segment's window)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
