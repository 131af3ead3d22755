"""device.peak_reserved_gib: `torch.cuda.max_memory_reserved()` over set-up
and the window, GiB (reserved, so the engines' graph pools count)."""


def read(run):
    return run.peak_reserved / 2 ** 30 if run.peak_reserved else None
