"""mfu: the window's model FLOPs over the card's bf16 peak, percent: the
configuration's FLOPs of one image (`benchmark/work.py`, counted from its
shapes) times the images completed, over the window's seconds, over
989 TFLOP/s (peaks.json)."""


def read(run):
    if not run.images:
        return None
    rate = run.flops_per_image * run.images / run.window_s
    return 100.0 * rate / run.peaks["bf16_flops"]
