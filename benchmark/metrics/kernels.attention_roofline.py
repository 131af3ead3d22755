"""kernels.attention_roofline: the least time of every attention call of
the traced segment's requests (`benchmark/work.py:attention_bound_s`: each
call's operations over the bf16 peak or its bytes over the bandwidth,
whichever is larger), over the device time of the kernels of the attention
family (`benchmark/kernels/attention/*.json`) in the trace, percent. The
bound counts the work whatever computes it; the family's files name the
kernels that do."""

from benchmark import kernels, work


def read(run):
    if run.trace is None:
        return None
    device_s = run.trace.family_s(kernels.marks("attention"))
    if device_s <= 0:
        return None
    return 100.0 * work.attention_bound_s(run.cfg, run.trace_images) / device_s
