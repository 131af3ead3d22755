"""serving.latency_p90_s: the 90th percentile of submit -> image over every
request of the window (in an open loop, from the scheduled arrival). In the
served cell's closed loop the server sits at its knee, and this tail flips
between phase-locked modes of the 8 clients (2.10-2.23 s or 2.83 s at the
same throughput); in the open cell below the knee it spread 0.75-3.9% over
six runs, too wide for a bound of 0.10. So it is read here, beside the layer
that sets it, and not bounded as an end-to-end metric."""

from benchmark.harness import percentile


def read(run):
    lat = [r.t1 - r.t0 for r in run.records if r.out is not None]
    return percentile(lat, 90) if len(lat) >= 10 else None
