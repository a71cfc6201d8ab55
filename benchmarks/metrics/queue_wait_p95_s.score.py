"""95th percentile of submit to admission (the start of the request's
first admission wave) over every request admitted inside the window:
the time it waited in the engine's queue. A program without the
admission timestamp gives nothing."""
from benchmarks import window


def compute(record):
    lo, hi = record["t_open"], record["t_close"]
    waits = []
    for r in record["requests"]:
        t = getattr(r, "t_admit", None)
        if t is not None and lo <= t <= hi:
            waits.append(t - r.t_submit)
    return window.p95(waits)
