"""95th percentile, over requests finished inside the window with two or
more tokens, of (done - first token) / (tokens - 1), in ms."""
from benchmarks import window


def compute(record):
    lo, hi = record["t_open"], record["t_close"]
    vals = [1e3 * (r.t_done - r.t_first_token) / (len(r.generated) - 1)
            for r in record["requests"]
            if not r.cancelled and r.t_done is not None
            and lo <= r.t_done <= hi and len(r.generated) > 1]
    return window.p95(vals)
