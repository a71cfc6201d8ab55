"""95th percentile of submit to first token over every request whose first
token came inside the window."""
from benchmarks import window


def compute(record):
    return window.p95(window.ttfts(record))
