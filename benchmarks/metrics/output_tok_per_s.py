"""Output tokens handed out inside the window, a second (every request's
tokens, the first one included)."""
from benchmarks import window


def compute(record):
    return window.rate(record, window.OUT)
