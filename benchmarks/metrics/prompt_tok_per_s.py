"""Prompt tokens scored inside the window, a second: a scored request's
prompt counts when its logprobs are handed out; padding never counts."""
from benchmarks import window


def compute(record):
    return window.rate(record, window.PROMPT)
