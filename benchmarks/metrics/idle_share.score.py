"""1 - busy / window of the profiled slice: the share of it in which no
kernel, copy or memset ran on the card, in %."""


def compute(record):
    tr = record["trace"]
    if not tr or not tr["window_s"] or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
