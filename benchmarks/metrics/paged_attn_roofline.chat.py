"""The single-query int8 parts kernel in the profiled slice: the least
time its calls could take (roofline.parts_call_bound_s of each call's
live lengths) over their summed device time, in %. Nothing when the slice
holds no such call."""


def compute(record):
    tr = record["trace"]
    if not tr or not tr["parts"]["calls"] or not tr["parts"]["time_s"]:
        return None
    return 100.0 * tr["parts"]["bound_s"] / tr["parts"]["time_s"]
