"""The int8 multi-query parts kernel at head_dim 128 in the profiled
slice: the least time its calls could take (the K/V bytes and scales of
each row's live [start, len) at the HBM peak,
families/mellum.parts_step_bytes) over their summed device time, in %.
Nothing when the slice holds no such call."""


def compute(record):
    tr = record["trace"]
    if not tr or not tr["parts"]["calls"] or not tr["parts"]["time_s"]:
        return None
    return 100.0 * tr["parts"]["bound_s"] / tr["parts"]["time_s"]
