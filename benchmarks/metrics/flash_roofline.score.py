"""The causal flash kernel of the prefill in the profiled slice: the least
time its calls could take over the real tokens (roofline.flash_call_bound_s)
over their summed device time, in %. Nothing when the slice holds no
wave that took the kernel."""


def compute(record):
    tr = record["trace"]
    if not tr or not tr["flash"]["calls"] or not tr["flash"]["time_s"]:
        return None
    return 100.0 * tr["flash"]["bound_s"] / tr["flash"]["time_s"]
