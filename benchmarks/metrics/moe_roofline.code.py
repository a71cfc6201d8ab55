"""The grouped GEMMs of the expert products in the profiled slice: the
least time their calls could take (for each, all experts' weights and
the routed rows in and out at the HBM peak, or its operations at the
bf16 peak, whichever is larger: families/mellum.moe_layer_bound_s) over
their summed device time, in %. Exact where every expert gets a row
(``moe_routed_tokens`` shows it). Nothing when the slice holds no such
call, or the trace reader has no ``moe`` entry (another family)."""


def compute(record):
    tr = record["trace"]
    moe = (tr or {}).get("moe")
    if not moe or not moe["calls"] or not moe["time_s"]:
        return None
    return 100.0 * moe["bound_s"] / moe["time_s"]
