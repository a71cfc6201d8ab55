"""The prompt's attention in the profiled slice (the library's flash and
memory-efficient kernels of the prefill waves): the least time their
calls could take, the real rows' attention FLOPs (a sliding layer's keys
within its window) at the bf16 peak (families/mellum.kernels), over
their summed device time, in %. Nothing when the slice holds no such
call, or the trace reader has no ``prompt_attn`` entry (another
family)."""


def compute(record):
    tr = record["trace"]
    att = (tr or {}).get("prompt_attn")
    if not att or not att["calls"] or not att["time_s"]:
        return None
    return 100.0 * att["bound_s"] / att["time_s"]
