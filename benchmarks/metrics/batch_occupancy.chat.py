"""Decode tokens kept over the rows the decode steps could have held:
decode_tokens / (decode_steps x max_batch) from the engine's stats over
the serving run that holds the window, in %."""


def compute(record):
    st = record["stats"]
    steps = st.get("decode_steps", 0)
    if not steps:
        return None
    return 100.0 * st["decode_tokens"] / (steps * record["concurrency"])
