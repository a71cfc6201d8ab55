"""The chained decode steps that replayed as a CUDA graph over all
decode steps: 100 x decode_graph_steps / decode_steps from the engine's
stats over the serving run that holds the window, in %. Nothing where no
step replayed (a program without the counter, or off the card, where the
engine captures no graph)."""


def compute(record):
    st = record["stats"]
    steps = st.get("decode_steps", 0)
    if not st.get("decode_graph_steps") or not steps:
        return None
    return 100.0 * st["decode_graph_steps"] / steps
