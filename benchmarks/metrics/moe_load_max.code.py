"""The routing's worst imbalance: over the layers, the rows routed to a
layer's busiest expert over its mean rows an expert, from the engine's
``moe_routed_tokens`` (an (L, E) count over the serving run that holds
the window), in x (1 is even). Nothing from a program without the
counter."""


def compute(record):
    counts = record["stats"].get("moe_routed_tokens")
    if not counts:
        return None
    worst = None
    for row in counts:
        mean = sum(row) / len(row)
        if mean > 0:
            r = max(row) / mean
            worst = r if worst is None else max(worst, r)
    return worst
