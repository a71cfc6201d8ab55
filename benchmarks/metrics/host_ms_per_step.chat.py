"""Host milliseconds to enqueue one chained decode step: the program's
``model.step`` span, its seconds over its count, from the engine's stats
over the serving run that holds the window. A program without the span
gives nothing."""


def compute(record):
    step = record["stats"].get("spans", {}).get("model.step")
    if not step or not step["n"]:
        return None
    return 1e3 * step["s"] / step["n"]
