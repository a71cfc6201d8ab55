"""The share of the admission waves' token slots that held padding, over
the requests admitted inside the window, in %: 100 x (1 - their real
prefilled tokens / their shares of the (rows, tokens) slots of the waves
that admitted them). The rows of a wave share its admission time, so the
slots summed are exactly those of the waves that started inside the
window. A program without the counters gives nothing."""


def compute(record):
    lo, hi = record["t_open"], record["t_close"]
    tokens = slots = 0.0
    for r in record["requests"]:
        t = getattr(r, "t_admit", None)
        if t is not None and lo <= t <= hi:
            tokens += r.prefill_tokens
            slots += r.prefill_slots
    if not slots:
        return None
    return 100.0 * (1.0 - tokens / slots)
