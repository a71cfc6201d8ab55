"""What the metric readers share: the window's share of each delivery and
the tail of a sample.

A delivery is one materialization: the tokens handed out at time ``t``,
computed since the delivery of their kind before it (``prev``: a wave's
first tokens since the last wave's, decode tokens since the last decode
tokens). Its work is spread evenly over [prev, t], so a window edge
takes the part of it that lies inside and a link that straddles the edge
counts in proportion, not whole or not at all."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

T, PREV, OUT, PROMPT, FLOPS = range(5)


def in_window(record: dict, field: int) -> float:
    """Sum of a delivery field inside the window."""
    lo, hi = record["t_open"], record["t_close"]
    total = 0.0
    for d in record["deliveries"]:
        t, prev = d[T], d[PREV]
        if t <= prev:
            total += d[field] if lo <= t <= hi else 0.0
            continue
        overlap = min(t, hi) - max(prev, lo)
        if overlap > 0:
            total += d[field] * overlap / (t - prev)
    return total


def rate(record: dict, field: int) -> float:
    return in_window(record, field) / record["seconds"]


def p95(values: Sequence[float]) -> Optional[float]:
    """95th percentile (linear interpolation between order statistics), or
    None for an empty sample."""
    return float(np.percentile(values, 95)) if len(values) else None


def ttfts(record: dict):
    """Time to first token of every request whose first token came inside
    the window."""
    lo, hi = record["t_open"], record["t_close"]
    return [r.t_first_token - r.t_submit for r in record["requests"]
            if r.t_first_token is not None and lo <= r.t_first_token <= hi]
