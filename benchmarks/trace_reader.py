"""Reading a torch.profiler Chrome trace of a run.

``load_events``, ``read_trace``, ``_union`` and ``_innermost`` are the
benchmark's own copy of ``llmc_paged_tpu_torch/ops/dev/dump_chunk_trace``
(the yardstick must not move with the program); ``attribute`` is new: it
hands each device kernel to the harness span (a ``record_function`` range
named ``bench.<kind>#<index>``) inside which the host launched it, by the
kernel's correlation id and its launch call's place on the host's
timeline.
"""

from __future__ import annotations

import bisect
import collections
import json
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_OP_CATS = ("cpu_op", "user_annotation")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN = re.compile(r"^bench\.([a-z_]+)#(\d+)$")


def load_events(trace) -> list:
    """The timed ("X") events of a Chrome trace: its path, or the list
    this function returned for it (a trace is read once)."""
    if isinstance(trace, list):
        return trace
    with open(trace) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "ts" in e]


def _union(spans):
    """Merged (start, end) intervals of ``spans``, in order."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(ops, t):
    """Name of the innermost host operator running at time t (the one
    that started last among those that contain t), or None."""
    best = None
    for e in ops:
        if e["ts"] <= t < e["ts"] + e.get("dur", 0):
            if best is None or e["ts"] >= best["ts"]:
                best = e
    return None if best is None else best["name"]


def read_trace(path, top: int = 10, gaps: int = 5) -> dict:
    """Where the card's time went in a Chrome trace (its path, or
    load_events' list for it).

    Returns busy_ms (union of kernel, memcpy and memset intervals),
    window_ms (first start to last end of all timed events), idle_share
    (1 - busy/window; None when the trace holds no device activity),
    device_events, top_kernels ([{name, count, ms}], the ``top`` kernels
    by total time) and gaps ([{start_ms, ms, op}], the ``gaps`` longest
    idle intervals of the window, before, between and after the busy
    intervals, start_ms from the window's start, op the innermost host
    operator running at the gap's start)."""
    events = load_events(path)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    ops = [e for e in events if e.get("cat") in HOST_OP_CATS]
    timed = [e for e in events if e.get("cat") != "Trace"]
    t0 = min((e["ts"] for e in timed), default=0.0)
    t1 = max((e["ts"] + e.get("dur", 0) for e in timed), default=0.0)
    busy = _union((e["ts"], e["ts"] + e.get("dur", 0)) for e in dev)
    busy_us = sum(e - s for s, e in busy)
    window_us = t1 - t0
    per = collections.defaultdict(lambda: [0, 0.0])
    for e in dev:
        if e["cat"] == "kernel":
            per[e["name"]][0] += 1
            per[e["name"]][1] += e.get("dur", 0)
    top_k = sorted(per.items(), key=lambda kv: -kv[1][1])[:top]
    idle = []
    if busy:
        edges = [t0] + [x for se in busy for x in se] + [t1]
        idle = [(s, e - s) for s, e in zip(edges[::2], edges[1::2])
                if e > s]
    idle.sort(key=lambda g: -g[1])
    return dict(
        busy_ms=busy_us / 1e3, window_ms=window_us / 1e3,
        idle_share=(1.0 - busy_us / window_us) if busy and window_us > 0
        else None,
        device_events=len(dev),
        top_kernels=[dict(name=n, count=c, ms=us / 1e3)
                     for n, (c, us) in top_k],
        gaps=[dict(start_ms=(s - t0) / 1e3, ms=d / 1e3,
                   op=_innermost(ops, s)) for s, d in idle[:gaps]])


def attribute(path, patterns: dict) -> dict:
    """Kernels of the trace whose name matches one of ``patterns``
    ({key: compiled regex}), by the harness span that launched them:
    {key: {(kind, index): [count, device µs]}}. A kernel whose launch lies
    in no span (launched before the trace began, or outside the harness's
    calls) is left out."""
    events = load_events(path)
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0), e.get("tid"),
                    m.group(1), int(m.group(2)))
                   for e in events if e.get("cat") == "user_annotation"
                   for m in [SPAN.match(e.get("name", ""))] if m)
    by_tid = collections.defaultdict(list)
    for s in spans:
        by_tid[s[2]].append(s)
    starts = {tid: [s[0] for s in v] for tid, v in by_tid.items()}
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in LAUNCH_CATS
              and "correlation" in e.get("args", {})}
    out = {key: collections.defaultdict(lambda: [0, 0.0])
           for key in patterns}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        key = next((k for k, rx in patterns.items()
                    if rx.search(e.get("name", ""))), None)
        if key is None:
            continue
        call = launch.get(e.get("args", {}).get("correlation"))
        if call is None or call.get("tid") not in by_tid:
            continue
        lst = by_tid[call["tid"]]
        i = bisect.bisect_right(starts[call["tid"]], call["ts"]) - 1
        if i < 0 or call["ts"] > lst[i][1]:
            continue
        rec = out[key][(lst[i][3], lst[i][4])]
        rec[0] += 1
        rec[1] += e.get("dur", 0)
    return {k: dict(v) for k, v in out.items()}
