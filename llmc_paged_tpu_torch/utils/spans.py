"""Named host spans of the engine loop and the model's decode step.

``with span(name):`` adds the block's host seconds to the current
thread's recorder, as ``{name: [count, seconds, self seconds]}``, where a
span's self time is its duration less the time its child spans cover.
``InferenceEngine.run`` makes a fresh recorder current on its own thread
for the length of the call (``recording``); a span entered where no
recorder is current (a model function called outside a run) records
nowhere.

While a profiler records, a span also opens a
``torch.profiler.record_function`` range of its name, so the device trace
holds it on the profiler's own clock. The choice is made when the span is
entered and the same range is closed on exit, so a profiler that starts
inside a span never sees an unmatched exit. With no profiler running a
span costs one check and two clock reads.

``caller(name)`` is the span around the caller's code that may start or
stop a profiler (a serving loop's feed). A range still open when a
profiler stops ends, in its trace, when the profiler has finished
collecting (on an H100 about 0.9 s after the last device event), which
would read as the device idle. So no range of the program is open while
that code runs: ``caller`` opens none of its own, closes the ranges of
the spans around it on entry and opens them again on exit if a profiler
records then.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import torch

_local = threading.local()


class Recorder:
    """Totals of the spans closed on one thread while it was current."""

    def __init__(self):
        self.totals: Dict[str, List[float]] = {}
        self._open: List[span] = []       # innermost last

    def seconds(self, name: str) -> float:
        return self.totals.get(name, (0, 0.0, 0.0))[1]

    def self_seconds(self, name: str) -> float:
        return self.totals.get(name, (0, 0.0, 0.0))[2]

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {name: {"n": int(n), "s": s, "self_s": self_s}
                for name, (n, s, self_s) in self.totals.items()}


def current() -> Optional[Recorder]:
    return getattr(_local, "recorder", None)


class recording:
    """``with recording() as rec:`` makes a fresh recorder current on this
    thread; on exit it closes any span still open on it (an exception
    left its block) and makes the previous recorder current again."""

    def __enter__(self) -> Recorder:
        self.prev = current()
        self.rec = _local.recorder = Recorder()
        return self.rec

    def __exit__(self, *exc) -> bool:
        while self.rec._open:
            self.rec._open[-1].close()
        _local.recorder = self.prev
        return False


class span:
    """A named host span: ``with span(name):`` or ``open()`` and
    ``close()`` where its extent is not one block."""

    __slots__ = ("name", "rec", "rf", "t0", "child")
    ranges = True           # opens a range while a profiler records

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        self.rf = None
        if self.ranges and torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.rec = current()
        if self.rec is not None:
            self.rec._open.append(self)
        self.child = 0.0
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> bool:
        dt = time.monotonic() - self.t0
        rec = self.rec
        if rec is not None:
            rec._open.pop()
            if rec._open:
                rec._open[-1].child += dt
            t = rec.totals.get(self.name)
            if t is None:
                t = rec.totals[self.name] = [0, 0.0, 0.0]
            t[0] += 1
            t[1] += dt
            t[2] += dt - self.child
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        return False

    def open(self) -> "span":
        return self.__enter__()

    def close(self) -> None:
        self.__exit__(None, None, None)


class caller(span):
    """A span around the caller's code that may start or stop a profiler:
    no range of the program is open while it runs (module docstring)."""

    __slots__ = ()
    ranges = False

    def __enter__(self) -> "caller":
        rec = current()
        if rec is not None:
            for s in reversed(rec._open):
                if s.rf is not None:
                    s.rf.__exit__(None, None, None)
                    s.rf = None
        return super().__enter__()

    def __exit__(self, *exc) -> bool:
        super().__exit__(*exc)
        rec = self.rec
        # reopened unless still inside the caller's code
        if rec is not None and torch.autograd._profiler_enabled() \
                and all(s.ranges for s in rec._open):
            for s in rec._open:
                s.rf = torch.profiler.record_function(s.name)
                s.rf.__enter__()
        return False
