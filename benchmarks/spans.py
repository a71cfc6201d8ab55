"""The harness's spans around the program's calls, for traced runs.

Each call of the family's device entries (its ``span_targets()``) and of
the engine's one device-to-host fetch runs inside a
``torch.profiler.record_function`` range ``bench.<kind>#<index>`` and
leaves a record ``{"kind", "idx", "t"}`` with what the family's
describer reads from the call's arguments (rows ``B``, each live row's
``lengths``, the ``steps`` of a chained call, ...); ``fetch`` is
``engine._fetch``, a materialization, which every family shares.

The describers read only host tensors the engine built, so the wrappers
add no device synchronization. ``install`` swaps them into the modules
the engine calls through; ``remove`` puts the originals back.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence

import torch

from llmc_paged_tpu_torch.engine import engine as engine_mod


class Spans:
    def __init__(self, targets: Sequence[tuple]):
        """``targets``: [(module, attribute, kind, describe)]."""
        self.targets = [*targets,
                        (engine_mod, "_fetch", "fetch", lambda *a, **k: {})]
        self.records: List[Dict] = []
        self._saved = []

    def _wrap(self, kind, fn, describe):
        def wrapped(*args, **kw):
            idx = len(self.records)
            rec = {"kind": kind, "idx": idx, "t": time.monotonic()}
            rec.update(describe(*args, **kw))
            self.records.append(rec)
            with torch.profiler.record_function(f"bench.{kind}#{idx}"):
                return fn(*args, **kw)
        return wrapped

    def install(self) -> None:
        for mod, name, kind, describe in self.targets:
            orig = getattr(mod, name)
            self._saved.append((mod, name, orig))
            setattr(mod, name, self._wrap(kind, orig, describe))

    def remove(self) -> None:
        for mod, name, orig in reversed(self._saved):
            setattr(mod, name, orig)
        self._saved.clear()
