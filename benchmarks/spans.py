"""The harness's spans around the program's calls, for traced runs.

Each call of the paged model's three device entries and of the engine's
one device-to-host fetch runs inside a ``torch.profiler.record_function``
range ``bench.<kind>#<index>`` and leaves a record of what it was handed:

* ``prefill``: ``gpt2_paged.prefill_paged``, a padded admission wave:
  its rows, padded length, the real length of each row (tokens whose
  pool page is a real page) and whether every position is projected;
* ``chunk``: ``gpt2_paged.decode_chunk_paged``, one link of a decode
  chain: its steps and each live row's committed length (what the parts
  kernel reads in every step of the link);
* ``step``: ``gpt2_paged.decode_step_paged``, a single-token step: each
  live row's length;
* ``fetch``: ``engine._fetch``, a materialization.

The wrappers read only host tensors the engine built, so they add no
device synchronization. ``install`` swaps them into the modules the
engine calls through; ``remove`` puts the originals back.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from llmc_paged_tpu_torch.engine import engine as engine_mod
from llmc_paged_tpu_torch.models import gpt2_paged


class Spans:
    def __init__(self):
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
        targets = [
            (gpt2_paged, "prefill_paged", "prefill", _describe_prefill),
            (gpt2_paged, "decode_chunk_paged", "chunk", _describe_chunk),
            (gpt2_paged, "decode_step_paged", "step", _describe_step),
            (engine_mod, "_fetch", "fetch", lambda *a, **k: {}),
        ]
        for mod, name, kind, describe in targets:
            orig = getattr(mod, name)
            self._saved.append((mod, name, orig))
            setattr(mod, name, self._wrap(kind, orig, describe))

    def remove(self) -> None:
        for mod, name, orig in reversed(self._saved):
            setattr(mod, name, orig)
        self._saved.clear()


def _host(t) -> torch.Tensor:
    return torch.as_tensor(t).cpu()


def _describe_prefill(params, tokens, page, slot, pool, cfg, last_pos=None,
                      **kw):
    pg = _host(page)
    real = (pg < pool.num_pages).sum(dim=1).tolist()
    B, T = pg.shape
    return {"B": int(B), "T": int(T), "lengths": [int(n) for n in real],
            "all_rows": last_pos is None}


def _describe_chunk(params, first_tokens, positions0, *args, num_steps=1,
                    **kw):
    pos0 = _host(positions0)
    return {"B": int(pos0.shape[0]), "steps": int(num_steps),
            "lengths": [int(n) for n in pos0.tolist() if n >= 0]}


def _describe_step(params, tokens, positions, page, slot, block_tables,
                   lengths, *args, **kw):
    ln = _host(lengths)
    return {"B": int(ln.shape[0]), "steps": 1,
            "lengths": [int(n) for n in ln.tolist() if n > 0]}
