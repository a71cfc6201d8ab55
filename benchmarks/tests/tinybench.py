"""The tiny cells the CPU tests run the harness on: the benchmark's
BENCHMARK.json with its cells swapped for two of a toy GPT-2
(``tiny/``), every metric of it kept, each listed for the tiny cell of
its mix."""

import copy
import json
import os

from benchmarks.registry import HERE, Registry

ROOT = os.path.dirname(HERE)
TINY = os.path.join(HERE, "tests", "tiny")
CELLS = {"chat": "tiny.chat", "score": "tiny.score"}


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = copy.deepcopy(json.load(f))
    b["workloads"] = [
        {"name": "tiny.chat", "config": "tiny-int8", "traffic": "tiny_chat",
         "chips": 1, "why": "test"},
        {"name": "tiny.score", "config": "tiny-int8",
         "traffic": "tiny_score", "chips": 1, "why": "test"}]
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            m["workloads"] = sorted({CELLS[w.rsplit(".", 1)[1]]
                                     for w in m["workloads"]})
    return b


def registry(*extra) -> Registry:
    return Registry([*extra, TINY, HERE])


def run(workload, seed=2147483659, seconds=0.6, trace=False, **kw):
    from benchmarks import harness
    return harness.run_cell(bench(), workload, seed, seconds, trace,
                            device="cpu", registry=kw.pop("registry",
                                                          registry()), **kw)
