"""Each piece is found by its name: a new mix, configuration, cell or
metric is a new file, and no existing file changes. The committed
benchmark's every name has its file."""

import json
import os

import pytest

import tinybench
from benchmarks.registry import HERE, Registry

ROOT = os.path.dirname(HERE)


def test_a_new_mix_and_a_new_metric_are_found(tmp_path):
    (tmp_path / "mixes").mkdir()
    (tmp_path / "metrics").mkdir()
    (tmp_path / "cells").mkdir()
    with open(os.path.join(tinybench.TINY, "mixes", "tiny_chat.json")) as f:
        mix = json.load(f)
    mix["prompt_len"] = [8, 16]                     # only parameters change
    (tmp_path / "mixes" / "tiny_short.json").write_text(json.dumps(mix))
    (tmp_path / "cells" / "tiny.short.json").write_text(json.dumps(
        {"concurrency": 2, "trace_seconds": 0.5,
         "limits": {"token_gap": 0.05}}))
    (tmp_path / "metrics" / "requests_sent.py").write_text(
        "def compute(record):\n    return len(record['requests'])\n")
    bench = tinybench.bench()
    bench["workloads"].append({"name": "tiny.short", "config": "tiny-int8",
                               "traffic": "tiny_short", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "requests_sent", "unit": "requests",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["tiny.short"]})
    from benchmarks import harness
    out = harness.run_cell(bench, "tiny.short", 77, 0.4, False,
                           device="cpu",
                           registry=tinybench.registry(str(tmp_path)))
    res = out["result"]
    assert res["metrics"]["requests_sent"]["value"] > 0
    assert all(len(r.prompt) <= 16 for r in out["record"]["requests"])


def test_every_name_of_the_benchmark_has_its_file():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    reg = Registry()
    for c in bench["configs"]:
        cfg = reg.config(c["name"])
        assert os.path.join(ROOT, c["file"]) == reg.path("configs",
                                                         c["name"], ".json")
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
    for w in bench["workloads"]:
        mix = reg.mix(w["traffic"])
        reg.traffic(mix["kind"])
        cell = reg.cell(w["name"])
        assert cell["concurrency"] > 0 and cell["limits"]
        assert w["config"] in {c["name"] for c in bench["configs"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(reg.metric(m["name"]).compute)


def test_a_missing_file_is_an_error():
    with pytest.raises(FileNotFoundError):
        Registry().mix("no_such_mix")
