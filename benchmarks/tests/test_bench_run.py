"""A run end to end on the CPU at the tiny configuration (the harness's
CUDA check skipped by calling it directly), and the entry's refusals."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

import tinybench
from benchmarks.registry import HERE

ROOT = os.path.dirname(HERE)
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _wanted(bench, group, workload):
    return {m["name"] for m in bench[group]
            if "workloads" not in m or workload in m["workloads"]}


@pytest.mark.parametrize("workload", ["tiny.chat", "tiny.score"])
@pytest.mark.parametrize("trace", [False, True])
def test_a_run_prints_one_valid_line(workload, trace):
    out = tinybench.run(workload, trace=trace)
    res = out["result"]
    line = json.loads(json.dumps(res))
    keys = list(line)
    assert keys[:5] == KEYS and keys[-1] == "compared"
    assert set(keys) <= set(KEYS) | {"breakdown", "compared"}
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    bench = tinybench.bench()
    group = "per_layer" if trace else "end_to_end"
    got = set(line["metrics"])
    # every metric read from the requests is there; the device's shares
    # have no device to read on the CPU
    assert got <= _wanted(bench, group, workload)
    if not trace:
        assert got == _wanted(bench, group, workload)
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert line["device"]["platform"] == "cpu"
    for c in line["compared"].values():
        assert c["value"] is not None and c["value"] <= c["limit"]
    rec = out["record"]
    assert rec["setup_s"] > 0 and rec["t_close"] > rec["t_open"]
    # the window closed once every kind of delivery had passed its end,
    # so the work straddling the end was handed out and counted
    kinds = {d[6] for d in rec["deliveries"]}
    assert kinds == ({"first"} if workload == "tiny.score"
                     else {"first", "decode"})
    for k in kinds:
        assert max(d[0] for d in rec["deliveries"] if d[6] == k) >= \
            rec["t_close"]


def test_the_same_seed_sends_the_same_requests():
    a = tinybench.run("tiny.score", seconds=0.3)["record"]["requests"]
    b = tinybench.run("tiny.score", seconds=0.3)["record"]["requests"]
    n = min(len(a), len(b))
    assert n > 8
    assert [r.prompt for r in a[:n]] == [r.prompt for r in b[:n]]


def test_without_a_card_the_entry_exits_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "benchmarks/run.py", "--workload",
                        "gpt2-small-int8.score", "--seed", "3", "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True)
    assert p.returncode != 0 and p.stdout == ""


def test_without_the_program_the_entry_fails(tmp_path):
    # a directory holding only BENCHMARK.json and the benchmark's files
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "benchmarks/run.py", "--workload",
                        "gpt2-small-int8.score", "--seed", "3", "--seconds",
                        "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run([sys.executable, "benchmarks/run.py", "--workload",
                        "gpt2-small-int8.score", "--seed", "2147483700",
                        "--seconds", "3", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
