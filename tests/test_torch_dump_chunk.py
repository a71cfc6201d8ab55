"""ops/dev/dump_chunk_trace.py on the CPU: the chunk's census of pool
operators at a tiny config splits into whole per-step and per-chunk
counts, its CLI runs to the end with --device cpu, and read_trace and
census give exactly what a hand-written Chrome trace holds."""

import json

import pytest
import torch

from llmc_paged_tpu_torch.config import GPT2Config
from llmc_paged_tpu_torch.ops.dev import dump_chunk_trace as D

TINY = dict(max_seq_len=128, vocab_size=96, num_layers=2, num_heads=2,
            channels=128)


@pytest.fixture
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_census_splits_into_steps_and_chunk(dtype, two_threads):
    """On the CPU the chunk runs the plain parts versions: per step two
    indexed reads a layer (the K and V gathers; at int8 also the whole
    planes the plain version dequantizes), per chunk the commit's
    indexed writes (values, and scales at int8)."""
    cfg = GPT2Config.tiny(**TINY)
    L = cfg.num_layers
    rec = D.run(cfg, dtype, prompt=8, pool_mult=2, chunk=4, batch=2,
                device="cpu", report=lambda s: None)
    assert rec["integral"]
    got = {k: (v["step"], v["chunk"]) for k, v in rec["split"].items()}
    want = {("indexed read", "aten::index", "pool"): (2 * L, 0),
            ("indexed write", "aten::index_put_", "pool"): (0, 2 * L)}
    if dtype == "int8":
        want.update({
            ("indexed write", "aten::index_put_", "scale"): (0, 2 * L),
            ("whole plane", "aten::to", "pool"): (2 * L, 0),
            ("whole plane", "aten::mul", "pool"): (2 * L, 0)})
    assert got == want
    assert rec["parts_kernels"] == {4: 0, 8: 0}      # no kernel on the CPU
    assert rec["summary"]["idle_share"] is None
    assert rec["flops"] > 0


def test_cli_runs_on_the_cpu(tmp_path, monkeypatch, capsys, two_threads):
    """The CLI with --device cpu, at the tiny config in the place of
    GPT-2 124M (a full-size model is not run on the CPU here)."""
    monkeypatch.setattr(GPT2Config, "gpt2_124m",
                        classmethod(lambda cls: cls.tiny(**TINY)))
    recs = D.main(["--model", "124m", "--prompt", "8", "--pool-mult", "1",
                   "--dtypes", "int8,float32", "--chunk", "2", "--batch",
                   "2", "--save", str(tmp_path / "t"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert [r["dtype"] for r in recs] == ["int8", "float32"]
    assert all(r["integral"] for r in recs)
    assert "per STEP" in out and "per CHUNK" in out
    assert "no integer split" not in out
    for dt in ("int8", "float32"):
        for s in (2, 4):
            with open(tmp_path / f"t.{dt}.S{s}.json") as f:
                assert json.load(f)["traceEvents"]


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 1,
            "ts": ts, "dur": dur, "args": args}


def _hand_trace(path):
    """Host operators aten::mm [0, 30), aten::inner [12, 18), aten::tail
    [28, 40); kernels kA [5, 10) and [26, 29), kB [8, 15) (overlapping
    kA), a memcpy [20, 24); a profiler span and a metadata event that
    the reader must ignore. µs."""
    events = [
        {"ph": "M", "name": "process_name", "pid": 1, "ts": -500},
        _x("Trace", "PyTorch Profiler (0)", -100, 500),
        _x("cpu_op", "aten::mm", 0, 30),
        _x("cpu_op", "aten::inner", 12, 6),
        _x("cpu_op", "aten::tail", 28, 12),
        _x("kernel", "kA", 5, 5, correlation=1),
        _x("kernel", "kB", 8, 7, correlation=2),
        _x("gpu_memcpy", "Memcpy HtoD", 20, 4, correlation=3),
        _x("kernel", "kA", 26, 3, correlation=4),
    ]
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)


def test_read_trace_hand_written(tmp_path):
    path = tmp_path / "trace.json"
    _hand_trace(path)
    r = D.read_trace(str(path))
    ms = pytest.approx
    # busy: [5, 15) + [20, 24) + [26, 29) = 17 µs of a 40 µs window
    assert r["busy_ms"] == ms(0.017)
    assert r["window_ms"] == ms(0.040)
    assert r["idle_share"] == ms(1 - 17 / 40)
    assert r["device_events"] == 4
    assert [(k["name"], k["count"], k["ms"]) for k in r["top_kernels"]] == \
        [("kA", 2, ms(0.008)), ("kB", 1, ms(0.007))]
    assert [(g["start_ms"], g["ms"], g["op"]) for g in r["gaps"]] == [
        (ms(0.029), ms(0.011), "aten::tail"),
        (ms(0.0), ms(0.005), "aten::mm"),
        (ms(0.015), ms(0.005), "aten::inner"),
        (ms(0.024), ms(0.002), "aten::mm")]
    assert sum(g["ms"] for g in r["gaps"]) == ms(r["window_ms"]
                                                  - r["busy_ms"])


def test_census_hand_written(tmp_path):
    """A copying aten::contiguous of a plane (its clone and copy_ inside
    it are not counted again; the copy kernel its launch call names is
    its device time), an indexed write of 6 floats, a view of the plane
    and a plane-free operator (both not counted)."""
    plane, scale = 4 * 3 * 2 * 5, 4 * 3 * 5
    dims = [[4, 3, 2, 5]]
    events = [
        _x("cpu_op", "aten::contiguous", 0, 20, **{
            "Input Dims": dims, "Input type": ["float"]}),
        _x("cpu_op", "aten::clone", 1, 18, **{
            "Input Dims": dims, "Input type": ["float"]}),
        _x("cpu_op", "aten::copy_", 2, 10, **{
            "Input Dims": dims + dims, "Input type": ["float", "float"]}),
        _x("cuda_runtime", "cudaLaunchKernel", 3, 2, correlation=77),
        _x("kernel", "copy_kernel", 30, 9, correlation=77),
        _x("cpu_op", "aten::index_put_", 40, 5, **{
            "Input Dims": [[4, 3, 5], [], [2, 3], []],
            "Input type": ["float", "", "float", "Scalar"]}),
        _x("cpu_op", "aten::view", 50, 1, **{
            "Input Dims": dims, "Input type": ["float"]}),
        _x("cpu_op", "aten::add", 60, 1, **{
            "Input Dims": [[7]], "Input type": ["float"]}),
    ]
    path = tmp_path / "census.json"
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    got = D.census(str(path), plane, scale)
    assert got == {
        ("whole plane", "aten::contiguous", "pool"):
            [1, pytest.approx(plane * 4 / 1e6), 9],
        ("indexed write", "aten::index_put_", "scale"):
            [1, pytest.approx(6 * 4 / 1e6), 0]}


def test_split_steps_refuses_a_non_integer_split():
    c1 = {("whole plane", "aten::copy_", "pool"): [5, 0, 0],
          ("indexed write", "aten::index_put_", "pool"): [4, 0, 0]}
    c2 = {("whole plane", "aten::copy_", "pool"): [8, 0, 0],
          ("indexed write", "aten::index_put_", "pool"): [4, 0, 0]}
    s = D.split_steps(c1, c2, 2)
    assert s[("indexed write", "aten::index_put_", "pool")] == dict(
        step=0, chunk=4, n_S=4, n_2S=4)
    assert s[("whole plane", "aten::copy_", "pool")] == dict(
        step=None, chunk=None, n_S=5, n_2S=8)
