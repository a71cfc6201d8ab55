"""The copied trace reader and the attribution of kernels to the
harness's spans, on a synthetic Chrome trace."""

import json
import re

from benchmarks import trace_reader


def _trace():
    ev = []

    def x(cat, name, ts, dur, tid=1, **args):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts,
                   "dur": dur, "tid": tid, "args": args})

    # host: a chunk span with two launches, a prefill span with one
    x("user_annotation", "bench.chunk#0", 0, 100)
    x("cpu_op", "aten::mm", 5, 10)
    x("cuda_runtime", "cudaLaunchKernel", 10, 2, correlation=1)
    x("cuda_runtime", "cudaLaunchKernel", 40, 2, correlation=2)
    x("user_annotation", "bench.prefill#1", 200, 100)
    x("cuda_driver", "cuLaunchKernelEx", 210, 2, correlation=3)
    # a launch outside every span
    x("cuda_runtime", "cudaLaunchKernel", 400, 2, correlation=4)
    # device
    x("kernel", "void parts::parts_kernel<__nv_bfloat16, signed char, "
      "true, 64, 1, 4, false, false>(...)", 50, 20, tid=7, correlation=1)
    x("kernel", "void parts::parts_kernel<__nv_bfloat16, signed char, "
      "true, 64, 1, 4, false, false>(...)", 80, 30, tid=7, correlation=2)
    x("kernel", "flash_fwd_kernel", 300, 50, tid=7, correlation=3)
    x("kernel", "void parts::parts_kernel<float, float, false, 64, 1, 8, "
      "true, false>(...)", 500, 10, tid=7, correlation=4)
    ev.append({"ph": "M", "name": "process_name"})     # not timed
    return {"traceEvents": ev}


def test_read_trace_busy_window_and_gaps(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps(_trace()))
    tr = trace_reader.read_trace(str(p), top=2, gaps=2)
    # device busy: [50,70] + [80,110] + [300,350] + [500,510] = 110 µs
    assert tr["busy_ms"] == 0.110
    assert tr["window_ms"] == 0.510
    assert abs(tr["idle_share"] - (1 - 110 / 510)) < 1e-12
    assert tr["device_events"] == 4
    assert tr["top_kernels"][0]["name"].startswith("void parts")
    assert tr["top_kernels"][0]["count"] == 2
    assert tr["gaps"][0]["ms"] == 0.190      # 110 → 300
    assert tr["gaps"][0]["op"] is None        # no host operator runs then


def test_attribute_hands_kernels_to_their_spans(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps(_trace()))
    from benchmarks.registry import Registry
    KERNELS = Registry().family("gpt2").KERNELS
    got = trace_reader.attribute(str(p), {k: re.compile(v)
                                          for k, v in KERNELS.items()})
    assert got["parts"] == {("chunk", 0): [2, 50.0]}
    assert got["flash"] == {("prefill", 1): [1, 50.0]}
