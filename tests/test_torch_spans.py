"""The span recorder (llmc_paged_tpu_torch/utils/spans.py), the engine's
spans, buckets and per-request admission fields, and the benchmark's
readers of them (benchmarks/metrics/), on the CPU."""

import collections
import threading
import types

import numpy as np
import pytest
import torch

from benchmarks.registry import Registry
from llmc_paged_tpu_torch.config import EngineConfig, MellumConfig, PageConfig
from llmc_paged_tpu_torch.engine import engine as engine_mod
from llmc_paged_tpu_torch.engine.engine import InferenceEngine
from llmc_paged_tpu_torch.engine.scheduler import Request
from llmc_paged_tpu_torch.models import gpt2_paged, mellum, mellum_paged
from llmc_paged_tpu_torch.utils import spans
from llmc_paged_tpu_torch.utils.spans import span
from test_torch_common import params_np, port_cfg

NINE = {"engine.iteration", "engine.callback", "engine.admit",
        "engine.prefill", "engine.link", "engine.step", "engine.fetch",
        "engine.deliver", "model.step"}


class FakeClock:
    def __init__(self, times):
        self.times = list(times)

    def monotonic(self):
        return self.times.pop(0)


def test_nested_spans_count_seconds_and_self_seconds(monkeypatch):
    # outer 0..10 holds a (1..4, which holds c 2..3) and a again (5..6)
    monkeypatch.setattr(spans, "time", FakeClock(
        [0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 10.0]))
    with spans.recording() as rec:
        with span("outer"):
            with span("a"):
                with span("c"):
                    pass
            with span("a"):
                pass
    got = rec.as_dict()
    assert got["outer"] == {"n": 1, "s": 10.0, "self_s": 6.0}
    assert got["a"] == {"n": 2, "s": 4.0, "self_s": 3.0}
    assert got["c"] == {"n": 1, "s": 1.0, "self_s": 1.0}
    assert rec.seconds("a") == 4.0 and rec.self_seconds("outer") == 6.0
    assert rec.seconds("none") == 0.0


def test_open_and_close_nest_like_a_block(monkeypatch):
    monkeypatch.setattr(spans, "time", FakeClock([0.0, 1.0, 3.0, 7.0]))
    with spans.recording() as rec:
        outer = span("outer").open()
        with span("inner"):
            pass
        outer.close()
    assert rec.as_dict()["outer"] == {"n": 1, "s": 7.0, "self_s": 5.0}


def test_recording_closes_spans_an_exception_left_open():
    with pytest.raises(RuntimeError):
        with spans.recording() as rec:
            span("left").open()
            with span("inner"):
                raise RuntimeError("boom")
    assert rec.as_dict()["left"]["n"] == 1
    assert rec.as_dict()["inner"]["n"] == 1
    assert spans.current() is None


def test_spans_outside_a_recording_record_nowhere():
    assert spans.current() is None
    with span("x"):
        pass
    with spans.recording() as rec:
        with spans.recording() as inner:
            with span("y"):
                pass
        assert spans.current() is rec
    assert rec.as_dict() == {} and inner.as_dict()["y"]["n"] == 1


def test_threads_keep_their_own_totals():
    results, barrier = {}, threading.Barrier(2)

    def work(name, n):
        with spans.recording() as rec:
            barrier.wait(timeout=10)
            for _ in range(n):
                with span(name):
                    pass
        results[name] = rec.as_dict()

    ts = [threading.Thread(target=work, args=(name, n))
          for name, n in (("a", 300), ("b", 500))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    assert set(results["a"]) == {"a"} and set(results["b"]) == {"b"}
    assert results["a"]["a"]["n"] == 300 and results["b"]["b"]["n"] == 500


@pytest.fixture
def counted_record_function(monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        calls.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    return calls


def test_no_profiler_no_record_function(counted_record_function):
    with spans.recording():
        for _ in range(5):
            with span("quiet"):
                with span("inner"):
                    pass
    assert counted_record_function == []


def test_spans_are_ranges_of_a_running_profiler(counted_record_function):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("traced.outer"):
            with span("traced.inner"):
                torch.ones(4).add_(1)
    keys = {e.key for e in prof.key_averages()}
    assert {"traced.outer", "traced.inner"} <= keys
    assert counted_record_function == ["traced.outer", "traced.inner"]


def test_a_profiler_that_starts_or_stops_inside_a_span():
    """The range is chosen at entry: a span entered before the profiler
    started opens none, one entered while it ran closes its own range
    after it stopped."""
    from torch.profiler import ProfilerActivity, profile
    with spans.recording() as rec:
        before = span("before").open()
        prof = profile(activities=[ProfilerActivity.CPU])
        prof.start()
        inside = span("inside").open()
        with span("after_start"):
            pass
        prof.stop()
        inside.close()
        before.close()
    keys = {e.key for e in prof.key_averages()}
    assert "after_start" in keys and "before" not in keys
    assert rec.as_dict()["before"]["n"] == 1


def test_no_program_range_is_open_inside_the_callers_code(tmp_path):
    """A feed that starts the profiler and later stops it: the enclosing
    spans' ranges open once it records and close before it stops, so no
    range of the program outlives the profiler's own step in the trace;
    the caller's span opens none."""
    import json

    from torch.profiler import ProfilerActivity, profile, schedule
    prof = profile(activities=[ProfilerActivity.CPU],
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
    with spans.recording() as rec:
        with span("engine.iteration"):
            with spans.caller("engine.callback"):
                prof.start()                      # warm-up: not recording
            with spans.caller("engine.callback"):
                prof.step()                       # records from here
            with span("engine.link"):
                torch.ones(4).add_(1)
                with spans.caller("engine.callback"):
                    prof.stop()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        ev = [e for e in json.load(f)["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    names = [e["name"] for e in ev]
    assert sorted(names) == ["ProfilerStep#1", "engine.iteration",
                             "engine.link"]
    step = next(e for e in ev if e["name"] == "ProfilerStep#1")
    for e in ev:
        assert e["ts"] + e["dur"] <= step["ts"] + step["dur"], e["name"]
    assert rec.as_dict()["engine.callback"]["n"] == 3
    assert rec.as_dict()["engine.iteration"]["n"] == 1


# -- the engine ---------------------------------------------------------------

def _engine(greedy=True, max_batch=4, num_pages=40, **kw):
    cfg = port_cfg()
    page = PageConfig(page_size=8, num_pages=num_pages, max_seqs=max_batch,
                      pages_per_seq=8)
    econf = EngineConfig(cache_mode="paged", page=page, greedy=greedy,
                         max_batch=max_batch, decode_chunk=4, **kw)
    return InferenceEngine(params_np(cfg, seed=0), cfg, econf, device="cpu")


def _prompts(lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, size=n).tolist() for n in lens]


class ClosedLoop:
    """A feed that keeps ``conc`` requests live until every prompt was
    sent, and counts what the engine's callbacks hand it."""

    def __init__(self, lens, conc, new):
        self.prompts = _prompts(lens)
        self.conc, self.new = conc, new
        self.sent, self.live, self.done = [], 0, []
        self.tokens = 0

    def feed(self, block):
        out = []
        while self.live < self.conc and len(self.sent) < len(self.prompts):
            r = Request(rid=len(self.sent),
                        prompt=self.prompts[len(self.sent)],
                        max_new_tokens=self.new)
            self.sent.append(r)
            out.append(r)
            self.live += 1
        return out, len(self.done) < len(self.prompts)

    def on_tokens(self, req, toks):
        self.tokens += len(toks)

    def on_finish(self, req):
        self.live -= 1
        self.done.append(req)


@pytest.fixture(scope="module")
def served():
    """A greedy closed loop of 10 requests through 4 slots, its prefill
    calls counted, and a host-sampled batch that takes single steps."""
    mp = pytest.MonkeyPatch()
    waves = []
    real = gpt2_paged.prefill_paged

    def counting(*a, **kw):
        waves.append(a[1].shape)
        return real(*a, **kw)

    mp.setattr(gpt2_paged, "prefill_paged", counting)
    try:
        eng = _engine()
        loop = ClosedLoop([5, 20, 33, 7, 9, 14, 3, 26, 11, 18], 4, 9)
        eng.run([], feed=loop.feed, on_tokens=loop.on_tokens,
                on_finish=loop.on_finish)
        chained = (dict(eng.stats), loop, len(waves))
        seng = _engine(greedy=False, top_k=8)
        done = seng.run([Request(rid=i, prompt=p, max_new_tokens=5)
                         for i, p in enumerate(_prompts([6, 12]))])
        single = (dict(seng.stats), done)
    finally:
        mp.undo()
    return chained, single


def test_model_step_counts_the_chained_steps(served):
    (st, loop, n_waves), (sst, _) = served
    sp = st["spans"]
    assert st["decode_steps"] > 0 and st["single_steps"] == 0
    assert sp["model.step"]["n"] == (st["decode_steps"] - st["single_steps"]
                                     - st["verify_steps"])
    assert sp["engine.prefill"]["n"] == n_waves == st["prefill_calls"] >= 2
    assert sp["engine.iteration"]["n"] >= n_waves
    assert len(loop.done) == 10 and loop.tokens == 10 * 9
    # every second of the run lies in some pass of the loop
    assert sp["engine.iteration"]["s"] <= st["wall_s"]
    assert set(sp) == NINE - {"engine.step"}
    assert sst["single_steps"] == sst["decode_steps"] > 0
    assert sst["spans"]["engine.step"]["n"] == sst["single_steps"]
    assert "model.step" not in sst["spans"]
    assert set(sp) | set(sst["spans"]) == NINE
    for rec in (sp, sst["spans"]):
        for v in rec.values():
            assert set(v) == {"n", "s", "self_s"}
            assert 0.0 <= v["self_s"] <= v["s"] + 1e-9


def test_buckets_are_span_self_times_and_count_each_second_once(served):
    for st in (served[0][0], served[1][0]):
        sp = st["spans"]

        def self_s(name):
            return round(sp.get(name, {"self_s": 0.0})["self_s"], 4)

        assert st["t_prefill_dispatch_s"] == self_s("engine.prefill")
        assert st["t_chain_dispatch_s"] == self_s("engine.link")
        assert st["t_step_dispatch_s"] == self_s("engine.step")
        assert st["t_materialize_s"] == round(sp["engine.fetch"]["s"], 4)
        # the deferred fetch runs inside a link but counts once
        assert st["t_chain_dispatch_s"] + st["t_materialize_s"] \
            <= st["wall_s"]
        assert st["t_prefill_dispatch_s"] + st["t_chain_dispatch_s"] \
            + st["t_step_dispatch_s"] + st["t_materialize_s"] \
            <= st["wall_s"]
    # the caller's code is out of every program span's self time
    st = served[0][0]
    assert st["spans"]["engine.callback"]["n"] > 10


def test_admission_lies_between_submit_and_first_token(served):
    (_, loop, _), (_, done) = served
    for r in loop.done + done:
        assert r.t_submit <= r.t_admit <= r.t_first_token <= r.t_done
        assert r.prefill_tokens == len(r.prompt)
        assert r.prefill_slots >= r.prefill_tokens


def test_a_hand_built_wave_counts_its_padded_slots():
    """Prompts of 5, 20 and 33 tokens in one wave: one call (a cut would
    save fewer slots than a call is worth) of 3 rows of 48 tokens (33's
    16-token bucket)."""
    eng = _engine()
    reqs = [Request(rid=i, prompt=p, max_new_tokens=2)
            for i, p in enumerate(_prompts([5, 20, 33]))]
    done = eng.run(reqs)
    assert eng.stats["spans"]["engine.prefill"]["n"] == 1
    assert eng.stats["prefill_calls"] == 1
    assert len({r.t_admit for r in done}) == 1
    assert sum(r.prefill_slots for r in done) == 144
    assert sum(r.prefill_tokens for r in done) == 58
    assert [r.prefill_slots for r in sorted(done, key=lambda r: r.rid)] \
        == [48.0, 48.0, 48.0]


def test_a_wave_of_short_and_long_prompts_counts_each_calls_slots():
    """Six 16-token prompts and one of 1,000 in one wave: two calls, the
    short rows padded to 16 and the long one to 1,008, each row counting
    its own call's slots (one call would pad all seven to 1,008)."""
    cfg = port_cfg(max_seq_len=1024)
    page = PageConfig(page_size=16, num_pages=80, max_seqs=7,
                      pages_per_seq=64)
    econf = EngineConfig(cache_mode="paged", page=page, greedy=True,
                         max_batch=7, decode_chunk=4)
    eng = InferenceEngine(params_np(cfg, seed=0), cfg, econf, device="cpu")
    lens = [16, 16, 1000, 16, 16, 16, 16]
    done = eng.run([Request(rid=i, prompt=p, max_new_tokens=2)
                    for i, p in enumerate(_prompts(lens))])
    assert eng.stats["spans"]["engine.prefill"]["n"] == 1
    assert eng.stats["prefill_calls"] == 2
    assert len({r.t_admit for r in done}) == 1
    assert [r.prefill_slots for r in sorted(done, key=lambda r: r.rid)] \
        == [16.0, 16.0, 1008.0, 16.0, 16.0, 16.0, 16.0]
    assert sum(r.prefill_tokens for r in done) == sum(lens)


def test_engine_spans_in_a_profiler_trace():
    from torch.profiler import ProfilerActivity, profile
    eng = _engine()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run([Request(rid=0, prompt=_prompts([9])[0], max_new_tokens=6)])
    keys = {e.key for e in prof.key_averages()}
    assert {"engine.iteration", "engine.admit", "engine.prefill",
            "engine.link", "engine.fetch", "engine.deliver",
            "model.step"} <= keys


def _family_engine(family):
    """A tiny engine of ``family`` on the CPU (2 slots, links of 4) and
    the module of its device entries."""
    if family == "gpt2":
        cfg = port_cfg()
        params = params_np(cfg, seed=0)
        page = PageConfig(page_size=8, num_pages=40, max_seqs=2,
                          pages_per_seq=8)
        module = gpt2_paged
    else:
        cfg = MellumConfig.tiny()
        params = mellum.init_params(cfg, torch.Generator().manual_seed(1),
                                    device="cpu", std=0.1)
        page = PageConfig(page_size=4, num_pages=48, max_seqs=2,
                          pages_per_seq=20)
        module = mellum_paged
    econf = EngineConfig(page=page, max_batch=2, greedy=True, decode_chunk=4)
    return InferenceEngine(params, cfg, econf, device="cpu"), module


@pytest.mark.parametrize("family", ["gpt2", "mellum"])
def test_entries_wrapped_after_the_engine_is_built_are_called(family,
                                                              monkeypatch):
    """The benchmark's spans replace the family's three device entries
    and engine._fetch on their modules after the engine is built: the
    engine looks each up at every call. A host-sampled row takes single
    steps while it runs, then the greedy row chains alone."""
    eng, module = _family_engine(family)
    calls = collections.Counter()

    def count(mod, name):
        real = getattr(mod, name)

        def counted(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        monkeypatch.setattr(mod, name, counted)

    for name in ("prefill_paged", "decode_chunk_paged", "decode_step_paged"):
        count(module, name)
    count(engine_mod, "_fetch")
    a, b = ([t % 256 for t in p] for p in _prompts([9, 6]))
    done = eng.run([Request(rid=0, prompt=a, max_new_tokens=14),
                    Request(rid=1, prompt=b, max_new_tokens=3, greedy=False)])
    assert sorted(len(r.generated) for r in done) == [3, 14]
    assert set(calls) == {"prefill_paged", "decode_chunk_paged",
                          "decode_step_paged", "_fetch"}
    assert calls["decode_step_paged"] == eng.stats["single_steps"]


# -- the benchmark's readers --------------------------------------------------

def _req(t_submit, t_admit, tokens=0, slots=0.0):
    return types.SimpleNamespace(t_submit=t_submit, t_admit=t_admit,
                                 prefill_tokens=tokens, prefill_slots=slots)


def _metric(name):
    return Registry().metric(name).compute


def _record(requests, stats=None):
    return {"t_open": 10.0, "t_close": 20.0, "seconds": 10.0,
            "requests": requests, "stats": stats or {}}


@pytest.mark.parametrize("kind", ["chat", "score"])
def test_queue_wait_p95_over_requests_admitted_in_the_window(kind):
    f = _metric(f"queue_wait_p95_s.{kind}")
    reqs = [_req(9.0, 12.0)]                              # waited 3
    reqs += [_req(10.0 + i, 10.0 + i) for i in range(9)]  # waited 0
    reqs += [_req(1.0, 9.0), _req(15.0, 21.0), _req(5.0, None)]  # outside
    want = float(np.percentile([3.0] + [0.0] * 9, 95))
    assert f(_record(reqs)) == pytest.approx(want)
    assert f(_record(reqs[-3:])) is None
    # a program without the admission stamp
    plain = types.SimpleNamespace(t_submit=11.0)
    assert f(_record([plain])) is None


@pytest.mark.parametrize("kind", ["chat", "score"])
def test_prefill_pad_share_over_requests_admitted_in_the_window(kind):
    f = _metric(f"prefill_pad_share.{kind}")
    # the hand-built wave: 58 real tokens in 192 slots
    wave = [_req(10.5, 11.0, n, 64.0) for n in (5, 20, 33)]
    outside = [_req(1.0, 2.0, 10, 1000.0)]
    assert f(_record(wave + outside)) == pytest.approx(
        100.0 * (1.0 - 58 / 192))
    assert f(_record(outside)) is None
    assert f(_record([types.SimpleNamespace(t_submit=11.0)])) is None


def test_host_ms_per_step_reads_the_model_step_span():
    f = _metric("host_ms_per_step.chat")
    stats = {"spans": {"model.step": {"n": 64, "s": 4.48, "self_s": 4.48}}}
    assert f(_record([], stats)) == pytest.approx(70.0)
    assert f(_record([], {"spans": {}})) is None
    assert f(_record([], {"decode_steps": 3})) is None
