"""The port's serving front on the CPU (engine/server.py, engine/http_server.py,
InferenceEngine.run's feed/on_tokens loop), mirroring the JAX package's
test_serving.py, test_cancel.py, test_http_server.py, test_serving_fuzz.py
and the HTTP cases of test_logprobs.py and test_request_sampling.py:
ServingEngine and HTTP results equal the port's batch run, streams
concatenate to it, backpressure raises QueueFull (HTTP 503 with
Retry-After), a cancel frees the slot, a client disconnect cancels its
stream, TTFT includes queue time, and a randomized schedule keeps the
greedy-prefix invariants. One case holds the served greedy streams to
the JAX package's batch run."""

import json
import random
import socket
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import CancelledError

import numpy as np
import pytest

from llmc_paged_tpu_torch import convert
from llmc_paged_tpu_torch.config import EngineConfig, PageConfig
from llmc_paged_tpu_torch.engine.engine import InferenceEngine
from llmc_paged_tpu_torch.engine.http_server import HttpServingFront
from llmc_paged_tpu_torch.engine.scheduler import Request, Scheduler, State
from llmc_paged_tpu_torch.engine.server import QueueFull, ServingEngine
from llmc_paged_tpu_torch.tokenizer import Tokenizer, byte_fallback_table
from test_torch_common import one_thread  # noqa: F401
from test_torch_common import params_np, port_cfg

pytestmark = pytest.mark.usefixtures("one_thread")

V = port_cfg().vocab_size
# a page table as long as the model's context (128 tokens)
LONG = dict(num_pages=80, pages_per_seq=16)


@pytest.fixture(scope="module")
def weights():
    return params_np(port_cfg(), seed=0)


@pytest.fixture(scope="module")
def params(weights):
    return convert.params_from_numpy(weights, port_cfg(), device="cpu")


def _engine(params, page_kw=None, **kw):
    page = PageConfig(**{**dict(page_size=8, num_pages=48, max_seqs=8,
                                pages_per_seq=10), **(page_kw or {})})
    econf = EngineConfig(**{**dict(cache_mode="paged", page=page,
                                   greedy=True, max_batch=3,
                                   decode_chunk=4), **kw})
    return InferenceEngine(params, port_cfg(), econf, device="cpu")


def _prompts(n, lo=3, hi=12, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V, int(ln)).tolist()
            for ln in rng.integers(lo, hi, n)]


def _batch(params, prompts, new, **kw):
    eng = _engine(params, **kw)
    done = eng.run([Request(rid=i, prompt=list(p), max_new_tokens=new)
                    for i, p in enumerate(prompts)])
    return {r.rid: r.tokens for r in done}


def _post(url, payload, timeout=120):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


# ---- ServingEngine -----------------------------------------------------

def test_serving_matches_batch_run(params):
    """Staggered submissions give exactly the tokens of one batch run."""
    prompts = _prompts(8)
    expect = _batch(params, prompts, 9)
    with ServingEngine(_engine(params)) as srv:
        futs = {}
        for i, p in enumerate(prompts):
            futs[i] = srv.submit(p, 9, rid=i)
            if i % 3 == 2:
                time.sleep(0.05)           # arrive while others decode
        got = {i: f.result(timeout=120) for i, f in futs.items()}
    assert got == expect


def test_serving_greedy_streams_equal_jax(weights, params):
    """Served greedy and penalized greedy requests give the JAX
    package's batch-run tokens (fp32, JAX without its kernels)."""
    from llmc_paged_tpu.config import EngineConfig as JEngineConfig
    from llmc_paged_tpu.config import PageConfig as JPageConfig
    from llmc_paged_tpu.engine.engine import InferenceEngine as JEngine
    from llmc_paged_tpu.engine.scheduler import Request as JRequest
    from test_torch_common import jax_cfg
    prompts = _prompts(4, seed=11)
    pens = [dict(), dict(frequency_penalty=0.6), dict(),
            dict(presence_penalty=0.8)]
    page = JPageConfig(page_size=8, num_pages=48, max_seqs=8,
                       pages_per_seq=10)
    je = JEngine(weights, jax_cfg(), JEngineConfig(
        cache_mode="paged", page=page, greedy=True, max_batch=3,
        decode_chunk=4), use_kernel=False)
    expect = {r.rid: r.tokens for r in je.run(
        [JRequest(rid=i, prompt=list(p), max_new_tokens=8, **pens[i])
         for i, p in enumerate(prompts)])}
    with ServingEngine(_engine(params)) as srv:
        futs = [srv.submit(p, 8, rid=i, **pens[i])
                for i, p in enumerate(prompts)]
        got = {i: f.result(timeout=120) for i, f in enumerate(futs)}
    assert got == expect


def test_serving_submission_validation_fails_future_only(params):
    with ServingEngine(_engine(params)) as srv:
        bad = srv.submit(list(range(60)), 10_000)   # > max_context
        with pytest.raises(ValueError, match="max_context"):
            bad.result(timeout=10)
        empty = srv.submit([], 8)
        with pytest.raises(ValueError, match="empty prompt"):
            empty.result(timeout=10)
        bad_t = srv.submit([1, 2], 4, temperature=float("nan"))
        with pytest.raises(ValueError, match="temperature"):
            bad_t.result(timeout=10)
        ok = srv.submit(_prompts(1)[0], 5)
        assert len(ok.result(timeout=120)) > 0


def test_serving_close_semantics(params):
    srv = ServingEngine(_engine(params, max_batch=2))
    futs = [srv.submit(p, 6) for p in _prompts(5)]
    srv.close()                             # drains everything submitted
    for f in futs:
        assert len(f.result(timeout=120)) > 0
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit([1, 2, 3], 4)


def test_serving_with_prefix_cache_and_spec(params):
    """The loop composes with prefix caching and speculative decode;
    repeated system prompts hit the cache across arrivals."""
    page_kw = dict(num_pages=64, pages_per_seq=12, prefix_cache=True)
    rng = np.random.default_rng(3)
    sysp = rng.integers(0, V, 24).tolist()
    prompts = [sysp + rng.integers(0, V, int(n)).tolist()
               for n in (4, 7, 5, 6, 8, 3)]
    expect = _batch(params, prompts, 8, page_kw=page_kw, spec_k=3)
    eng = _engine(params, page_kw=page_kw, spec_k=3)
    with ServingEngine(eng) as srv:
        futs = {}
        for i, p in enumerate(prompts):
            futs[i] = srv.submit(p, 8, rid=i)
            time.sleep(0.03)
        got = {i: f.result(timeout=120) for i, f in futs.items()}
    assert got == expect
    assert eng.stats["prefix_hit_pages"] > 0


def test_serving_stream_tokens(params):
    """submit_stream yields batches that concatenate to the batch-run
    stream, in several flushes (stream_links caps the chain)."""
    prompts = _prompts(2)
    kw = dict(max_batch=4, decode_chunk=2, stream_links=2)
    expect = _batch(params, prompts, 24, **kw)
    with ServingEngine(_engine(params, **kw)) as srv:
        it = srv.submit_stream(prompts[0], 24, rid=0)
        fut = srv.submit(prompts[1], 24, rid=1)
        batches = list(it)
        assert list(prompts[0]) + [t for b in batches for t in b] == expect[0]
        assert len(batches) >= 3, batches
        assert fut.result(timeout=120) == expect[1]
        with pytest.raises(ValueError, match="max_context"):
            srv.submit_stream(list(range(60)), 10_000)


def test_serving_device_sampling_streams(params):
    """Under device sampling a served top_k=1 request equals the greedy
    batch run; sampled requests finish with their budget; a stream of a
    sampled request concatenates to its final tokens."""
    prompts = _prompts(3)
    expect = _batch(params, prompts, 10)
    eng = _engine(params, device_sampling=True, greedy=False, top_k=20,
                  temperature=0.9)
    with ServingEngine(eng) as srv:
        f0 = srv.submit(prompts[0], 10, top_k=1)
        f1 = srv.submit(prompts[1], 10, logprobs=True)
        it = srv.submit_stream(prompts[2], 10)
        streamed = [t for b in it for t in b]
        assert f0.result(timeout=120) == expect[0]
        assert len(f1.result(timeout=120)) == len(prompts[1]) + 10
        assert len(f1.request.logprob_values) == 10
        assert it.request.generated == streamed and len(streamed) == 10


def test_serving_backpressure_max_pending(params):
    with ServingEngine(_engine(params, max_batch=2), max_pending=2) as srv:
        futs = [srv.submit(p, 30) for p in _prompts(2)]
        with pytest.raises(QueueFull, match="max_pending"):
            srv.submit(_prompts(1, seed=3)[0], 5)
        with pytest.raises(QueueFull, match="max_pending"):
            srv.submit_stream(_prompts(1, seed=3)[0], 5)
        for f in futs:
            assert len(f.result(timeout=300)) > 0
        ok = srv.submit(_prompts(1, seed=4)[0], 5)   # capacity freed
        assert len(ok.result(timeout=120)) > 0


def test_ttft_includes_queue_time(params):
    """t_submit stamped at enqueue survives Scheduler.submit; a request
    that queued behind a busy slot reports a TTFT that covers the wait."""
    sched = Scheduler(max_batch=2)
    early = time.monotonic() - 5.0
    r = Request(rid=0, prompt=[1], max_new_tokens=1)
    r.t_submit = early                      # the serving front's stamp
    sched.submit(r)
    assert r.t_submit == early
    r2 = Request(rid=1, prompt=[1], max_new_tokens=1)
    sched.submit(r2)
    assert r2.t_submit > early
    with ServingEngine(_engine(params, max_batch=1)) as srv:
        first = srv.submit(_prompts(1)[0], 40)
        t0 = time.monotonic()
        queued = srv.submit(_prompts(1, seed=5)[0], 2)
        queued.result(timeout=120)
        first.result(timeout=120)
        req = queued.request
        assert req.t_submit >= t0
        assert req.ttft >= first.request.t_done - req.t_submit - 1e-6


def test_live_stats_snapshot(params):
    eng = _engine(params)
    with ServingEngine(eng) as srv:
        srv.submit(_prompts(1)[0], 6).result(timeout=120)
        st = srv.stats()
    assert st["finished_total"] == 1 and st["decode_tokens"] == 5
    assert st["pages_free"] == 48 and st["pending_futures"] == 0


# ---- cancellation --------------------------------------------------------

def test_cancel_running_stream_is_prefix_and_frees_slot(params):
    prompts = _prompts(2)
    kw = dict(max_batch=1, decode_chunk=2, stream_links=2, page_kw=LONG)
    full = _batch(params, prompts, 100, **kw)
    with ServingEngine(_engine(params, **kw)) as srv:
        it = srv.submit_stream(prompts[0], 100, rid=0)
        got = list(next(it))                    # first flush arrived
        assert it.cancel() is True
        for batch in it:                        # drains to DONE
            got.extend(batch)
        assert 0 < len(got) < 100
        assert list(prompts[0]) + got == full[0][: len(prompts[0]) + len(got)]
        # the slot freed: a second request decodes to completion
        assert srv.submit(prompts[1], 100, rid=1).result(timeout=300) == \
            full[1]


def test_cancel_queued_request(params):
    with ServingEngine(_engine(params, max_batch=1, decode_chunk=2)) as srv:
        running = srv.submit(_prompts(1)[0], 60, rid=0)
        queued = srv.submit(_prompts(1, seed=3)[0], 60, rid=1)
        assert srv.cancel(1) is True
        with pytest.raises(CancelledError):
            queued.result(timeout=120)
        assert queued.request.generated == []
        assert len(running.result(timeout=300)) > 0


def test_cancel_finished_or_unknown_returns_false(params):
    with ServingEngine(_engine(params)) as srv:
        fut = srv.submit(_prompts(1)[0], 4)
        toks = fut.result(timeout=120)
        assert srv.cancel(fut.rid) is False
        assert fut.result() == toks
        assert srv.cancel(10_000) is False


def test_engine_level_cancel_via_on_tokens(params):
    """Request.cancelled is honoured by run() directly: a row cancelled
    from on_tokens finishes early; the other rows are untouched."""
    prompts = _prompts(3)
    kw = dict(max_batch=4, decode_chunk=2, stream_links=2)
    full = _batch(params, prompts, 40, **kw)

    def on_tokens(req, new):
        if req.rid == 0 and len(req.generated) >= 4:
            req.cancelled = True

    reqs = [Request(rid=i, prompt=list(p), max_new_tokens=40,
                    stream=(i == 0)) for i, p in enumerate(prompts)]
    done = {r.rid: r for r in _engine(params, **kw).run(reqs,
                                                         on_tokens=on_tokens)}
    assert done[0].state is State.DONE and done[0].cancelled
    assert 4 <= len(done[0].generated) < 40
    assert done[0].tokens == full[0][: len(done[0].tokens)]
    for rid in (1, 2):
        assert done[rid].tokens == full[rid]


def test_precancelled_request_finishes_with_t_done(params):
    req = Request(rid=0, prompt=[1, 2, 3], max_new_tokens=5)
    req.cancelled = True
    done = _engine(params).run([req])
    assert done[0] is req and req.state is State.DONE
    assert req.t_done is not None and req.generated == []


# ---- HTTP ------------------------------------------------------------------

def test_http_generate_concurrent_matches_batch(params):
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, V, int(n)).tolist() for n in (5, 8, 4, 7)]
    expect = _batch(params, prompts, 6)
    tok = Tokenizer(byte_fallback_table(V))
    with ServingEngine(_engine(params)) as srv, \
            HttpServingFront(srv, port=0, tokenizer=tok) as front:
        url = f"http://{front.host}:{front.port}"
        with urllib.request.urlopen(f"{url}/health", timeout=30) as r:
            assert json.loads(r.read())["status"] == "ok"
        results = {}

        def call(i):
            results[i] = _post(f"{url}/generate",
                               {"prompt": prompts[i], "max_new_tokens": 6})

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for i, (status, out, _) in results.items():
            assert status == 200 and out["tokens"] == expect[i]
            assert out["generated"] == expect[i][len(prompts[i]):]
            assert isinstance(out["text"], str)
        for payload in ({"prompt": "not ids"},
                        {"prompt": [1, 2], "max_new_tokens": 10_000},
                        [1, 2, 3], "x",
                        {"prompt": [1], "max_new_tokens": None},
                        {"prompt": []},
                        {"prompt": [1], "logprobs": "false"},
                        {"prompt": [1], "priority": 1.5},
                        {"prompt": [1], "greedy": "yes"},
                        {"prompt": [1], "temperature": -2},
                        {"prompt": [1], "frequency_penalty": "x"}):
            status, out, _ = _post(f"{url}/generate", payload)
            assert status == 400 and "error" in out, payload
        # streaming: ndjson lines concatenating to the same tokens
        sreq = urllib.request.Request(
            f"{url}/generate",
            data=json.dumps({"prompt": prompts[0], "max_new_tokens": 6,
                             "stream": True}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(sreq, timeout=120) as r:
            assert r.headers["Content-Type"] == "application/x-ndjson"
            lines = [json.loads(ln) for ln in r.read().splitlines()]
        assert lines[-1]["done"] is True
        streamed = [t for ln in lines[:-1] for t in ln["tokens"]]
        assert streamed == expect[0][len(prompts[0]):] == \
            lines[-1]["generated"]
        with urllib.request.urlopen(f"{url}/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["finished_total"] >= len(prompts) + 1
        assert stats["running"] == 0 and stats["pending_futures"] == 0


def test_http_unknown_paths_404(params):
    with ServingEngine(_engine(params)) as srv, \
            HttpServingFront(srv, port=0) as front:
        url = f"http://{front.host}:{front.port}"
        for method, path in (("GET", "/nope"), ("POST", "/nope"),
                             ("POST", "/health")):
            req = urllib.request.Request(
                f"{url}{path}", method=method,
                data=b"{}" if method == "POST" else None)
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(req, timeout=30)
            assert exc.value.code == 404
            assert "error" in json.loads(exc.value.read())


def test_http_queue_full_503_retry_after(params):
    prompt = [3, 1, 4, 1, 5]
    with ServingEngine(_engine(params), max_pending=1) as srv, \
            HttpServingFront(srv, port=0) as front:
        url = f"http://{front.host}:{front.port}/generate"
        blocker = srv.submit(prompt, 64)
        for extra in ({}, {"stream": True}):
            status, out, headers = _post(url, {"prompt": prompt,
                                               "max_new_tokens": 4, **extra})
            assert status == 503 and "error" in out
            assert headers.get("Retry-After") == "1"
        blocker.result(timeout=120)
        status, out, _ = _post(url, {"prompt": prompt, "max_new_tokens": 4})
        assert status == 200 and len(out["generated"]) == 4


def test_http_stream_client_disconnect_cancels(params):
    """A client dropping mid-stream cancels its request: decode stops
    early, the pages free, and the loop keeps serving (max_batch 1, so
    the next request needs the slot back)."""
    prompts = _prompts(2)
    kw = dict(max_batch=1, decode_chunk=2, stream_links=2, page_kw=LONG)
    expect = _batch(params, prompts[1:], 30, **kw)[0]
    eng = _engine(params, **kw)
    with ServingEngine(eng) as srv, HttpServingFront(srv, port=0) as front:
        url = f"http://{front.host}:{front.port}"
        body = json.dumps({"prompt": prompts[0], "max_new_tokens": 75,
                           "stream": True}).encode()
        s = socket.create_connection((front.host, front.port), timeout=60)
        s.sendall(b"POST /generate HTTP/1.1\r\nHost: t\r\n"
                  b"Content-Type: application/json\r\n"
                  + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        buf = b""
        while b"\"tokens\"" not in buf:
            chunk = s.recv(4096)
            assert chunk, "stream closed before its first token line"
            buf += chunk
        s.close()
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            st = srv.stats()
            if st["open_streams"] == 0 and st["running"] == 0:
                break
            time.sleep(0.02)
        else:
            raise AssertionError(f"stream never cleaned up: {st}")
        assert st["decode_tokens"] < 75 - 1
        assert st["pages_free"] == eng.econf.page.num_pages
        status, out, _ = _post(f"{url}/generate",
                               {"prompt": prompts[1], "max_new_tokens": 30})
        assert status == 200 and out["tokens"] == expect


def test_http_logprobs_and_sampling(params):
    """logprobs and prompt_logprobs over HTTP equal the batch run's; a
    top_k=1 request on a sampled engine equals the greedy run; penalties
    pass through."""
    prompts = _prompts(2)
    eng_b = _engine(params)
    done = {r.rid: r for r in eng_b.run([
        Request(rid=0, prompt=list(prompts[0]), max_new_tokens=6,
                logprobs=True, prompt_logprobs=True),
        Request(rid=1, prompt=list(prompts[1]), max_new_tokens=6,
                frequency_penalty=0.5)])}
    for ds in (False, True):
        eng = _engine(params, greedy=False, device_sampling=ds)
        with ServingEngine(eng) as srv, \
                HttpServingFront(srv, port=0) as front:
            url = f"http://{front.host}:{front.port}/generate"
            status, out, _ = _post(url, {
                "prompt": prompts[0], "max_new_tokens": 6, "greedy": True,
                "logprobs": True, "prompt_logprobs": True})
            assert status == 200 and out["tokens"] == done[0].tokens
            np.testing.assert_allclose(out["logprobs"],
                                       done[0].logprob_values, atol=1e-5)
            np.testing.assert_allclose(out["prompt_logprobs"],
                                       done[0].prompt_logprob_values,
                                       atol=1e-5)
            status, out, _ = _post(url, {"prompt": prompts[0],
                                         "max_new_tokens": 6, "top_k": 1})
            assert status == 200 and out["tokens"] == done[0].tokens
            status, out, _ = _post(url, {"prompt": prompts[1],
                                         "max_new_tokens": 6, "greedy": True,
                                         "frequency_penalty": 0.5})
            assert status == 200 and out["tokens"] == done[1].tokens


# ---- randomized schedule -----------------------------------------------------

@pytest.mark.parametrize("seed", [42, 7])
def test_serving_fuzz_invariants(params, seed):
    """Staggered arrivals, stops, priorities, logprobs, streams, penalty
    and sampled rows and asynchronous cancels over a pool small enough to
    preempt: every plain row is a prefix of its reference greedy stream
    and ends at its first stop (or budget) unless cancelled, streams
    concatenate to the final tokens, logprobs stay aligned, every future
    resolves, and the pool drains."""
    n_reqs, max_new = 14, 14
    page_kw = dict(num_pages=14, max_seqs=3, pages_per_seq=6)
    kw = dict(page_kw=page_kw, decode_chunk=4, stream_links=2)
    rng = np.random.default_rng(seed)
    pyrng = random.Random(seed)
    prompts = [rng.integers(0, V, int(n)).tolist()
               for n in rng.integers(3, 14, n_reqs)]
    ref_eng = _engine(params, **kw)
    ref = {}
    for start in range(0, n_reqs, 3):
        done = ref_eng.run([Request(rid=i, prompt=list(prompts[i]),
                                    max_new_tokens=max_new)
                            for i in range(start, min(start + 3, n_reqs))])
        ref.update({r.rid: r.generated for r in done})
    plans = []
    for i in range(n_reqs):
        stop = None
        if pyrng.random() < 0.4:
            stop = ([int(pyrng.choice(ref[i]))] if pyrng.random() < 0.5
                    else [int(rng.integers(0, V))])
        plans.append(dict(
            stop=stop, priority=pyrng.choice([0, 0, 0, 1, 5]),
            logprobs=pyrng.random() < 0.3, stream=pyrng.random() < 0.3,
            penalty=(round(pyrng.uniform(0.2, 1.0), 2)
                     if pyrng.random() < 0.2 else 0.0),
            override=pyrng.random() < 0.15,
            cancel_after_s=(pyrng.uniform(0.0, 0.3)
                            if pyrng.random() < 0.2 else None)))
    eng = _engine(params, device_sampling=True, **kw)
    stream_batches, threads, reqs, outcome = {}, [], {}, {}
    with ServingEngine(eng) as srv:
        handles = {}
        for i, plan in enumerate(plans):
            skw = dict(stop_tokens=plan["stop"], priority=plan["priority"],
                       logprobs=plan["logprobs"],
                       frequency_penalty=plan["penalty"])
            if plan["override"]:
                skw.update(greedy=False, temperature=0.9, top_k=20)
            if plan["stream"]:
                h = srv.submit_stream(prompts[i], max_new, rid=i, **skw)
                stream_batches[i] = []

                def drain(h=h, i=i):
                    for b in h:
                        stream_batches[i].append(list(b))

                t = threading.Thread(target=drain)
                t.start()
                threads.append(t)
            else:
                h = srv.submit(prompts[i], max_new, rid=i, **skw)
            handles[i] = h
            if plan["cancel_after_s"] is not None:
                def later(rid=i, delay=plan["cancel_after_s"]):
                    time.sleep(delay)
                    srv.cancel(rid)

                t = threading.Thread(target=later)
                t.start()
                threads.append(t)
            if pyrng.random() < 0.5:
                time.sleep(pyrng.uniform(0.0, 0.04))
        for i, h in handles.items():
            if not plans[i]["stream"]:
                try:
                    h.result(timeout=300)
                    outcome[i] = "ok"
                except CancelledError:
                    outcome[i] = "cancelled"
            reqs[i] = h.request
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        st = srv.stats()
    for i in range(n_reqs):
        r, plan = reqs[i], plans[i]
        gen = r.generated
        perturbed = plan["penalty"] or plan["override"]
        if not perturbed:
            assert gen == ref[i][: len(gen)], (i, gen, ref[i])
        if not r.cancelled and not perturbed:
            hits = [k for k, t in enumerate(ref[i])
                    if plan["stop"] and t in plan["stop"]]
            assert len(gen) == ((hits[0] + 1) if hits else max_new)
        if r.cancelled:
            assert outcome.get(i, "cancelled") == "cancelled"
        else:
            assert len(gen) <= max_new and outcome.get(i, "ok") == "ok"
        if plan["stream"]:
            flushed = [t for b in stream_batches[i] for t in b]
            assert flushed == gen[: len(flushed)]
            if not r.cancelled:
                assert flushed == gen
        if plan["logprobs"]:
            assert len(r.logprob_values) == len(gen)
    assert st["running"] == st["waiting"] == 0
    assert st["pages_free"] == page_kw["num_pages"]
    assert st["pending_futures"] == st["open_streams"] == 0
