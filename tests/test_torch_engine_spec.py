"""Speculative decode and prefix caching in the port's engine against the
JAX package's engine on the CPU (fp32, greedy, JAX with use_kernel=False):
the token streams must be EXACTLY the same, with the same acceptance and
prefix-hit statistics, for spec_k alone, prefix caching over two runs,
both together, prefix caching under pool pressure (cached-page reclaim
and preemption), a preempted request re-admitted onto its own pages, and
a row with no headroom for a speculative reservation. Also the guards:
no sliding window under either option, spec_k only with greedy serving.
"""

import numpy as np
import pytest

from llmc_paged_tpu.config import EngineConfig as JEngineConfig
from llmc_paged_tpu.config import PageConfig as JPageConfig
from llmc_paged_tpu.engine.engine import InferenceEngine as JEngine
from llmc_paged_tpu.engine.scheduler import Request as JRequest
from llmc_paged_tpu_torch.config import EngineConfig as TEngineConfig
from llmc_paged_tpu_torch.config import PageConfig as TPageConfig
from llmc_paged_tpu_torch.engine.engine import InferenceEngine as TEngine
from llmc_paged_tpu_torch.engine.scheduler import Request as TRequest
from test_torch_common import jax_cfg, params_np, port_cfg

SPEC_STATS = ("spec_steps", "spec_tok_per_step")
PREFIX_STATS = ("prefix_hit_tokens", "prefix_hit_pages",
                "prefix_pages_registered", "prefix_cached_pages")
SMALL = dict(vocab_size=32, num_heads=4, channels=32)


def _prompts(kind):
    rng = np.random.default_rng(11)
    if kind == "repeat":        # prompt-lookup traffic: drafts accept
        segs = [rng.integers(0, 32, n).tolist() for n in (4, 5, 3, 6, 4, 5)]
        return [(s * 8)[: 10 + 2 * i] for i, s in enumerate(segs)]
    # a shared 24-token system prompt (3 full pages at ps 8) + own tails
    sys_prompt = rng.integers(0, 32, 24).tolist()
    return [sys_prompt + rng.integers(0, 32, n).tolist()
            for n in (5, 9, 3, 7, 6, 4)]


@pytest.fixture(scope="module")
def weights():
    return params_np(port_cfg(**SMALL), seed=2)


def _econf(mod_page, mod_engine, *, num_pages=48, prefix=False, spec_k=0,
           max_batch=3, pps=10, max_seqs=8, decode_chunk=4):
    page = mod_page(page_size=8, num_pages=num_pages, max_seqs=max_seqs,
                    pages_per_seq=pps, prefix_cache=prefix)
    return mod_engine(cache_mode="paged", page=page, greedy=True,
                      max_batch=max_batch, decode_chunk=decode_chunk,
                      spec_k=spec_k)


def _both(weights, prompts, new, runs=1, order=False, **kw):
    """The same requests through both engines, ``runs`` times on one
    engine each; returns per engine the list of (streams, stats) and,
    with ``order``, the order in which requests finished."""
    out = []
    for eng, R in ((JEngine(weights, jax_cfg(**SMALL),
                            _econf(JPageConfig, JEngineConfig, **kw),
                            use_kernel=False), JRequest),
                   (TEngine(weights, port_cfg(**SMALL),
                            _econf(TPageConfig, TEngineConfig, **kw),
                            device="cpu"), TRequest)):
        res = []
        for _ in range(runs):
            fin = []
            new_l = new if isinstance(new, list) else [new] * len(prompts)
            done = eng.run([R(rid=i, prompt=list(p), max_new_tokens=n)
                            for i, (p, n) in enumerate(zip(prompts, new_l))],
                           on_finish=(lambda r: fin.append(r.rid))
                           if order else None)
            res.append(({r.rid: r.generated for r in done}, dict(eng.stats),
                        fin))
        out.append(res)
    return out


def _check(jruns, truns, keys):
    for (js, jst, jfin), (ts, tst, tfin) in zip(jruns, truns):
        assert ts == js
        assert tfin == jfin
        for k in ("decode_tokens", "preemptions", "peak_pages_used") + keys:
            assert tst[k] == jst[k], (k, tst[k], jst[k])


CASES = {
    # 6 repetitive prompts through 3 slots, two admission waves
    "spec": dict(kind="repeat", new=20, kw=dict(spec_k=3),
                 keys=SPEC_STATS),
    # the second run adopts the first run's pages (cache + pool persist)
    "prefix": dict(kind="system", new=10, kw=dict(prefix=True), runs=2,
                   keys=PREFIX_STATS),
    "prefix+spec": dict(kind="system", new=10,
                        kw=dict(prefix=True, spec_k=3), runs=2,
                        keys=PREFIX_STATS + SPEC_STATS),
    # 13 pages: cached pages are reclaimed and rows are preempted
    "prefix_pressure": dict(kind="system", new=12,
                            kw=dict(prefix=True, num_pages=13), runs=2,
                            keys=PREFIX_STATS),
    "prefix+spec_pressure": dict(kind="repeat", new=16,
                                 kw=dict(prefix=True, spec_k=3,
                                         num_pages=12), runs=2,
                                 keys=PREFIX_STATS + SPEC_STATS),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_streams_and_stats_equal_jax(weights, case):
    c = CASES[case]
    jruns, truns = _both(weights, _prompts(c["kind"]), c["new"],
                         runs=c.get("runs", 1), **c["kw"])
    _check(jruns, truns, c["keys"])
    stats = truns[-1][1]
    if c["kw"].get("spec_k"):
        assert stats["spec_tok_per_step"] > 1.0, stats   # drafts accepted
        assert stats["verify_steps"] > 0
    if c["kw"].get("prefix"):
        assert stats["prefix_hit_pages"] > 0
        assert stats["suffix_prefills"] > 0
    if "pressure" in case:
        assert any(r[1]["preemptions"] > 0 for r in truns), truns


def test_prefix_preempted_readmission_equal_jax(weights):
    """A request whose known tokens (prompt + generated) re-enter the
    engine adopts its own previously registered pages: the same prompt
    twice on one engine, and a pool so small that a preempted row is
    re-admitted onto its own pages, both token-equal to JAX."""
    prompt = _prompts("system")[0]
    jruns, truns = _both(weights, [prompt], 8, runs=2, prefix=True)
    _check(jruns, truns, PREFIX_STATS)
    assert truns[1][1]["prefix_hit_pages"] >= 3
    prompts = _prompts("system")[:4]
    jruns, truns = _both(weights, prompts, 30, prefix=True, num_pages=9,
                         max_batch=4, pps=8)
    _check(jruns, truns, PREFIX_STATS)
    assert truns[0][1]["preemptions"] > 0


def test_spec_row_without_headroom_falls_through_equal_jax(weights):
    """max_context 32, S*spec_k = 6: row 0 (prompt 28, 4 new) can never
    take a speculative reservation and goes through the plain chain in
    the same iterations; it finishes first, as in the JAX engine."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 32, 28).tolist(),
               rng.integers(0, 32, 6).tolist()]
    jruns, truns = _both(weights, prompts, [4, 24], order=True, spec_k=3,
                         num_pages=16, max_batch=2, max_seqs=2, pps=4,
                         decode_chunk=2)
    _check(jruns, truns, SPEC_STATS)
    assert truns[0][2][0] == 0


def test_guards(weights):
    cfg = port_cfg(**SMALL)
    for kw, mode in ((dict(prefix=True), "prefix_cache"),
                     (dict(spec_k=3), "spec_k")):
        eng = TEngine(weights, cfg, _econf(TPageConfig, TEngineConfig, **kw),
                      device="cpu")
        with pytest.raises(ValueError, match=f"{mode} with sliding-window"):
            eng.run([TRequest(rid=0, prompt=list(range(20)),
                              max_new_tokens=30)], window=32)
        # a request that stays inside the window is served
        done = eng.run([TRequest(rid=0, prompt=list(range(10)),
                                 max_new_tokens=5)], window=32)
        assert len(done[0].generated) == 5
    import dataclasses
    econf = dataclasses.replace(_econf(TPageConfig, TEngineConfig, spec_k=3),
                                greedy=False)
    with pytest.raises(ValueError, match="spec_k requires greedy"):
        TEngine(weights, cfg, econf, device="cpu")
