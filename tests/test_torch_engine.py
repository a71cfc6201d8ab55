"""engine/ of the port against the JAX package's engine on the CPU: the
paged run() must give EXACTLY the same token streams (fp32, greedy, JAX
with use_kernel=False) under admission pressure, preemption, a sliding
window and stop tokens, with the same scheduling statistics."""

import dataclasses

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

LENS = (5, 17, 9, 30, 3, 12)


def _prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(0, 512, size=n).tolist() for n in LENS]


def _econf(mod_page, mod_engine, num_pages):
    page = mod_page(page_size=8, num_pages=num_pages, max_seqs=4,
                    pages_per_seq=8)
    return mod_engine(cache_mode="paged", page=page, greedy=True,
                      max_batch=4, decode_chunk=4)


@pytest.fixture(scope="module")
def weights():
    return params_np(port_cfg(), seed=0)


def _both(weights, num_pages, new, window=None, stops=None):
    """The same requests through both engines; returns both runs."""
    je = JEngine(weights, jax_cfg(),
                 _econf(JPageConfig, JEngineConfig, num_pages),
                 use_kernel=False)
    te = TEngine(weights, port_cfg(),
                 _econf(TPageConfig, TEngineConfig, num_pages), device="cpu")
    runs = []
    for eng, R in ((je, JRequest), (te, TRequest)):
        reqs = [R(rid=i, prompt=list(p), max_new_tokens=new,
                  stop_tokens=stops) for i, p in enumerate(_prompts())]
        done = eng.run(reqs, window=window)
        runs.append(({r.rid: r.generated for r in done}, eng.stats))
    return runs


CASES = {
    # 6 requests through 4 slots: a second admission wave
    "queue": dict(num_pages=20, new=20),
    # 8 pages for 4 slots: LRU preemption and requeue
    "preempt": dict(num_pages=8, new=10),
    # a 16-token window: masked pages, clamped positions, reclamation
    "window": dict(num_pages=20, new=40, window=16),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_streams_equal_jax(weights, case):
    (js, jstats), (ts, tstats) = _both(weights, **CASES[case])
    assert ts == js
    assert all(len(v) == CASES[case]["new"] for v in ts.values())
    for k in ("decode_tokens", "preemptions", "peak_pages_used"):
        assert tstats[k] == jstats[k], k
    if case == "preempt":
        assert tstats["preemptions"] >= 1
    assert tstats["decode_steps"] > 0


def test_run_stop_tokens_equal_jax(weights):
    """Stop ids taken from the unstopped stream: requests end at their
    first stop id (kept) in both engines, the chain overshoot discarded."""
    (base, _), _ = _both(weights, num_pages=20, new=20)
    stops = sorted({g[5] for g in base.values()})[:2]
    (js, jstats), (ts, tstats) = _both(weights, num_pages=20, new=20,
                                       stops=stops)
    assert ts == js
    assert any(len(v) < 20 for v in ts.values())
    assert all(v[-1] in stops or len(v) == 20 for v in ts.values())
    assert tstats["decode_tokens"] == jstats["decode_tokens"]


def test_engine_counts_one_launch_per_layer_and_step(weights):
    """decode_steps counts device decode steps: each runs one paged
    attention call per layer (the launch count chip_smoke.py checks on
    the card)."""
    import llmc_paged_tpu_torch.models.gpt2_paged as gp
    from llmc_paged_tpu_torch.ops import paged_attention as pa
    calls = []
    orig = pa.paged_decode_attention_parts

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    # the chunk path calls it through gpt2_paged, the single step through
    # the normalized wrapper in paged_attention
    gp.paged_decode_attention_parts = pa.paged_decode_attention_parts = \
        counting
    try:
        te = TEngine(weights, port_cfg(),
                     _econf(TPageConfig, TEngineConfig, 9), device="cpu")
        te.run([TRequest(rid=i, prompt=list(p), max_new_tokens=9)
                for i, p in enumerate(_prompts())])
    finally:
        gp.paged_decode_attention_parts = pa.paged_decode_attention_parts = \
            orig
    assert len(calls) == port_cfg().num_layers * te.stats["decode_steps"]


def test_run_reuses_the_pool_and_validates(weights):
    te = TEngine(weights, port_cfg(),
                 dataclasses.replace(_econf(TPageConfig, TEngineConfig, 20),
                                     debug_checks=True), device="cpu")
    a = te.run([TRequest(rid=0, prompt=[1, 2, 3], max_new_tokens=6)])
    b = te.run([TRequest(rid=0, prompt=[1, 2, 3], max_new_tokens=6)])
    assert a[0].generated == b[0].generated
    with pytest.raises(ValueError, match="empty prompt"):
        te.run([TRequest(rid=0, prompt=[], max_new_tokens=2)])
    with pytest.raises(ValueError, match="max_context"):
        te.run([TRequest(rid=0, prompt=[1] * 60, max_new_tokens=10)])
    done = te.run([TRequest(rid=0, prompt=[1], max_new_tokens=0)])
    assert done[0].generated == []
