"""Host sampling in the port's engine against the JAX package's engine on
the CPU (fp32, JAX with use_kernel=False): under the xorshift parity
sampler (Sampler(1337), top-k 40, temperature 0.8) the paged run() gives
EXACTLY the same token streams and scheduling statistics at page sizes 8
and 32, with a mix of per-request overrides, a sliding window and
preemption; greedy rows of a mixed batch keep the greedy stream."""

import numpy as np
import pytest

from llmc_paged_tpu.config import EngineConfig as JEngineConfig
from llmc_paged_tpu.config import PageConfig as JPageConfig
from llmc_paged_tpu.engine.engine import InferenceEngine as JEngine
from llmc_paged_tpu.engine.scheduler import Request as JRequest
from llmc_paged_tpu.sampler import Sampler as JSampler
from llmc_paged_tpu_torch.config import EngineConfig as TEngineConfig
from llmc_paged_tpu_torch.config import PageConfig as TPageConfig
from llmc_paged_tpu_torch.engine.engine import InferenceEngine as TEngine
from llmc_paged_tpu_torch.engine.scheduler import Request as TRequest
from llmc_paged_tpu_torch.sampler import Sampler as TSampler
from test_torch_common import jax_cfg, params_np, port_cfg

LENS = (5, 17, 9, 30, 3, 12)
# per-request overrides of the mixed cases (rid -> fields)
OVERRIDES = {1: dict(greedy=True), 3: dict(top_k=5),
             4: dict(temperature=0.0), 5: dict(top_k=20, temperature=1.2)}


def _prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(0, 512, size=n).tolist() for n in LENS]


@pytest.fixture(scope="module")
def weights():
    return params_np(port_cfg(), seed=0)


def _econf(mod_page, mod_engine, ps, num_pages, greedy=False):
    page = mod_page(page_size=ps, num_pages=num_pages, max_seqs=4,
                    pages_per_seq=128 // ps)
    return mod_engine(cache_mode="paged", page=page, greedy=greedy,
                      max_batch=4, decode_chunk=4)


def _both(weights, ps, num_pages, new, window=None, overrides=None,
          sampler_kw=None, greedy=False):
    """The same requests through both engines; returns both runs as
    ({rid: generated}, stats)."""
    engines = (
        (JEngine(weights, jax_cfg(),
                 _econf(JPageConfig, JEngineConfig, ps, num_pages, greedy),
                 use_kernel=False), JRequest, JSampler),
        (TEngine(weights, port_cfg(),
                 _econf(TPageConfig, TEngineConfig, ps, num_pages, greedy),
                 device="cpu"), TRequest, TSampler))
    runs = []
    for eng, R, S in engines:
        reqs = [R(rid=i, prompt=list(p), max_new_tokens=new,
                  **(overrides or {}).get(i, {}))
                for i, p in enumerate(_prompts())]
        sampler = None if greedy else S(1337, **(sampler_kw or {}))
        done = eng.run(reqs, window=window, sampler=sampler)
        runs.append(({r.rid: r.generated for r in done}, eng.stats))
    return runs


TOPK = dict(top_k=40, temperature=0.8)
CASES = {
    # 6 requests through 4 slots: a second admission wave
    "topk": dict(num_pages=20, new=12, sampler_kw=TOPK),
    "parity": dict(num_pages=20, new=12),
    "overrides": dict(num_pages=20, new=12, sampler_kw=TOPK,
                      overrides=OVERRIDES),
    # a 16-token window: masked pages, clamped positions, reclamation
    "window": dict(num_pages=20, new=30, window=16, sampler_kw=TOPK),
}


@pytest.mark.parametrize("ps", [8, 32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_sampled_streams_equal_jax(weights, case, ps):
    kw = dict(CASES[case])
    if ps == 32:
        kw["num_pages"] = 8
    (js, jstats), (ts, tstats) = _both(weights, ps, **kw)
    assert ts == js
    assert all(len(v) == kw["new"] for v in ts.values())
    for k in ("decode_tokens", "preemptions", "peak_pages_used"):
        assert tstats[k] == jstats[k], k
    # a sampled row never chains: every decode step is a single step
    assert tstats["single_steps"] == tstats["decode_steps"] > 0


@pytest.mark.parametrize("ps,num_pages", [(8, 8), (32, 3)])
def test_sampled_preemption_equal_jax(weights, ps, num_pages):
    """A pool too small for 4 slots: LRU preemption and requeue while
    sampling; the victims' re-admission consumes the stream in order."""
    (js, jstats), (ts, tstats) = _both(weights, ps, num_pages, new=10,
                                       sampler_kw=TOPK, overrides=OVERRIDES)
    assert ts == js
    assert tstats["preemptions"] == jstats["preemptions"] >= 1
    assert tstats["decode_tokens"] == jstats["decode_tokens"]


@pytest.mark.parametrize("ps", [8, 32])
def test_greedy_rows_of_a_mixed_batch_keep_the_greedy_stream(weights, ps):
    """Rows overriding greedy=True (or temperature 0) in a sampled batch
    step one token at a time, yet equal the greedy engine's chained
    streams."""
    (_, _), (mixed, _) = _both(weights, ps, 20, new=12, sampler_kw=TOPK,
                               overrides=OVERRIDES)
    (jg, _), (greedy, _) = _both(weights, ps, 20, new=12, greedy=True)
    assert greedy == jg
    for rid in (1, 4):
        assert mixed[rid] == greedy[rid]
    assert any(mixed[r] != greedy[r] for r in (0, 2, 3, 5))
