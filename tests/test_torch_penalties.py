"""Frequency/presence penalties in the port's engine against the JAX
package's engine on the CPU (fp32, JAX with use_kernel=False): a
penalized greedy chain (the (B, V) count plane threaded through the
links on the device) and the penalized host single-token path give
JAX's tokens exactly, and both equal a step-by-step dense replay of the
penalized pick; an unpenalized neighbour keeps the plain greedy stream;
penalties compose with device sampling, logprobs and stop tokens."""

import numpy as np
import pytest
import torch

from llmc_paged_tpu.config import EngineConfig as JEngineConfig
from llmc_paged_tpu.config import PageConfig as JPageConfig
from llmc_paged_tpu.engine.engine import InferenceEngine as JEngine
from llmc_paged_tpu.engine.scheduler import Request as JRequest
from llmc_paged_tpu_torch import convert
from llmc_paged_tpu_torch.config import EngineConfig as TEngineConfig
from llmc_paged_tpu_torch.config import PageConfig as TPageConfig
from llmc_paged_tpu_torch.engine.engine import InferenceEngine as TEngine
from llmc_paged_tpu_torch.engine.scheduler import Request as TRequest
from llmc_paged_tpu_torch.models import gpt2
from test_torch_common import one_thread  # noqa: F401
from test_torch_common import jax_cfg, params_np, port_cfg

pytestmark = pytest.mark.usefixtures("one_thread")


def _prompts(n, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, int(ln)).tolist()
            for ln in rng.integers(3, 12, n)]


@pytest.fixture(scope="module")
def weights():
    return params_np(port_cfg(), seed=0)


def _econf(page_mod, engine_mod, **kw):
    page = page_mod(page_size=8, num_pages=48, max_seqs=8, pages_per_seq=10)
    return engine_mod(**{**dict(cache_mode="paged", page=page, greedy=True,
                                max_batch=4, decode_chunk=4), **kw})


def _port(weights, **kw):
    return TEngine(convert.params_from_numpy(weights, port_cfg(),
                                             device="cpu"),
                   port_cfg(), _econf(TPageConfig, TEngineConfig, **kw),
                   device="cpu")


def _jax(weights, **kw):
    return JEngine(weights, jax_cfg(), _econf(JPageConfig, JEngineConfig,
                                              **kw), use_kernel=False)


def _run(eng, R, specs, new):
    done = eng.run([R(rid=i, prompt=list(p), max_new_tokens=new, **kw)
                    for i, (p, kw) in enumerate(specs)])
    return {r.rid: r for r in done}


def _oracle(weights, prompt, new, fp, pp):
    """Step-by-step dense replay of the penalized greedy pick (the port's
    dense forward over the whole context each step)."""
    cfg = port_cfg()
    params = gpt2.to_device(weights, cfg, torch.float32, "cpu")
    toks = list(prompt)
    out = []
    for _ in range(new):
        logits = gpt2.forward(params, torch.tensor([toks], dtype=torch.int32),
                              cfg)[0, -1].numpy()
        cnt = np.zeros(cfg.vocab_size, np.float32)
        np.add.at(cnt, np.asarray(toks), 1.0)
        t = int(np.argmax(logits - fp * cnt - pp * (cnt > 0)))
        out.append(t)
        toks.append(t)
    return out


def test_penalized_greedy_chain_equals_jax(weights):
    """Greedy engine, chained: the penalized row equals JAX's and the
    oracle, the unpenalized neighbour the plain greedy stream."""
    prompts = _prompts(2)
    specs = [(prompts[0], dict(frequency_penalty=0.7, presence_penalty=0.3)),
             (prompts[1], {})]
    te = _port(weights)
    td = _run(te, TRequest, specs, 12)
    jd = _run(_jax(weights), JRequest, specs, 12)
    assert te.stats["single_steps"] == 0 < te.stats["decode_steps"]
    assert td[0].generated == jd[0].generated
    assert td[1].generated == jd[1].generated
    assert td[0].generated == _oracle(weights, prompts[0], 12, 0.7, 0.3)
    plain = _run(_port(weights), TRequest,
                 [(p, {}) for p in prompts], 12)
    assert td[1].tokens == plain[1].tokens
    # a strong penalty changes the stream of a random model
    assert td[0].generated != plain[0].generated


def test_penalized_host_single_token_path_equals_jax(weights):
    """Parity-sampler engine (no chaining): a greedy override row with a
    penalty and a sampled penalized row next to it; the host recount
    gives JAX's tokens, and the greedy row the oracle."""
    prompts = _prompts(2, seed=3)
    specs = [(prompts[0], dict(greedy=True, frequency_penalty=0.9)),
             (prompts[1], dict(presence_penalty=1.5))]
    te = _port(weights, greedy=False)
    td = _run(te, TRequest, specs, 10)
    jd = _run(_jax(weights, greedy=False), JRequest, specs, 10)
    assert te.stats["single_steps"] == te.stats["decode_steps"] > 0
    for rid in (0, 1):
        assert td[rid].generated == jd[rid].generated
    assert td[0].generated == _oracle(weights, prompts[0], 10, 0.9, 0.0)


def test_penalties_compose_with_device_sampling_and_stops(weights):
    """Penalty rows ride device-sampled chains next to plain rows; a stop
    token still truncates; logprobs stay aligned."""
    prompts = _prompts(3)
    oracle0 = _oracle(weights, prompts[0], 10, 0.5, 0.5)
    plain = _run(_port(weights, device_sampling=True), TRequest,
                 [(p, {}) for p in prompts], 10)
    eng = _port(weights, device_sampling=True)
    done = _run(eng, TRequest, [
        (prompts[0], dict(frequency_penalty=0.5, presence_penalty=0.5,
                          logprobs=True, stop_tokens=[oracle0[4]])),
        (prompts[1], dict(temperature=0.8, greedy=False,
                          frequency_penalty=1.0)),
        (prompts[2], {})], 10)
    assert eng.stats["single_steps"] == 0
    cut = oracle0.index(oracle0[4]) + 1
    assert done[0].generated == oracle0[:cut]
    assert len(done[0].logprob_values) == len(done[0].generated)
    assert len(done[1].generated) == 10
    assert done[2].tokens == plain[2].tokens


def test_penalized_chain_counts_match_the_host_recount(weights):
    """The count plane a chain threads through its links equals a host
    recount of prompt + generated after the chain."""
    from llmc_paged_tpu_torch.engine.engine import _penalized_row
    from llmc_paged_tpu_torch.kv.layouts import init_pool
    from llmc_paged_tpu_torch.models import gpt2_paged
    cfg = port_cfg()
    params = convert.params_from_numpy(weights, cfg, device="cpu")
    page = TPageConfig(page_size=8, num_pages=8, max_seqs=2, pages_per_seq=4)
    pool = init_pool(cfg, page, dtype="float32", device="cpu")
    first = torch.tensor([5, 9], dtype=torch.int32)
    counts = torch.zeros(2, cfg.vocab_size, dtype=torch.int32)
    counts[0, 5] = counts[1, 9] = 1
    pgs = torch.tensor([[0, 4]] * 4, dtype=torch.int32)
    sls = torch.arange(4, dtype=torch.int32)[:, None].repeat(1, 2)
    tables = torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7]], dtype=torch.int32)
    fp, pp = torch.tensor([0.4, 0.0]), torch.tensor([0.2, 3.0])
    out, cnt, pool = gpt2_paged.decode_chunk_paged(
        params, first, torch.zeros(2, dtype=torch.int32), pgs, sls, tables,
        pool, cfg, num_steps=4, window=cfg.max_seq_len, use_kernel=False,
        pen_counts=counts, freq_pen=fp, pres_pen=pp)
    for b in range(2):
        want = np.bincount([int(first[b])] + out[:, b].tolist(),
                           minlength=cfg.vocab_size)
        assert cnt[b].numpy().tolist() == want.tolist()
    # the host twin subtracts the same plane
    from llmc_paged_tpu_torch.engine.scheduler import Request
    req = Request(rid=0, prompt=[5, 5, 7], max_new_tokens=1,
                  frequency_penalty=0.5, presence_penalty=1.0)
    row = _penalized_row(np.zeros(cfg.vocab_size, np.float32), req)
    assert row[5] == -2.0 and row[7] == -1.5 and row[0] == 0.0
