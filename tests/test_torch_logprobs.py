"""Logprobs in the port's engine against the JAX package's engine on the
CPU (fp32, JAX with use_kernel=False, the weights carried across by
convert.params_from_numpy): the chosen tokens' raw-softmax logprobs of
the greedy chunk chain (on the device) and of the host single-token path
equal JAX's within 1e-5 and a dense forward within 2e-3; prompt logprobs
equal JAX's; a logprobs row does not perturb its neighbours; logprobs
stay aligned with a stop token; the validation gates raise what JAX
raises, with its messages; warmup runs the JAX package's stages."""

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

NEW = 10
LP_ATOL = 1e-5          # port against JAX (same fp32 arithmetic)
ORACLE_ATOL = 2e-3      # against a dense forward (the JAX test's bound)


def _prompts(n=3, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, int(ln)).tolist()
            for ln in rng.integers(3, 12, n)]


@pytest.fixture(scope="module")
def weights():
    return params_np(port_cfg(), seed=0)


def _econf(page_mod, engine_mod, **kw):
    page = page_mod(page_size=8, num_pages=48, max_seqs=8, pages_per_seq=10,
                    **kw.pop("page_kw", {}))
    return engine_mod(**{**dict(cache_mode="paged", page=page, greedy=True,
                                max_batch=4, decode_chunk=4), **kw})


def _engines(weights, **kw):
    """The same configuration in both packages: (jax, port)."""
    j = JEngine(weights, jax_cfg(), _econf(JPageConfig, JEngineConfig, **kw),
                use_kernel=False)
    t = TEngine(convert.params_from_numpy(weights, port_cfg(), device="cpu"),
                port_cfg(), _econf(TPageConfig, TEngineConfig, **kw),
                device="cpu")
    return j, t


def _run(eng, R, specs):
    done = eng.run([R(rid=i, prompt=list(p), max_new_tokens=NEW, **kw)
                    for i, (p, kw) in enumerate(specs)])
    return {r.rid: r for r in done}


def _dense_logprobs(weights, tokens, n_prompt):
    """Independent oracle: one dense forward of the port over the final
    sequence; the logprob of tokens[i] under the softmax at i - 1."""
    cfg = port_cfg()
    params = gpt2.to_device(weights, cfg, torch.float32, "cpu")
    logits = gpt2.forward(params, torch.tensor([tokens], dtype=torch.int32),
                          cfg)[0].double().numpy()
    out = []
    for i in range(n_prompt, len(tokens)):
        row = logits[i - 1] - logits[i - 1].max()
        out.append(row[tokens[i]] - np.log(np.exp(row).sum()))
    return np.array(out)


# row 0: decode and prompt logprobs; row 1: none; row 2: decode logprobs
CHAIN_ROWS = ({"logprobs": True, "prompt_logprobs": True}, {},
              {"logprobs": True})


@pytest.fixture(scope="module")
def chain_runs(weights):
    """A greedy engine: chained decode (device logprobs) and a deferred
    first pick, through both packages."""
    je, te = _engines(weights)
    specs = list(zip(_prompts(), CHAIN_ROWS))
    return _run(je, JRequest, specs), _run(te, TRequest, specs), te


def test_greedy_chunk_logprobs_equal_jax(chain_runs):
    jd, td, te = chain_runs
    assert te.stats["single_steps"] == 0 < te.stats["decode_steps"]
    for rid in (0, 2):
        assert td[rid].generated == jd[rid].generated
        assert len(td[rid].logprob_values) == NEW
        np.testing.assert_allclose(td[rid].logprob_values,
                                   jd[rid].logprob_values, atol=LP_ATOL)


def test_greedy_chunk_logprobs_match_dense_forward(chain_runs, weights):
    _, td, _ = chain_runs
    for rid in (0, 2):
        r = td[rid]
        oracle = _dense_logprobs(weights, r.tokens, len(r.prompt))
        np.testing.assert_allclose(r.logprob_values, oracle,
                                   atol=ORACLE_ATOL)
        assert all(v <= 0.0 for v in r.logprob_values)


def test_prompt_logprobs_equal_jax(chain_runs, weights):
    jd, td, _ = chain_runs
    p = td[0].prompt
    assert len(td[0].prompt_logprob_values) == len(p) - 1
    np.testing.assert_allclose(td[0].prompt_logprob_values,
                               jd[0].prompt_logprob_values, atol=LP_ATOL)
    np.testing.assert_allclose(td[0].prompt_logprob_values,
                               _dense_logprobs(weights, list(p), 1),
                               atol=ORACLE_ATOL)
    assert td[1].prompt_logprob_values == td[2].prompt_logprob_values == []


def test_mixed_logprobs_rows_dont_perturb_others(chain_runs, weights):
    """Tokens of every row equal a run without any logprobs request; only
    the asking rows record values."""
    _, td, _ = chain_runs
    _, te = _engines(weights)
    base = _run(te, TRequest, [(p, {}) for p in _prompts()])
    for rid, r in td.items():
        assert r.tokens == base[rid].tokens
        assert len(r.logprob_values) == (0 if rid == 1 else NEW)


def test_logprobs_align_with_stop_tokens(chain_runs, weights):
    jd, td, _ = chain_runs
    stop = td[0].generated[3]
    cut = td[0].generated.index(stop) + 1
    je, te = _engines(weights)
    spec = [(_prompts()[0], {"logprobs": True, "stop_tokens": [stop]})]
    j, t = _run(je, JRequest, spec)[0], _run(te, TRequest, spec)[0]
    assert t.generated == j.generated == td[0].generated[:cut]
    assert len(t.logprob_values) == len(t.generated) < NEW
    np.testing.assert_allclose(t.logprob_values, j.logprob_values,
                               atol=LP_ATOL)


def test_host_single_token_logprobs_equal_jax(weights):
    """A parity-sampler engine (every step a host single-token step): the
    sampled tokens and the logprobs of the first pick and of every step
    equal JAX's; a greedy override row among them too."""
    je, te = _engines(weights, greedy=False)
    specs = list(zip(_prompts(2), ({"logprobs": True},
                                   {"logprobs": True, "greedy": True})))
    jd, td = _run(je, JRequest, specs), _run(te, TRequest, specs)
    assert te.stats["single_steps"] == te.stats["decode_steps"] > 0
    for rid in (0, 1):
        assert td[rid].generated == jd[rid].generated
        np.testing.assert_allclose(td[rid].logprob_values,
                                   jd[rid].logprob_values, atol=LP_ATOL)
        oracle = _dense_logprobs(weights, td[rid].tokens,
                                 len(td[rid].prompt))
        np.testing.assert_allclose(td[rid].logprob_values, oracle,
                                   atol=ORACLE_ATOL)


BAD = {
    "logprobs_spec": (dict(spec_k=3), dict(logprobs=True), None),
    "logprobs_dense": (dict(cache_mode="dense"), dict(logprobs=True), None),
    "logprobs_gated": (dict(serve_logprobs=False), dict(logprobs=True), None),
    "prompt_logprobs_gated": (dict(serve_logprobs=False),
                              dict(prompt_logprobs=True), None),
    "prompt_logprobs_window": ({}, dict(prompt_logprobs=True), 16),
    "prompt_logprobs_prefix": (dict(page_kw=dict(prefix_cache=True)),
                               dict(prompt_logprobs=True), None),
    "penalty_nan": ({}, dict(presence_penalty=float("nan")), None),
    "penalty_inf": ({}, dict(frequency_penalty=float("inf")), None),
    "penalty_spec": (dict(spec_k=3), dict(frequency_penalty=0.5), None),
    "override_spec": (dict(spec_k=3), dict(greedy=False), None),
    "temperature_nan": ({}, dict(temperature=float("nan")), None),
    "top_k_zero": ({}, dict(top_k=0), None),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_validation_raises_what_jax_raises(weights, case):
    econf_kw, req_kw, window = BAD[case]
    prompt = list(range(1, 30)) if window else [1, 2]
    errs = []
    for eng, R in zip(_engines(weights, **econf_kw), (JRequest, TRequest)):
        with pytest.raises(ValueError) as exc:
            eng.validate_request(R(rid=0, prompt=prompt, max_new_tokens=4,
                                   **req_kw), window=window)
        errs.append(str(exc.value))
    assert errs[1] == errs[0]


def test_valid_options_pass_validation(weights):
    """What the gates admit in JAX, the port admits: logprobs, prompt
    logprobs and finite penalties on a paged engine, with device
    sampling on."""
    for eng, R in zip(_engines(weights, device_sampling=True),
                      (JRequest, TRequest)):
        eng.validate_request(R(rid=0, prompt=[1, 2], max_new_tokens=4,
                               logprobs=True, prompt_logprobs=True,
                               frequency_penalty=-0.5,
                               presence_penalty=2.0))


def test_warmup_runs_the_jax_stages(weights):
    _, te = _engines(weights)
    t = te.warmup()
    assert set(t) == {"default", "logprobs", "prompt_logprobs"}
    assert all(v > 0 for v in t.values())
    _, te_spec = _engines(weights, spec_k=3)
    assert set(te_spec.warmup()) == {"default", "prompt_logprobs"}
    _, te_dense = _engines(weights, cache_mode="dense")
    assert te_dense.warmup() == {}
