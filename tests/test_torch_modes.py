"""The dense and no-cache modes of the port (models/gpt2.py prefill and
decode_step over DenseKVCache; InferenceEngine.generate_nocache,
generate_dense, generate_paged and generate) against the JAX package's on
the CPU at fp32: the model functions within 1e-5, the token streams
EXACTLY (greedy, the parity sampler, a sliding window, a prompt longer
than the window); and within the port the three modes give the same
greedy stream."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_paged_tpu.config import EngineConfig as JEngineConfig
from llmc_paged_tpu.config import PageConfig as JPageConfig
from llmc_paged_tpu.engine.engine import InferenceEngine as JEngine
from llmc_paged_tpu.models import gpt2 as JG
from llmc_paged_tpu.sampler import Sampler as JSampler
from llmc_paged_tpu_torch.config import EngineConfig as TEngineConfig
from llmc_paged_tpu_torch.config import PageConfig as TPageConfig
from llmc_paged_tpu_torch.engine.engine import InferenceEngine as TEngine
from llmc_paged_tpu_torch.models import gpt2 as TG
from llmc_paged_tpu_torch.sampler import Sampler as TSampler
from test_torch_common import jax_cfg, params_np, port_cfg

MODES = ("none", "dense", "paged")


@pytest.fixture(scope="module")
def weights():
    return params_np(port_cfg(), seed=0)


def _prompt(n=20, seed=3):
    return np.random.default_rng(seed).integers(0, 512, n).tolist()


def test_dense_prefill_and_decode_step_match_jax(weights):
    """prefill fills the cache at [0, T); decode_step writes each row's
    position and attends [start, pos]; a window start and a clamped wpe
    position on row 1. Logits and caches within 1e-5."""
    jcfg, tcfg = jax_cfg(), port_cfg()
    jp = JG.to_device(weights, jcfg)
    tp = TG.to_device(weights, tcfg, device="cpu")
    toks = np.random.default_rng(0).integers(0, 512, (2, 9)).astype(np.int32)
    jc = JG.init_cache(jcfg, 2, 16)
    tc = TG.init_cache(tcfg, 2, 16, device="cpu")
    assert tc.max_len == jc.max_len == 16
    jl, jc = JG.prefill(jp, jnp.asarray(toks), jc, jcfg)
    tl, tc = TG.prefill(tp, torch.from_numpy(toks), tc, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=0)
    nxt = np.array([3, 7], np.int32)
    pos = np.array([9, 9], np.int32)
    wpe = np.array([9, 5], np.int32)
    starts = np.array([0, 4], np.int32)
    jl, jc = JG.decode_step(jp, jnp.asarray(nxt), jnp.asarray(pos), jc, jcfg,
                            wpe_pos=jnp.asarray(wpe),
                            starts=jnp.asarray(starts))
    tl, tc = TG.decode_step(tp, torch.from_numpy(nxt), torch.from_numpy(pos),
                            tc, tcfg, wpe_pos=torch.from_numpy(wpe),
                            starts=torch.from_numpy(starts))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=0)
    for a, b in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=0)


def _engines(weights, mode):
    page = dict(page_size=8, num_pages=40, max_seqs=4, pages_per_seq=16)
    kw = dict(cache_mode=mode, greedy=True, max_batch=1, decode_chunk=4)
    je = JEngine(weights, jax_cfg(),
                 JEngineConfig(page=JPageConfig(**page), **kw),
                 use_kernel=False)
    te = TEngine(weights, port_cfg(),
                 TEngineConfig(page=TPageConfig(**page), **kw), device="cpu")
    return je, te


CASES = {"greedy": dict(new=20), "window": dict(new=24, window=16),
         "long-prompt": dict(new=12, window=12),
         "parity": dict(new=20, sampler=dict()),
         "topk": dict(new=20, sampler=dict(top_k=40, temperature=0.8))}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_generate_equals_jax(weights, mode, case):
    kw = dict(CASES[case])
    new, window = kw.pop("new"), kw.pop("window", None)
    skw = kw.pop("sampler", None)
    je, te = _engines(weights, mode)
    out = []
    for eng, S in ((je, JSampler), (te, TSampler)):
        sampler = None if skw is None else S(1337, **skw)
        out.append(eng.generate(_prompt(), new, window=window,
                                sampler=sampler))
    assert out[1] == out[0]
    assert len(out[1]) == 20 + new


@pytest.mark.parametrize("window", [None, 16])
def test_three_modes_give_one_greedy_stream(weights, window):
    outs = {mode: _engines(weights, mode)[1].generate(_prompt(), 24,
                                                      window=window)
            for mode in MODES}
    assert outs["none"] == outs["dense"] == outs["paged"]
    te = _engines(weights, "dense")[1]
    assert te.generate(_prompt(), 0) == _prompt()


def test_modes_of_the_engine_config(weights):
    _, te = _engines(weights, "dense")
    with pytest.raises(ValueError, match="cache_mode"):
        TEngine(weights, port_cfg(),
                dataclasses.replace(te.econf, cache_mode="flat"),
                device="cpu")
    with pytest.raises(ValueError, match="window"):
        te.generate(_prompt(), 4, window=port_cfg().max_seq_len + 1)
