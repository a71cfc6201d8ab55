"""An admission wave cut into length-sorted prefill calls
(engine._subwaves): the cut against a brute force over every contiguous
partition, and a mixed-length wave through the engine against each of
its requests run alone: greedy tokens with logprobs, prompt-logprob
scoring, and the host parity sampler's draws in admission order, on the
CPU; prompt-logprob scoring on the int8/bf16 engine on the card (marked
``cuda``; skipped where there is no GPU).

This file imports no JAX, so it runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_subwaves.py
"""

import itertools

import numpy as np
import pytest
import torch

from llmc_paged_tpu_torch.config import EngineConfig, GPT2Config, PageConfig
from llmc_paged_tpu_torch.engine import engine as E
from llmc_paged_tpu_torch.engine.engine import InferenceEngine
from llmc_paged_tpu_torch.engine.scheduler import Request
from llmc_paged_tpu_torch.models import gpt2
from llmc_paged_tpu_torch.sampler import Sampler
from test_torch_common import cuda  # noqa: F401  (fixture)
from test_torch_common import one_thread  # noqa: F401
from test_torch_common import params_np, port_cfg


def _cost(lengths, calls):
    return sum(len(c) * E._bucket(max(lengths[i] for i in c))
               + E.PREFILL_CALL_SLOTS for c in calls)


def _brute_force(lengths):
    """The least cost over every cut of the rows, sorted by length, into
    contiguous calls."""
    order = sorted(range(len(lengths)), key=lambda i: lengths[i])
    best = None
    for k in range(len(order)):
        for cuts in itertools.combinations(range(1, len(order)), k):
            edges = (0,) + cuts + (len(order),)
            calls = [order[a:b] for a, b in zip(edges, edges[1:])]
            c = _cost(lengths, calls)
            best = c if best is None else min(best, c)
    return best


def _log_uniform(rng, n, lo, hi):
    return [int(v) for v in np.exp(rng.uniform(np.log(lo), np.log(hi), n))]


WAVES = {
    "one_row": [7],
    "hand_built": [5, 20, 33],
    "one_bucket": [100, 97, 110, 112, 99],
    "short_and_long": [16] * 6 + [1000],
    "two_long": [16, 16, 16, 1000, 1000, 16],
    "score_32": _log_uniform(np.random.default_rng(1), 32, 128, 1023),
    "chat_76": _log_uniform(np.random.default_rng(2), 76, 64, 768),
    "chat_128": _log_uniform(np.random.default_rng(3), 128, 64, 768),
    "code_40": _log_uniform(np.random.default_rng(4), 40, 2048, 8192),
}
WAVES.update({f"small_{s}": _log_uniform(np.random.default_rng(100 + s),
                                         1 + s % 8, 1, 1023)
              for s in range(24)})


@pytest.mark.parametrize("name", list(WAVES))
def test_subwaves_cut_the_sorted_buckets_at_the_least_cost(name):
    lengths = WAVES[name]
    calls = E._subwaves(lengths)
    buckets = [[E._bucket(lengths[i]) for i in c] for c in calls]
    # every row in exactly one call, each call in row order, exact counts
    assert sorted(i for c in calls for i in c) == list(range(len(lengths)))
    assert all(c == sorted(c) and c for c in calls)
    # contiguous in sorted order, the longest call first: a bucket lies in
    # one call, and every bucket of a call lies above the next call's
    for hi, lo in zip(buckets, buckets[1:]):
        assert min(hi) > max(lo)
    # one bucket, one call, exactly as one padded call
    if len({E._bucket(n) for n in lengths}) == 1:
        assert calls == [list(range(len(lengths)))]
    # never more slots than one call padded to the wave's longest bucket,
    # which the longest row's call keeps
    wave_tb = E._bucket(max(lengths))
    slots = sum(len(c) * max(b) for c, b in zip(calls, buckets))
    assert slots <= len(lengths) * wave_tb
    assert max(buckets[0]) == wave_tb
    assert _cost(lengths, calls) <= _cost(lengths,
                                          [list(range(len(lengths)))])
    if len(lengths) <= 8:
        assert _cost(lengths, calls) == _brute_force(lengths)


# -- a mixed-length wave through the engine -----------------------------------

# admission order; two calls at any PREFILL_CALL_SLOTS up to 5,184: six
# rows of buckets 16-48 and two of 704 and 912
MIXED = [5, 900, 20, 16, 700, 33, 12, 11]
NEW = 6
LP_ATOL = 1e-5          # the same fp32 arithmetic in another batch
INT8_LP_ATOL = 0.032    # the int8 prefill wave's cap in the TP checks


def _cpu_engine(greedy):
    cfg = port_cfg(max_seq_len=1024)
    page = PageConfig(page_size=16, num_pages=160, max_seqs=8,
                      pages_per_seq=64)
    econf = EngineConfig(cache_mode="paged", page=page, greedy=greedy,
                         max_batch=8, decode_chunk=4, seed=5)
    return InferenceEngine(params_np(cfg, seed=0), cfg, econf, device="cpu")


def _card_engine(dev):
    cfg = GPT2Config(max_seq_len=1024, vocab_size=50257, num_layers=2,
                     num_heads=12, channels=768)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = gpt2.init_params(cfg, gen, device=dev)
    page = PageConfig(page_size=128, num_pages=8 * 8 + 4, max_seqs=8,
                      pages_per_seq=8, kv_dtype="int8")
    econf = EngineConfig(cache_mode="paged", page=page, param_dtype="int8",
                         activation_dtype="bfloat16",
                         prefill_param_dtype="bfloat16", max_batch=8,
                         greedy=True, decode_chunk=32)
    return InferenceEngine(params, cfg, econf, device=dev)


def _requests(mode, lengths, vocab):
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, vocab, n).tolist() for n in lengths]
    kw = ({"logprobs": True, "max_new_tokens": NEW} if mode == "greedy"
          else {"prompt_logprobs": True, "max_new_tokens": 1}
          if mode in ("score", "score_int8") else {"max_new_tokens": 1})
    return [Request(rid=i, prompt=p, **kw) for i, p in enumerate(prompts)]


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("mode", [
    "greedy", "score", "parity",
    pytest.param("score_int8", marks=pytest.mark.cuda)])
def test_a_mixed_wave_serves_each_request_as_it_runs_alone(mode, request):
    if mode == "score_int8":
        # rows of 1,020 and 950 tokens share a call of 1,024 (the flash
        # kernel's), the short rows another
        eng = _card_engine(request.getfixturevalue("cuda"))
        lengths, atol = [20, 1020, 17, 900, 40, 9, 950, 33], INT8_LP_ATOL
    else:
        eng = _cpu_engine(greedy=mode != "parity")
        lengths, atol = MIXED, LP_ATOL
    vocab = eng.cfg.vocab_size
    sampler = Sampler(7) if mode == "parity" else None

    wave = eng.run(_requests(mode, lengths, vocab), sampler=sampler)
    st = eng.stats
    assert st["spans"]["engine.prefill"]["n"] == 1
    assert st["prefill_calls"] == len(E._subwaves(lengths)) >= 2
    wave = sorted(wave, key=lambda r: r.rid)

    # each alone, in admission order, the parity draws from one stream
    alone_sampler = Sampler(7) if mode == "parity" else None
    alone, fetches = [], []
    for r in _requests(mode, lengths, vocab):
        alone += eng.run([r], sampler=alone_sampler)
        fetches.append(eng.stats["spans"]["engine.fetch"]["n"])
    if mode in ("score", "score_int8"):
        # the wave's prompt logprobs come down in one fetch, as one row's
        assert st["spans"]["engine.fetch"]["n"] == max(fetches)
        assert all(len(w.prompt_logprob_values) == lengths[w.rid] - 1
                   for w in wave)
    for w, a in zip(wave, alone):
        assert len(w.prompt_logprob_values) == len(a.prompt_logprob_values)
        np.testing.assert_allclose(w.prompt_logprob_values,
                                   a.prompt_logprob_values, atol=atol)
        if mode != "score_int8":
            # a random model's near-ties decide the picks at bf16
            assert w.generated == a.generated
            np.testing.assert_allclose(w.logprob_values, a.logprob_values,
                                       atol=atol)
        assert w.prefill_tokens == lengths[w.rid]
    if mode == "parity":
        # both streams drew once a request
        assert sampler.rng.state == alone_sampler.rng.state
