"""sampler.py of the port and the engine's host-sampling helpers against
the JAX package's, bit for bit: the xorshift streams, the CDF walk,
the top-k/temperature transform (ties at the k-th value kept), the
top-k prefix reconstruction, the Sampler's argument checks, and the
engine's batched row samplers (top-k prefix ship with its boundary-tie
fallback, per-request overrides) on the same logits."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from llmc_paged_tpu import sampler as JS
from llmc_paged_tpu.engine import engine as JE
from llmc_paged_tpu.engine.scheduler import Request as JRequest
from llmc_paged_tpu_torch import sampler as TS
from llmc_paged_tpu_torch.engine import engine as TE
from llmc_paged_tpu_torch.engine.scheduler import Request as TRequest


@pytest.mark.parametrize("seed", [1337, 1, 2**63 + 5])
def test_xorshift_streams_equal(seed):
    j, t = JS.XorshiftRNG(seed), TS.XorshiftRNG(seed)
    assert [t.random_u32() for _ in range(500)] == \
        [j.random_u32() for _ in range(500)]
    assert [t.random_f32() for _ in range(500)] == \
        [j.random_f32() for _ in range(500)]
    with pytest.raises(AssertionError):
        TS.XorshiftRNG(0)


def test_sample_mult_and_argmax_equal():
    rng = np.random.default_rng(0)
    coins = TS.XorshiftRNG(7)
    for _ in range(200):
        p = rng.random(300).astype(np.float32)
        p /= p.sum(dtype=np.float32)
        c = coins.random_f32()
        assert TS.sample_mult(p, c) == JS.sample_mult(p, c)
        assert TS.sample_argmax(p) == JS.sample_argmax(p)
    # the rounding fallback: a coin above the whole CDF takes the last id
    p = np.full(4, 0.2, np.float32)
    assert TS.sample_mult(p, 0.9999) == JS.sample_mult(p, 0.9999) == 3


@pytest.mark.parametrize("top_k,temp", [(None, 1.0), (40, 0.8), (3, 1.0),
                                        (None, 0.5), (1, 2.0)])
def test_topk_probs_equal_with_ties(top_k, temp):
    """Rows with repeated values at and around the k-th entry: every tie
    at the k-th value is kept, in both packages, bit for bit."""
    rng = np.random.default_rng(top_k or 0)
    for _ in range(20):
        row = rng.integers(-8, 8, 128).astype(np.float32) * 0.25
        np.testing.assert_array_equal(TS.topk_probs(row, top_k, temp),
                                      JS.topk_probs(row, top_k, temp))
    row = np.array([3, 1, 2, 2, 2, 0], np.float32)
    got = TS.topk_probs(row, 2, 1.0)
    np.testing.assert_array_equal(got, JS.topk_probs(row, 2, 1.0))
    assert np.count_nonzero(got) == 4          # 3 and the three tied 2s


def test_reconstruct_topk_row_equal():
    rng = np.random.default_rng(3)
    vals = rng.standard_normal(24).astype(np.float32)
    idx = rng.permutation(500)[:24]
    np.testing.assert_array_equal(TS.reconstruct_topk_row(vals, idx, 500),
                                  JS.reconstruct_topk_row(vals, idx, 500))


def test_sampler_streams_and_checks_equal():
    rng = np.random.default_rng(5)
    rows = rng.standard_normal((50, 200)).astype(np.float32)
    for kw in (dict(), dict(top_k=40, temperature=0.8), dict(greedy=True),
               dict(temperature=0)):
        j, t = JS.Sampler(1337, **kw), TS.Sampler(1337, **kw)
        assert (t.greedy, t.top_k, t.temperature, t.transforms_logits) == \
            (j.greedy, j.top_k, j.temperature, j.transforms_logits)
        assert [t.sample_logits(r) for r in rows] == \
            [j.sample_logits(r) for r in rows]
    for bad in (dict(temperature=-1.0), dict(top_k=0)):
        with pytest.raises(ValueError):
            TS.Sampler(1, **bad)


def _logits(seed=0, n=6, V=300, tie_row=None):
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((n, V)).astype(np.float32)
    if tie_row is not None:
        # 90 equal top values: the shipped prefix (k' = 80 for k = 40, 19
        # for k = 3) ends inside the tie, so that row downloads its full
        # row
        rows[tie_row, :90] = 5.0
    return rows


@pytest.mark.parametrize("kw", [dict(top_k=40, temperature=0.8),
                                dict(top_k=3), dict(temperature=0.7),
                                dict(), dict(greedy=True)])
def test_engine_row_samplers_equal(kw):
    """_sample_rows (incl. the top-k prefix ship and its boundary-tie
    fallback), of a batch and of one row, against the JAX package's
    _sample_rows and _pick_token: the same tokens and the same RNG state
    after the batch."""
    rows = _logits(tie_row=2)
    j, t = JS.Sampler(1337, **kw), TS.Sampler(1337, **kw)
    got = TE._sample_rows(t, torch.from_numpy(rows), len(rows))
    want = JE._sample_rows(j, jnp.asarray(rows), len(rows))
    assert got == want
    assert t.rng.state == j.rng.state
    for r in rows:
        assert TE._sample_rows(t, torch.from_numpy(r)[None], 1)[0] == \
            JE._pick_token(j, jnp.asarray(r))


def test_engine_per_request_samplers_equal():
    """A mixed batch: greedy, top-k, temperature-0 (greedy) and plain rows
    against the engine's top-k sampler; one shared stream in row order."""
    rows = _logits(seed=1, n=5)
    over = [dict(greedy=True), dict(top_k=5), dict(temperature=0.0),
            dict(), dict(top_k=20, temperature=1.3)]
    j, t = JS.Sampler(1337, top_k=40), TS.Sampler(1337, top_k=40)
    jr = [JRequest(rid=i, prompt=[1], max_new_tokens=1, **o)
          for i, o in enumerate(over)]
    tr = [TRequest(rid=i, prompt=[1], max_new_tokens=1, **o)
          for i, o in enumerate(over)]
    for a, b in zip(tr, jr):
        assert TE._effective(t, a) == JE._effective(j, b)
    assert TE._sample_rows_per_request(t, torch.from_numpy(rows), tr) == \
        JE._sample_rows_per_request(j, jnp.asarray(rows), jr)
    assert t.rng.state == j.rng.state
