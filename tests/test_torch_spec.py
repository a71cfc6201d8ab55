"""Speculative decode and suffix prefill of the port's models/gpt2_paged.py
against the JAX package on the same weights (JAX with use_kernel=False,
fp32): _ngram_draft exactly; decode_chunk_spec over two chained links
with inactive rows, float and int8 pools (tokens, counts, history, carries
exactly; pool values at committed positions within 1e-5);
prefill_suffix_paged (logits within 1e-4, pool within 1e-5), and against
the port's own full prefill_paged."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_paged_tpu.config import PageConfig as JPageConfig
from llmc_paged_tpu.kv.layouts import init_pool as j_init_pool
from llmc_paged_tpu.kv.layouts import token_coords as j_token_coords
from llmc_paged_tpu.models import gpt2 as JG
from llmc_paged_tpu.models import gpt2_paged as JGP
from llmc_paged_tpu_torch.config import PageConfig as TPageConfig
from llmc_paged_tpu_torch.convert import params_from_numpy
from llmc_paged_tpu_torch.kv.layouts import init_pool as t_init_pool
from llmc_paged_tpu_torch.kv.manager import BlockManager
from llmc_paged_tpu_torch.models import gpt2_paged as TGP
from test_torch_common import jax_cfg, params_np, port_cfg, to_np

PS, NP, PPS = 8, 40, 16          # max_context 128 = max_seq_len
LOGIT_TOL = 1e-4
POOL_TOL = 1e-5
VOCAB = 32                       # small vocab: greedy decode loops


def _weights(vocab):
    jcfg, tcfg = jax_cfg(vocab_size=vocab), port_cfg(vocab_size=vocab)
    p = params_np(tcfg, seed=3)
    jp = JG.to_device(p, jcfg)
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, tcfg,
                           device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def fp32():
    return _weights(VOCAB)


def _pools(jcfg, tcfg, kv_dtype):
    kw = dict(page_size=PS, num_pages=NP, pages_per_seq=PPS,
              kv_dtype=kv_dtype)
    return (j_init_pool(jcfg, JPageConfig(**kw), dtype=kv_dtype),
            t_init_pool(tcfg, TPageConfig(**kw), dtype=kv_dtype,
                        device="cpu"))


def _layers(pool):
    return [tuple(to_np(a).copy() for a in pool.layer(i))
            for i in range(pool.num_layers)]


def _dequant(layer):
    if len(layer) == 2:
        return layer
    k, v, ks, vs = layer
    return (k.astype(np.float32) * ks[:, :, None, :],
            v.astype(np.float32) * vs[:, :, None, :])


def _coords(tables, pos, valid):
    pg, sl = j_token_coords(jnp.asarray(tables), jnp.asarray(pos), PS,
                            jnp.asarray(valid), NP)
    return np.array(pg), np.array(sl)


def _compare_committed(jpool, tpool, tables, lengths):
    """K/V of every layer at each row's committed positions [0, len)."""
    for jl, tl in zip(_layers(jpool), _layers(tpool)):
        for j, t in zip(_dequant(jl), _dequant(tl)):
            for b, n in enumerate(lengths):
                pos = np.arange(n)
                pages, slots = tables[b, pos // PS], pos % PS
                np.testing.assert_allclose(t[pages, :, :, slots],
                                           j[pages, :, :, slots],
                                           atol=POOL_TOL, rtol=0)


# ---- _ngram_draft -----------------------------------------------------------

def test_ngram_draft_matches_jax():
    """The four rows of the JAX package's unit test (most recent match,
    continuation masked past the known tokens, too-short history) plus a
    random repetitive history: exactly the JAX drafts."""
    rows = np.array([
        [7, 8, 9, 1, 2, 7, 8, 5, 6, 7, 8, 0, 0],
        [1, 2, 3, 4, 5, 6, 7, 8, 9, 1, 2, 0, 0],
        [3, 3, 3, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        [1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    ], np.int32)
    hl = np.array([11, 11, 4, 2], np.int32)
    got = TGP._ngram_draft(torch.from_numpy(rows), torch.from_numpy(hl), 2,
                           3).numpy()
    np.testing.assert_array_equal(
        got, [[5, 6, 7], [3, 4, 5], [3, -1, -1], [-1, -1, -1]])
    rng = np.random.default_rng(0)
    hist = rng.integers(0, 4, (6, 40)).astype(np.int32)
    hl = np.array([40, 39, 3, 0, 17, 25], np.int32)
    for n, d in ((3, 3), (2, 5), (1, 1)):
        ref = np.asarray(JGP._ngram_draft(jnp.asarray(hist), jnp.asarray(hl),
                                          n, d))
        got = TGP._ngram_draft(torch.from_numpy(hist), torch.from_numpy(hl),
                               n, d).numpy()
        np.testing.assert_array_equal(got, ref)
        assert got.dtype == np.int32


# ---- decode_chunk_spec ------------------------------------------------------

def _prompts():
    rng = np.random.default_rng(5)
    return [[3, 9, 4, 9] * 3, [5, 6, 7, 8, 5, 6, 7, 8, 5, 6, 7, 8],
            rng.integers(0, VOCAB, 12).tolist()]


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_decode_chunk_spec_matches_jax(fp32, kv_dtype):
    """Two chained links (device carries threaded through): row 2 is
    inactive throughout, row 1 leaves the plan after link 1 (the engine
    deactivates it on the device). Drafts are accepted (asserted)."""
    jcfg, tcfg, jp, tp = fp32
    S, K = 3, 3
    TK = S * K
    prompts = _prompts()
    B, T = len(prompts), len(prompts[0])
    mgr = BlockManager(NP, PS, 4)
    for b in range(B):
        assert mgr.append_tokens(b, T)[0]
    tables = np.stack([mgr.block_table_array(b, PPS) for b in range(B)])
    xs = np.asarray(prompts, np.int32)
    pg, sl = _coords(tables, np.tile(np.arange(T, dtype=np.int32), (B, 1)),
                     np.ones((B, T), bool))
    jpool, tpool = _pools(jcfg, tcfg, kv_dtype)
    jl, jpool = JGP.prefill_paged(jp, jnp.asarray(xs), jnp.asarray(pg),
                                  jnp.asarray(sl), jpool, jcfg)
    tl, tpool = TGP.prefill_paged(tp, torch.from_numpy(xs),
                                  torch.from_numpy(pg), torch.from_numpy(sl),
                                  tpool, tcfg)
    first = np.argmax(to_np(jl)[:, -1], axis=-1).astype(np.int32)
    np.testing.assert_array_equal(
        np.argmax(to_np(tl)[:, -1], axis=-1), first)

    hist = np.zeros((B, PPS * PS + 1), np.int32)
    hist[:, :T] = xs
    hist[:, T] = first
    pos0 = np.array([T, T, -1], np.int32)
    j_carry = (jnp.asarray(first), jnp.asarray(pos0), jnp.asarray(hist))
    t_carry = (torch.from_numpy(first), torch.from_numpy(pos0),
               torch.from_numpy(hist))
    accepted = 0
    active = pos0 >= 0
    for link in range(2):
        if link == 1:
            active = np.array([True, False, False])
            j_carry = (j_carry[0], jnp.where(jnp.asarray(active), j_carry[1],
                                             -1), j_carry[2])
            t_carry = (t_carry[0], torch.where(torch.from_numpy(active),
                                               t_carry[1], -1), t_carry[2])
        for b in np.flatnonzero(active):
            assert mgr.append_tokens(int(b), TK)[0]
        tables = np.stack([mgr.block_table_array(b, PPS) for b in range(B)])
        jo, jc, jh, jlast, jpos, jpool = JGP.decode_chunk_spec(
            jp, j_carry[0], j_carry[1], j_carry[2], jpool,
            jnp.asarray(tables), jcfg, num_steps=S, spec_k=K, ngram=3,
            use_kernel=False)
        to_, tc, th, tlast, tpos, tpool = TGP.decode_chunk_spec(
            tp, t_carry[0], t_carry[1], t_carry[2], tpool,
            torch.from_numpy(tables), tcfg, num_steps=S, spec_k=K, ngram=3,
            use_kernel=False, active=active)
        for name, j, t in (("out", jo, to_), ("counts", jc, tc),
                           ("hist", jh, th), ("last_tok", jlast, tlast),
                           ("new_positions", jpos, tpos)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=name)
        counts = np.asarray(jc)
        assert np.all(counts[:, ~active] == 0)
        accepted += int(counts[:, active].sum() - S * active.sum())
        new_pos = np.asarray(jpos)
        _compare_committed(jpool, tpool, tables,
                           [int(n) for n in np.where(active, new_pos, 0)])
        j_carry = (jlast, jpos, jh)
        t_carry = (tlast, tpos, th)
    assert accepted > 0, "no draft accepted: the spec path was not exercised"


def test_decode_chunk_spec_rejects_spec_k_below_2(fp32):
    jcfg, tcfg, jp, tp = fp32
    _, tpool = _pools(jcfg, tcfg, "float32")
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="spec_k"):
        TGP.decode_chunk_spec(tp, z, z, torch.zeros(1, 9, dtype=torch.int32),
                              tpool, torch.zeros(1, PPS, dtype=torch.int32),
                              tcfg, num_steps=2, spec_k=1, active=[True])


# ---- prefill_suffix_paged ---------------------------------------------------

def test_prefill_suffix_matches_jax_and_full_prefill():
    """Row 0 has a 16-token cached prefix (2 pages) and a 5-token suffix,
    row 1 an 8-token prefix and a 9-token suffix. The suffix prefill
    equals the JAX package's, and the port's full prefill of the whole
    prompts (logits at the last prompt token; the pool at every prompt
    position)."""
    jcfg, tcfg, jp, tp = _weights(512)
    rng = np.random.default_rng(7)
    pre = np.array([16, 8], np.int32)
    suf = np.array([5, 9], np.int32)
    prompts = [rng.integers(0, 512, int(p + s)).tolist()
               for p, s in zip(pre, suf)]
    B = 2
    tables = (np.arange(B * PPS, dtype=np.int32).reshape(B, PPS)[:, ::-1]
              .copy())
    jpool, tpool = _pools(jcfg, tcfg, "float32")
    # the prefix pages, written by a plain prefill
    Tp = int(pre.max())
    xs = np.zeros((B, Tp), np.int32)
    valid = np.zeros((B, Tp), bool)
    for b in range(B):
        xs[b, :pre[b]] = prompts[b][:pre[b]]
        valid[b, :pre[b]] = True
    pg, sl = _coords(tables, np.tile(np.arange(Tp, dtype=np.int32), (B, 1)),
                     valid)
    _, jpool = JGP.prefill_paged(jp, jnp.asarray(xs), jnp.asarray(pg),
                                 jnp.asarray(sl), jpool, jcfg)
    TGP.prefill_paged(tp, torch.from_numpy(xs), torch.from_numpy(pg),
                      torch.from_numpy(sl), tpool, tcfg)
    # the suffixes, at positions pre[b] + j
    Ts = int(suf.max())
    xs = np.zeros((B, Ts), np.int32)
    valid = np.zeros((B, Ts), bool)
    for b in range(B):
        xs[b, :suf[b]] = prompts[b][pre[b]:]
        valid[b, :suf[b]] = True
    pos = pre[:, None] + np.arange(Ts, dtype=np.int32)[None, :]
    pg, sl = _coords(tables, pos, valid)
    last = suf - 1
    jl, jpool = JGP.prefill_suffix_paged(
        jp, jnp.asarray(xs), jnp.asarray(pg), jnp.asarray(sl), jpool,
        jnp.asarray(tables), jnp.asarray(pre), jcfg,
        last_pos=jnp.asarray(last), use_kernel=False)
    tl, tpool = TGP.prefill_suffix_paged(
        tp, torch.from_numpy(xs), torch.from_numpy(pg), torch.from_numpy(sl),
        tpool, torch.from_numpy(tables), torch.from_numpy(pre), tcfg,
        last_pos=torch.from_numpy(last), use_kernel=True)
    assert tl.shape == (B, tcfg.vocab_size)
    np.testing.assert_allclose(to_np(tl), to_np(jl), atol=LOGIT_TOL, rtol=0)
    lengths = [int(n) for n in pre + suf]
    _compare_committed(jpool, tpool, tables, lengths)

    # the port's own full prefill of the whole prompts
    _, fpool = _pools(jcfg, tcfg, "float32")
    Tf = int(max(lengths))
    xs = np.zeros((B, Tf), np.int32)
    valid = np.zeros((B, Tf), bool)
    for b in range(B):
        xs[b, :lengths[b]] = prompts[b]
        valid[b, :lengths[b]] = True
    pg, sl = _coords(tables, np.tile(np.arange(Tf, dtype=np.int32), (B, 1)),
                     valid)
    fl, fpool = TGP.prefill_paged(
        tp, torch.from_numpy(xs), torch.from_numpy(pg), torch.from_numpy(sl),
        fpool, tcfg, last_pos=torch.tensor(lengths) - 1)
    np.testing.assert_allclose(to_np(tl), to_np(fl), atol=LOGIT_TOL, rtol=0)
    _compare_committed(fpool, tpool, tables, lengths)
