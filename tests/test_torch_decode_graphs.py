"""The chained decode step replayed as a CUDA graph
(models/decode_graphs.py, ``gpt2_paged.decode_chunk_paged(graphs=...)``).

On the CPU: the rule that picks the graph path, the step body (its step
index a device tensor) against single-token steps, the engine's counter,
and the benchmark's ``decode_graph_share.chat`` reader. On the card
(marked ``cuda``): the graph path against the eager path, bit for bit, at
GPT-2 XL's and GPT-2 small's widths in the int8 serving mode.

This file imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_decode_graphs.py
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from llmc_paged_tpu_torch.config import (EngineConfig, GPT2Config,
                                         PageConfig)
from llmc_paged_tpu_torch.convert import params_from_numpy
from llmc_paged_tpu_torch.engine.engine import InferenceEngine
from llmc_paged_tpu_torch.engine.scheduler import Request
from llmc_paged_tpu_torch.kv.layouts import init_pool, token_coords
from llmc_paged_tpu_torch.models import gpt2, gpt2_paged
from llmc_paged_tpu_torch.models.decode_graphs import DecodeGraphs
from llmc_paged_tpu_torch.ops import flash_attention, int8, paged_attention
from llmc_paged_tpu_torch.ops.int8 import quantize_params
from test_torch_common import cuda, params_np, port_cfg  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---- the rule ---------------------------------------------------------------

SINGLE, TP = gpt2_paged.SINGLE, object()   # any other model: tensor-parallel


@pytest.mark.parametrize("device, use_kernel, rng, pen, model, want", [
    ("cuda", True, None, None, SINGLE, True),           # greedy chain
    ("cuda:1", True, None, None, SINGLE, True),
    ("cuda", True, "rng", None, SINGLE, False),         # sampled
    ("cuda", True, None, "counts", SINGLE, False),      # penalties
    ("cuda", True, None, None, TP, False),              # tensor-parallel
    ("cuda", False, None, None, SINGLE, False),         # plain attention
    ("cpu", True, None, None, SINGLE, False),           # the CPU
])
def test_graph_eligible(device, use_kernel, rng, pen, model, want):
    assert gpt2_paged.graph_eligible(torch.device(device), use_kernel, rng,
                                     pen, model) is want


@pytest.mark.parametrize("decode_chunk", [1, 8, 32])
@pytest.mark.parametrize("cap", [1, 2, 3, 7, 8, 9, 31, 32, 1000])
@pytest.mark.parametrize("blocked", [False, True])
def test_chain_lengths_cover_every_link_length(decode_chunk, cap, blocked):
    """The engine's link length is 1 (no chain) or a length the graphs
    capture: decode_chunk; a quarter of it when admission is
    page-blocked or when ``cap`` (the context the fullest row has left)
    only fits that; a sixteenth when both."""
    from llmc_paged_tpu_torch.engine.engine import (_chain_length,
                                                    _chain_lengths)
    assert _chain_lengths(32) == (2, 8, 32)
    assert _chain_lengths(8) == (2, 8)
    assert _chain_lengths(1) == ()
    assert DecodeGraphs((32, 8, 1, 8)).chunks == (8, 32)
    got = _chain_length(decode_chunk, cap, blocked)
    assert got == 1 or got in _chain_lengths(decode_chunk)
    dc = decode_chunk // 4 if blocked else decode_chunk
    assert got == next((k for k in (dc, dc // 4) if 1 < k <= cap), 1)


# ---- the step body on the CPU -------------------------------------------------

PS, PPS = 8, 6
NP = 3 * PPS + 1


def _prefilled(cfg, params):
    """Three prompts (13, 5 and 16 tokens) prefilled into a fresh fp32
    pool; returns the pool, the tables, the lengths and the first
    tokens."""
    rng = np.random.default_rng(1)
    lens = np.array([13, 5, 16], np.int32)
    T = 16
    xs = np.zeros((3, T), np.int32)
    valid = np.zeros((3, T), bool)
    for b, n in enumerate(lens):
        xs[b, :n] = rng.integers(0, cfg.vocab_size, n)
        valid[b, :n] = True
    tables = torch.from_numpy(
        np.arange(3 * PPS, dtype=np.int32).reshape(3, PPS)[:, ::-1].copy())
    pos = torch.arange(T, dtype=torch.int32).repeat(3, 1)
    pg, sl = token_coords(tables, pos, PS, torch.from_numpy(valid), NP)
    pool = init_pool(cfg, PageConfig(page_size=PS, num_pages=NP,
                                     pages_per_seq=PPS), device="cpu")
    logits, pool = gpt2_paged.prefill_paged(
        params, torch.from_numpy(xs), pg, sl, pool, cfg,
        last_pos=torch.from_numpy(lens - 1))
    return pool, tables, lens, torch.argmax(logits, -1).int()


def _clone(pool):
    return [tuple(t.clone() for t in pool.layer(i))
            for i in range(pool.num_layers)]


@pytest.mark.parametrize("K", [1, 8, 32])
def test_chain_step_body_matches_single_steps(K):
    """A K-step chain (row 1 inactive) gives the tokens of K single-token
    steps that write the pool as they go, and commits the same K/V."""
    cfg = port_cfg()
    params = params_from_numpy(params_np(cfg, seed=0), cfg, device="cpu")
    pool, tables, lens, first = _prefilled(cfg, params)
    pool_s = type(pool)(*(list(t.clone() for t in ts)
                          for ts in (pool.k, pool.v)))
    pos0 = lens.copy()
    pos0[1] = -1
    act = torch.from_numpy(pos0 >= 0)
    cpos = torch.from_numpy(pos0)[None, :] + torch.arange(K)[:, None]
    pgs, sls = token_coords(tables, cpos.T.int(), PS,
                            act[:, None].expand(3, K), NP)
    out, pool = gpt2_paged.decode_chunk_paged(
        params, first, torch.from_numpy(pos0), pgs.T.contiguous(),
        sls.T.contiguous(), tables, pool, cfg, num_steps=K,
        window=cfg.max_seq_len, use_kernel=False, graphs=DecodeGraphs((K,)))
    assert out.dtype == torch.int32 and out.shape == (K, 3)

    toks = first.clone()
    want = []
    for j in range(K):
        p = torch.from_numpy(np.where(pos0 >= 0, pos0 + j, 0)).int()
        lengths = torch.where(act, p + 1, 0).int()
        logits, pool_s = gpt2_paged.decode_step_paged(
            params, toks, p, pgs[:, j], sls[:, j], tables, lengths, pool_s,
            cfg, use_kernel=False)
        toks = torch.argmax(logits, -1).int()
        want.append(toks)
    want = torch.stack(want)
    assert torch.equal(out[:, act], want[:, act])
    for a, b in zip(_clone(pool), _clone(pool_s)):
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, atol=1e-5, rtol=0)


def test_engine_counts_no_graph_steps_on_the_cpu():
    cfg = port_cfg()
    params = params_np(cfg, seed=0)
    econf = EngineConfig(page=PageConfig(page_size=PS, num_pages=NP,
                                         max_seqs=2, pages_per_seq=PPS),
                         max_batch=2, decode_chunk=8, greedy=True)
    eng = InferenceEngine(params, cfg, econf, device="cpu")
    eng.run([Request(rid=i, prompt=[1, 2, 3 + i], max_new_tokens=20)
             for i in range(2)])
    st = eng.stats
    assert st["decode_steps"] - st["single_steps"] > 0
    assert st["decode_graph_steps"] == 0
    assert eng._decode_graphs.captures == 0
    assert eng._decode_graphs.chunks == (2, 8)


# ---- the benchmark's reader ---------------------------------------------------

def _metric(name):
    path = os.path.join(ROOT, "benchmarks", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("stats, want", [
    ({"decode_steps": 400, "decode_graph_steps": 384}, 96.0),
    ({"decode_steps": 40, "decode_graph_steps": 0}, None),   # the CPU
    ({"decode_steps": 0, "decode_graph_steps": 0}, None),
    ({"decode_steps": 400}, None),          # a program without the counter
])
def test_decode_graph_share_reader(stats, want):
    got = _metric("decode_graph_share.chat").compute({"stats": stats})
    assert got == want


# ---- the card -----------------------------------------------------------------

WIDTHS = {"xl": dict(num_layers=48, num_heads=25, channels=1600),
          "small": dict(num_layers=12, num_heads=12, channels=768)}


def _int8_model(cuda, name, seed=0):
    cfg = GPT2Config(max_seq_len=1024, vocab_size=50257, **WIDTHS[name])
    gen = torch.Generator(device=cuda).manual_seed(seed)
    params = gpt2.init_params(cfg, gen, dtype=torch.bfloat16, device=cuda)
    return cfg, quantize_params(params)


def _launches():
    return [dict(c) for c in (paged_attention.LAUNCHES,
                              flash_attention.LAUNCHES, int8.LAUNCHES)]


def _zero_launches():
    for c in (paged_attention.LAUNCHES, flash_attention.LAUNCHES,
              int8.LAUNCHES):
        for k in c:
            c[k] = 0


def _two_links(cuda, cfg, params, pool, K, graphs):
    """Two K-step greedy links of 8 rows, the first with logprobs, the
    second fed the first's last tokens on the device: row 7 is inactive
    in both, rows 2 and 5 finish after the first. Returns each link's
    tokens and logprobs (None without), link 1's tokens as they read
    after link 2 too."""
    ps, pps = pool.page_size, 4
    lens = np.array([100, 128, 250, 7, 300, 64, 129, 0], np.int32)
    tables = torch.arange(8 * pps, dtype=torch.int32).reshape(8, pps)
    res = []
    first = torch.from_numpy(np.arange(8, dtype=np.int32) * 97 + 5)
    for link in range(2):
        pos0 = lens + link * K
        pos0[7] = -1
        if link:
            pos0[[2, 5]] = -1
        act = torch.from_numpy(pos0 >= 0)
        cpos = torch.from_numpy(pos0)[:, None] + torch.arange(K)[None, :]
        pgs, sls = token_coords(tables, cpos.int(), ps,
                                act[:, None].expand(8, K), pool.num_pages)
        *res_l, pool = gpt2_paged.decode_chunk_paged(
            params, first, torch.from_numpy(pos0), pgs.T.contiguous(),
            sls.T.contiguous(), tables, pool, cfg, num_steps=K,
            window=cfg.max_seq_len, want_logprobs=link == 0, graphs=graphs)
        out, lps = (res_l + [None])[:2]
        if link == 0:
            torch.cuda.synchronize(cuda)
            link1 = out.clone()
        res.append((out, lps))
        first = out[-1]
    torch.cuda.synchronize(cuda)
    return res, link1, pool


def _prefilled_int8_pool(cuda, cfg, params):
    """8 rows (prompts of 100 to 300 tokens, one empty) prefilled into an
    int8 pool of pages of 128, 4 pages a row."""
    page = PageConfig(page_size=128, num_pages=33, pages_per_seq=4,
                      kv_dtype="int8")
    pool = init_pool(cfg, page, dtype="int8", device=cuda)
    lens = [100, 128, 250, 7, 300, 64, 129, 0]
    T = 304
    gen = torch.Generator().manual_seed(3)
    xs = torch.randint(0, cfg.vocab_size, (8, T), generator=gen,
                       dtype=torch.int32)
    tables = torch.arange(32, dtype=torch.int32).reshape(8, 4)
    valid = torch.arange(T)[None, :] < torch.tensor(lens)[:, None]
    pos = torch.arange(T, dtype=torch.int32).repeat(8, 1)
    pg, sl = token_coords(tables, pos, 128, valid, page.num_pages)
    gpt2_paged.prefill_paged(params, xs, pg, sl, pool, cfg,
                             last_pos=torch.tensor(lens).clamp(min=1) - 1)
    return pool


@pytest.mark.cuda
@pytest.mark.parametrize("K", [32, 8])
@pytest.mark.parametrize("name", ["small", "xl"])
def test_graph_path_equals_eager_on_the_card(cuda, name, K):
    cfg, params = _int8_model(cuda, name)
    pool0 = _prefilled_int8_pool(cuda, cfg, params)
    pools = [type(pool0)(*(list(t.clone() for t in ts) for ts in
                           (pool0.k, pool0.v, pool0.k_scale, pool0.v_scale)))
             for _ in range(2)]
    del pool0

    _zero_launches()
    eager, e_link1, e_pool = _two_links(cuda, cfg, params, pools[0], K, None)
    e_launches = _launches()

    graphs = DecodeGraphs((32, 8))
    _zero_launches()
    (g1, g2), g_link1, g_pool = _two_links(
        cuda, cfg, params, pools[1], K, graphs)
    assert graphs.captures == 4          # both lengths, with logprobs or not
    assert graphs.steps == 2 * K
    assert _launches() == e_launches
    assert e_launches[0]["paged_decode_attention_quant_parts"] \
        == 2 * K * cfg.num_layers

    for (et, elp), (gt, glp) in zip(eager, (g1, g2)):
        assert torch.equal(et, gt)
    assert torch.equal(eager[0][1], g1[1]) and g2[1] is None
    assert torch.equal(g1[0], g_link1)   # link 1 intact after link 2
    assert torch.equal(e_link1, g_link1)
    for i in range(cfg.num_layers):
        for a, b in zip(e_pool.layer(i), g_pool.layer(i)):
            assert torch.equal(a, b)

    # two more links on the same graphs capture nothing new
    _two_links(cuda, cfg, params, g_pool, K, graphs)
    assert graphs.captures == 4
