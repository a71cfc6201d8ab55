"""Mellum 2's kernels and routes on the card (marked ``cuda``; skipped
where there is no GPU): the parts kernels at head_dim 128 against their
plain versions (the multi-query kernel with a group of query heads as
its tile, under a window), the prompt's attention routes against a
masked dense attention, and the chained step replayed as a CUDA graph
against the eager step, bit for bit.

This file imports no JAX, so it runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_mellum_cuda.py
"""

import dataclasses
import math

import pytest
import torch

from llmc_paged_tpu_torch.config import MellumConfig, PageConfig
from llmc_paged_tpu_torch.models import mellum, mellum_paged
from llmc_paged_tpu_torch.models.decode_graphs import DecodeGraphs
from llmc_paged_tpu_torch.ops import paged_attention as T
from test_torch_common import cuda  # noqa: F401  (fixture)

HD = 128


def _pool(cuda, kv, P, NH, ps, g):  # noqa: F811
    if kv == "int8":
        k, v = (torch.randint(-127, 128, (P, NH, HD, ps), generator=g,
                              device=cuda, dtype=torch.int8)
                for _ in range(2))
        ks, vs = (torch.rand((P, NH, ps), generator=g, device=cuda) / 64
                  for _ in range(2))
        return (k, v, ks, vs)
    dt = torch.bfloat16 if kv == "bfloat16" else torch.float32
    return tuple(torch.randn((P, NH, HD, ps), generator=g, device=cuda)
                 .to(dt) for _ in range(2))


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("KQ", [1, 4, 8])
@pytest.mark.parametrize("qdt", [torch.bfloat16, torch.float32])
def test_parts_kernels_at_head_dim_128(cuda, kv, KQ, qdt):  # noqa: F811
    """B rows of live ranges [start, len) with windows that start inside
    a page and end inside one, read through shuffled tables; KQ == 1 is
    the single-query kernel."""
    g = torch.Generator(device=cuda).manual_seed(KQ)
    NH, ps, pps, B = 4, 128, 10, 3
    P = B * pps + 2
    pool = _pool(cuda, kv, P, NH, ps, g)
    tables = torch.randperm(P, generator=g, device=cuda)[:B * pps].view(
        B, pps).int()
    lengths = torch.tensor([1, 700, 1253], dtype=torch.int32, device=cuda)
    starts = torch.tensor([0, 0, 1253 - 1024], dtype=torch.int32,
                          device=cuda)
    shape = (B, NH, HD) if KQ == 1 else (B, KQ, NH, HD)
    q = torch.randn(shape, generator=g, device=cuda).to(qdt)
    quant = kv == "int8"
    if KQ == 1:
        fn = (T.paged_decode_attention_quant_parts if quant
              else T.paged_decode_attention_parts)
        ref = (T.paged_decode_attention_quant_parts_ref if quant
               else T.paged_decode_attention_parts_ref)
    else:
        fn = (T.paged_decode_attention_quant_parts_mq if quant
              else T.paged_decode_attention_parts_mq)
        ref = (T.paged_decode_attention_quant_parts_mq_ref if quant
               else T.paged_decode_attention_parts_mq_ref)
    got = fn(q, *pool, tables, lengths, starts)
    want = ref(q, *pool, tables, lengths, starts)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.allclose(a, b.to(a.dtype), rtol=2e-4, atol=2e-4), \
            float((a - b).abs().max())


def _dense_attention(q, k, v, window):
    """Masked dense attention in f32 over (b, T, H, HD) heads, K/V
    repeated to the query heads; ``window`` None is causal."""
    G = q.shape[2] // k.shape[2]
    k, v = (t.float().repeat_interleave(G, dim=2) for t in (k, v))
    s = torch.einsum("bthd,bshd->bhts", q.float(), k) / math.sqrt(q.shape[-1])
    T_ = q.shape[1]
    pos = torch.arange(T_, device=q.device)
    keep = pos[None, :] <= pos[:, None]
    if window is not None:
        keep = keep & (pos[None, :] > pos[:, None] - window)
    s = s.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhts,bshd->bthd", torch.softmax(s, dim=-1), v)


@pytest.mark.cuda
@pytest.mark.parametrize("T_", [700, 2500])
@pytest.mark.parametrize("sliding", [False, True])
def test_prompt_attention_routes(cuda, T_, sliding):  # noqa: F811
    """The prompt's fused routes (flash/cuDNN causal, memory-efficient
    under the band mask past the window) against the masked dense
    attention, in bf16: within bf16's rounding of the output."""
    g = torch.Generator(device=cuda).manual_seed(T_)
    q = torch.randn((2, T_, 32, HD), generator=g, device=cuda).bfloat16()
    k, v = (torch.randn((2, T_, 4, HD), generator=g, device=cuda).bfloat16()
            for _ in range(2))
    got = mellum_paged.prompt_attention(q, k, v, 1024, sliding)
    want = _dense_attention(q, k, v, 1024 if sliding else None)
    torch.cuda.synchronize()
    assert got.shape == q.shape
    assert float((got.float() - want).abs().max()) < 2e-2


def _small_cfg():
    """Mellum's layer kinds and head_dim at small widths: 4 layers (3
    sliding, 1 full), 8 query and 2 K/V heads of 128, 8 experts top 2,
    window 256."""
    return dataclasses.replace(
        MellumConfig.tiny(), channels=256, num_heads=8, num_kv_heads=2,
        head_dim=HD, sliding_window=256, expert_width=64, vocab_size=1024)


def _prefilled(cfg, params, cuda, kv):  # noqa: F811
    page = PageConfig(page_size=128, num_pages=64, max_seqs=4,
                      pages_per_seq=8, kv_dtype=kv)
    pool = mellum_paged.init_pool(cfg, page, dtype=kv, device=cuda)
    g = torch.Generator().manual_seed(7)
    lens = [300, 41, 520, 129]
    T_ = max(lens)
    xs = torch.zeros((4, T_), dtype=torch.int64)
    pg = torch.full((4, T_), page.num_pages, dtype=torch.int32)
    tables = torch.zeros((4, 8), dtype=torch.int32)
    for r, n in enumerate(lens):
        xs[r, :n] = torch.randint(0, cfg.vocab_size, (n,), generator=g)
        tables[r] = torch.arange(8 * r, 8 * r + 8)
        pg[r, :n] = tables[r, torch.arange(n) // 128]
    last = torch.tensor(lens) - 1
    logits, pool = mellum_paged.prefill_paged(params, xs, pg, None, pool, cfg,
                                              last_pos=last)
    return pool, tables, torch.tensor(lens, dtype=torch.int32), \
        logits.argmax(-1).int()


def _chain(cfg, params, cuda, kv, graphs, use_kernel=True):  # noqa: F811
    """Two links of 32 steps after the prefill: tokens, logprobs."""
    pool, tables, lens, first = _prefilled(cfg, params, cuda, kv)
    outs, lps = [], []
    pos0 = lens.clone()
    for _ in range(2):
        K = 32
        pos = pos0[None, :] + torch.arange(K)[:, None]
        pgs = torch.gather(tables, 1, (pos // 128).T.long()).T.int()
        sls = (pos % 128).int()
        out, lp, pool = mellum_paged.decode_chunk_paged(
            params, first, pos0, pgs, sls, tables, pool, cfg, K, 10 ** 6,
            use_kernel=use_kernel, want_logprobs=True, graphs=graphs)
        outs.append(out)
        lps.append(lp)
        first = out[-1]
        pos0 = pos0 + K
    torch.cuda.synchronize()
    return torch.cat(outs), torch.cat(lps), pool.moe_counts.clone()


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["int8", "bfloat16"])
def test_graph_chain_matches_eager_bit_for_bit(cuda, kv):  # noqa: F811
    cfg = _small_cfg()
    params = mellum.init_params(cfg, torch.Generator().manual_seed(3),
                                dtype=torch.bfloat16, device=cuda)
    graphs = DecodeGraphs((32,))
    got = _chain(cfg, params, cuda, kv, graphs)
    assert graphs.steps == 64 and graphs.captures >= 1
    want = _chain(cfg, params, cuda, kv, None)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    # the routing counter counts the served steps, not the warm-up ones
    assert torch.equal(got[2], want[2])
    plain = _chain(cfg, params, cuda, kv, None, use_kernel=False)
    # the plain attention rounds elsewhere: the same greedy tokens where
    # no near-tie parts them, and the logprobs close
    agree = float((plain[0] == want[0]).float().mean())
    assert agree > 0.9, agree
    assert int(want[2].sum()) > 0
