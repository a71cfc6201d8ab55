"""Mellum 2 on the port's paged path, on the CPU at a tiny size, against
the plain reference (tests/mellum_reference.py: the whole forward in
f32, no cache) and the benchmark's served-precision copy of it
(benchmarks/reference/mellum_ref.py).

The tiny model (``MellumConfig.tiny``): 4 layers (3 sliding, 1 full),
hidden 64, 8 query and 2 K/V heads of 16, 8 experts of width 32, 2 a
token, window 16, pages of 4 (a window ring of 5 pages, 20 tokens a
row), a YaRN group whose original length (16) the contexts outgrow.
Prompts are longer than the window and decode runs across at least two
ring wraps. In f32 the program and the reference differ by f32
round-off only: 1e-4 of the logits' range bounds it, and each planted
departure from the published layer (a sliding layer that sees the whole
context, YaRN off, the top-k weights left unnormalized, YaRN's
attention factor left out) is far outside it.
"""

import dataclasses
import json
import math
import os

import pytest
import torch

import mellum_reference as ref
from benchmarks.reference import mellum_ref
from llmc_paged_tpu_torch.config import (EngineConfig, MellumConfig,
                                         PageConfig, RopeGroup)
from llmc_paged_tpu_torch.engine.engine import InferenceEngine
from llmc_paged_tpu_torch.engine.scheduler import Request
from llmc_paged_tpu_torch.models import mellum, mellum_paged
from test_torch_common import params_np, port_cfg

CPU = torch.device("cpu")
TOL = 1e-4       # f32 round-off, relative to the logits' largest magnitude
PS, PPS, NP = 4, 20, 96
CFG = MellumConfig.tiny()
# the published config.json: Mellum2-12B-A2.5B's widths have this one source
with open(os.path.join(os.path.dirname(__file__), os.pardir, "benchmarks",
                       "configs", "mellum2-12b-a2.5b-bf16.json")) as f:
    PUBLISHED = json.load(f)
BIG = MellumConfig.from_hf(PUBLISHED)


def _to_hf(cfg):
    """HF's config.json keys of ``cfg`` (``MellumConfig.from_hf``'s
    inverse), the reference's input."""
    def group(g):
        return {k: v for k, v in dataclasses.asdict(g).items()
                if v is not None}
    return {"vocab_size": cfg.vocab_size,
            "num_hidden_layers": cfg.num_layers,
            "hidden_size": cfg.channels,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "head_dim": cfg.head_dim,
            "layer_types": list(cfg.layer_types),
            "sliding_window": cfg.sliding_window,
            "rope_parameters": {"sliding_attention": group(cfg.rope_sliding),
                                "full_attention": group(cfg.rope_full)},
            "num_experts": cfg.num_experts,
            "num_experts_per_tok": cfg.top_k,
            "moe_intermediate_size": cfg.expert_width,
            "norm_topk_prob": cfg.norm_topk_prob,
            "rms_norm_eps": cfg.rms_eps,
            "max_position_embeddings": cfg.max_seq_len}


HF = _to_hf(CFG)


@pytest.fixture(scope="module")
def params():
    return mellum.init_params(CFG, torch.Generator().manual_seed(1),
                              device=CPU, std=0.1)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _page(kv="float32"):
    return PageConfig(page_size=PS, num_pages=NP, max_seqs=4,
                      pages_per_seq=PPS, kv_dtype=kv)


def _prompts():
    g = torch.Generator().manual_seed(5)
    return [torch.randint(0, CFG.vocab_size, (n,), generator=g).tolist()
            for n in (27, 19, 6)]


def _prefill(params, kv="float32", last=False):
    """The three prompts in one padded wave through ``prefill_paged``
    (rows 0-2, their own pages); returns (logits, pool, tables)."""
    prompts = _prompts()
    T = max(map(len, prompts))
    pool = mellum_paged.init_pool(CFG, _page(kv), dtype=kv, device=CPU)
    xs = torch.zeros((4, T), dtype=torch.int64)
    pg = torch.full((4, T), NP, dtype=torch.int32)
    tables = torch.zeros((4, PPS), dtype=torch.int32)
    for r, p in enumerate(prompts):
        xs[r, :len(p)] = torch.tensor(p)
        tables[r] = torch.arange(r * PPS, (r + 1) * PPS)
        pg[r, :len(p)] = tables[r, torch.arange(len(p)) // PS]
    lastp = torch.tensor([len(p) - 1 for p in prompts] + [0])
    logits, pool = mellum_paged.prefill_paged(
        params, xs, pg, None, pool, CFG, last_pos=lastp if last else None,
        rows=torch.arange(4))
    return logits, pool, tables


def test_prefill_matches_the_reference(params):
    logits, _, _ = _prefill(params)
    for r, p in enumerate(_prompts()):
        assert _rel(logits[r, :len(p)], ref.forward(params, HF, p)) < TOL
    assert bool((logits[3] == 0).all())          # the padding row


def _chain(params, kv, links=5, K=8):
    """Links of K chained steps after the prefill (rows 0-2; row 3
    inactive): the served tokens and their logprobs a row."""
    logits, pool, tables = _prefill(params, kv, last=True)
    prompts = _prompts()
    pos0 = torch.tensor([len(p) for p in prompts] + [-1], dtype=torch.int32)
    first = logits.argmax(-1).int()
    toks = [[int(first[r])] for r in range(3)]
    lps = [[float(torch.log_softmax(logits[r], -1)[first[r]])]
           for r in range(3)]
    for _ in range(links):
        pos = pos0.clamp(min=0)[None, :] + torch.arange(K)[:, None]
        pgs = torch.gather(tables, 1, (pos // PS).T.long()).T.int()
        pgs[:, 3] = NP
        out, lp, pool = mellum_paged.decode_chunk_paged(
            params, first, pos0, pgs, (pos % PS).int(), tables, pool, CFG,
            K, 10 ** 6, want_logprobs=True)
        for r in range(3):
            toks[r] += out[:, r].tolist()
            lps[r] += lp[:, r].tolist()
        first = out[-1]
        pos0 = torch.where(pos0 >= 0, pos0 + K, pos0)
    return prompts, toks, lps, pool


def _check_served(params, prompts, toks, lps, cfg=HF, tol=TOL):
    """Every served token is the reference's argmax (but for a near-tie
    within tol) and its logprob the reference's log-softmax there;
    returns the widest logprob error."""
    worst = 0.0
    for p, t, lp in zip(prompts, toks, lps):
        lg = ref.forward(params, cfg, p + t[:-1])[len(p) - 1:]
        picks = torch.tensor(t)
        got = lg.gather(1, picks[:, None])[:, 0]
        scale = float(lg.abs().max())
        assert float((lg.max(-1).values - got).max()) <= tol * scale
        want = torch.log_softmax(lg, -1).gather(1, picks[:, None])[:, 0]
        worst = max(worst, float((torch.tensor(lp) - want).abs().max()))
    return worst


def test_chain_through_ring_wraps_matches_the_reference(params):
    prompts, toks, lps, pool = _chain(params, "float32")
    R = pool.R
    # 27 + 41 positions: the ring of 5 pages (20 tokens) wraps three times
    assert R == 5 and len(prompts[0]) + len(toks[0]) > 3 * R * PS
    assert _check_served(params, prompts, toks, lps) < TOL


def test_single_steps_match_the_reference_in_int8_kv(params):
    """The prompt, then single steps that write each token's K/V into the
    int8 pool before reading it: the served-precision reference with f32
    weights and int8 K/V re-derived per token and head (the scale
    absmax / 127 in f32, as the program computes it at f32 activations)
    gives the same logits to f32 round-off."""
    logits, pool, tables = _prefill(params, "int8", last=True)
    prompts = _prompts()
    lens = torch.tensor([len(p) for p in prompts] + [0], dtype=torch.int32)
    served = [[int(logits[r].argmax())] for r in range(3)]
    got = [[logits[r]] for r in range(3)]
    for _ in range(22):
        toks = torch.tensor([s[-1] for s in served] + [0], dtype=torch.int32)
        pos = lens.clone()
        pg = torch.gather(tables, 1, (pos // PS)[:, None].long())[:, 0].int()
        pg[3] = NP
        lens = torch.where(torch.arange(4) < 3, lens + 1, 0).int()
        lg, pool = mellum_paged.decode_step_paged(
            params, toks, pos, pg, (pos % PS).int(), tables, lens, pool, CFG)
        for r in range(3):
            got[r].append(lg[r])
            served[r].append(int(lg[r].argmax()))
    model = mellum_ref.ServedModel(params, HF, {"prefill": "float32",
                                                "decode": "float32",
                                                "kv": "int8"}, "float32")
    for r, p in enumerate(prompts):
        want, _ = model.logits(p, served[r])
        assert _rel(torch.stack(got[r]), want) < TOL


def test_engine_run_serves_the_references_tokens_and_logprobs(params):
    page = PageConfig(page_size=PS, num_pages=80, max_seqs=4,
                      pages_per_seq=PPS, kv_dtype="float32")
    eng = InferenceEngine(params, CFG, EngineConfig(
        page=page, max_batch=4, greedy=True, decode_chunk=8), device=CPU)
    g = torch.Generator().manual_seed(9)
    shapes = [(24, 30), (7, 12), (40, 20), (17, 33), (3, 9)]
    reqs = [Request(rid=i, prompt=torch.randint(0, CFG.vocab_size, (n,),
                                                generator=g).tolist(),
                    max_new_tokens=m, logprobs=True)
            for i, (n, m) in enumerate(shapes)]
    done = sorted(eng.run(reqs), key=lambda r: r.rid)
    assert [len(r.generated) for r in done] == [m for _, m in shapes]
    assert _check_served(params, [r.prompt for r in done],
                         [r.generated for r in done],
                         [r.logprob_values for r in done]) < TOL
    st = eng.stats
    assert st["kv_window_pages"] == 4 * mellum_paged.ring_pages(16, PS)
    assert 0 < st["kv_full_pages_peak"] <= 80
    counts = torch.tensor(st["moe_routed_tokens"])
    assert counts.shape == (4, 8)
    # every real prompt token and every row of every decode step, 2 a row
    prompt_tokens = sum(n for n, _ in shapes)
    assert int(counts[0].sum()) == 2 * (prompt_tokens
                                        + 4 * st["decode_steps"])
    assert bool((counts.sum(1) == counts[0].sum()).all())


def _mutated(change):
    hf = _to_hf(CFG)
    change(hf)
    return hf


def _whole_context(hf):
    hf["sliding_window"] = 10 ** 6


def _yarn_off(hf):
    hf["rope_parameters"]["full_attention"] = {"rope_type": "default",
                                               "rope_theta": 10000.0}


def _unnormalized(hf):
    hf["norm_topk_prob"] = False


def _no_attention_factor(hf):
    hf["rope_parameters"]["full_attention"]["attention_factor"] = 1.0


@pytest.mark.parametrize("change", [_whole_context, _yarn_off, _unnormalized,
                                   _no_attention_factor],
                         ids=lambda f: f.__name__.strip("_"))
def test_each_departure_fails_the_comparison(params, change):
    logits, _, _ = _prefill(params)
    hf = _mutated(change)
    worst = max(_rel(logits[r, :len(p)], ref.forward(params, hf, p))
                for r, p in enumerate(_prompts()))
    assert worst > 100 * TOL, worst


def test_yarn_at_the_published_numbers():
    g = BIG.rope_full
    assert mellum._yarn_range(g, 128) == (18, 35)
    f, scale = mellum.inv_freq(g, 128)
    assert scale == pytest.approx(0.1 * math.log(16) + 1, rel=1e-15)
    base = 500000.0 ** (torch.arange(0, 128, 2, dtype=torch.float32) / 128)
    # dims up to 18 keep their frequency, dims from 35 are divided by 16,
    # the ramp between
    assert torch.equal(f[:19], 1.0 / base[:19])
    assert torch.allclose(f[35:], 1.0 / (16 * base[35:]), rtol=1e-6)
    assert bool((f[19:35] < 1.0 / base[19:35]).all())
    assert bool((f[19:35] > 1.0 / (16 * base[19:35])).all())
    # the reference's own formula gives the same frequencies
    rf, rscale = ref.inv_freq(PUBLISHED["rope_parameters"]["full_attention"],
                              128)
    assert torch.equal(f, rf) and rscale == scale
    sliding = BIG.rope_sliding
    assert torch.equal(mellum.inv_freq(sliding, 128)[0], 1.0 / base)
    # truncate off moves the ramp's ends inside the dims
    lo, hi = mellum._yarn_range(dataclasses.replace(g, truncate=False), 128)
    assert 18 < lo < 19 and 34 < hi < 35


def test_the_ring_table_maps_row_s_page_j_to_s_R_plus_j_mod_R():
    pool = mellum_paged.init_pool(CFG, _page(), device=CPU)
    R = pool.R
    t = pool.ring_table(4, PPS, CPU)
    for s in range(4):
        for j in range(PPS):
            assert int(t[s, j]) == s * R + j % R
    assert pool.ring.num_pages == 4 * R
    page, slot = pool.ring_coords(torch.tensor([2, 3]), torch.tensor([41, 5]),
                                  torch.tensor([True, False]))
    assert page.tolist() == [2 * R + (41 // PS) % R, pool.ring.num_pages]
    assert slot.tolist() == [41 % PS, 5 % PS]


def test_a_prompt_writes_only_the_pages_its_window_reaches(params):
    """A 27-token prompt (pages 0-6) writes its ring pages 2-6 only:
    page 1 would land on page 6's ring slot."""
    _, pool, _ = _prefill(params)
    k = pool.ring.k[0]
    R = pool.R
    written = [bool(k[j % R].abs().sum() > 0) for j in range(R)]
    assert all(written)
    ids = mellum_paged._ring_prompt_ids(pool, torch.tensor([0]),
                                        torch.tensor([27]), 28)
    assert ids[0].tolist() == [pool.ring.num_pages] * 2 + [2, 3, 4, 0, 1]


def test_the_two_reference_copies_agree(params):
    prompt, gen = _prompts()[0], list(range(30, 60))
    model = mellum_ref.ServedModel(params, HF, {"prefill": "float32",
                                                "decode": "float32",
                                                "kv": "float32"})
    got, rows = model.logits(prompt, gen, all_prompt_rows=True)
    want = ref.forward(params, HF, prompt + gen[:-1])
    assert _rel(got, want[len(prompt) - 1:]) < 1e-5
    assert _rel(rows, want[:len(prompt)]) < 1e-5


def test_moe_routes_and_counts_on_the_device(params):
    lp = mellum.layer(mellum.layer_stack(params), 0)
    y = torch.randn(33, CFG.channels, generator=torch.Generator()
                    .manual_seed(2))
    counts = torch.zeros(CFG.num_experts, dtype=torch.int64)
    got = mellum.moe(y, lp, CFG, counts)
    want = ref._moe(y, lp["router"], lp["w_gate_up"], lp["w_down"], HF)
    assert _rel(got, want) < TOL
    _, idx = mellum.route(y, lp["router"], CFG)
    assert counts.tolist() == torch.bincount(
        idx.reshape(-1), minlength=CFG.num_experts).tolist()


@pytest.mark.parametrize("econf, what", [
    (dict(cache_mode="dense"), "cache_mode"),
    (dict(spec_k=3, greedy=True), "spec_k"),
    (dict(param_dtype="int8"), "param_dtype"),
    (dict(prefill_param_dtype="bfloat16"), "prefill_param_dtype"),
])
def test_paths_this_family_does_not_serve_raise(params, econf, what):
    with pytest.raises(ValueError, match=f"Mellum.*{what}"):
        InferenceEngine(params, CFG, EngineConfig(page=_page(), **econf),
                        device=CPU)


def test_a_run_window_raises_naming_the_family(params):
    eng = InferenceEngine(params, CFG, EngineConfig(page=_page()),
                          device=CPU)
    with pytest.raises(ValueError, match="Mellum"):
        eng.run([Request(rid=0, prompt=[1, 2, 3], max_new_tokens=2)],
                window=8)


@pytest.mark.parametrize("family", ["gpt2", "mellum"])
def test_the_model_object_is_the_family_seam(params, family, monkeypatch):
    """The engine's pool is the one its model object builds, and only
    Mellum's object adds its ring, full-page and routing stats."""
    if family == "gpt2":
        cfg = port_cfg()
        weights = params_np(cfg, seed=0)
        page = PageConfig(page_size=8, num_pages=40, max_seqs=2,
                          pages_per_seq=8)
    else:
        cfg, weights, page = CFG, params, _page()
    eng = InferenceEngine(weights, cfg, EngineConfig(
        page=page, max_batch=2, greedy=True, decode_chunk=4), device=CPU)
    kind = type(eng._model)
    real, built = kind.new_pool, []

    def new_pool(self, *a, **kw):
        built.append(real(self, *a, **kw))
        return built[-1]

    monkeypatch.setattr(kind, "new_pool", new_pool)
    _, pool = eng._paged_state()
    assert built == [pool]
    assert isinstance(pool, mellum_paged.MellumPool) == (family == "mellum")
    eng.run([Request(rid=0, prompt=[1, 2, 3, 4, 5], max_new_tokens=6)])
    assert len(built) == 2 and eng._pool_cache is built[1]
    family_stats = {"moe_routed_tokens", "kv_window_pages",
                    "kv_full_pages_peak"}
    assert family_stats & set(eng.stats) == (
        family_stats if family == "mellum" else set())


def test_config_round_trips_hf_keys():
    for cfg in (CFG, BIG):
        assert MellumConfig.from_hf(_to_hf(cfg)) == cfg
    assert (BIG.num_layers, BIG.channels, BIG.num_heads, BIG.num_kv_heads,
            BIG.head_dim, BIG.num_experts, BIG.top_k, BIG.expert_width,
            BIG.vocab_size, BIG.sliding_window) == (28, 2304, 32, 4, 128, 64,
                                                    8, 896, 98304, 1024)
    with pytest.raises(ValueError, match="layer_types"):
        dataclasses.replace(CFG, layer_types=("sliding_attention",) * 3)
    assert isinstance(CFG.rope_full, RopeGroup)


def _dense_attention(q, k, v, window):
    """Masked dense attention in f64 over (b, T, H, HD) heads, K/V
    repeated to the query heads; ``window`` None is causal."""
    G = q.shape[2] // k.shape[2]
    k, v = (t.double().repeat_interleave(G, dim=2) for t in (k, v))
    s = torch.einsum("bthd,bshd->bhts", q.double(), k) / math.sqrt(
        q.shape[-1])
    pos = torch.arange(q.shape[1])
    keep = pos[None, :] <= pos[:, None]
    if window is not None:
        keep = keep & (pos[None, :] > pos[:, None] - window)
    s = s.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhts,bshd->bthd", torch.softmax(s, dim=-1), v)


@pytest.mark.parametrize("T", [16, 17, 50, 64])
@pytest.mark.parametrize("sliding", [False, True])
def test_prompt_attention_against_masked_dense(T, sliding):
    """The prompt's routes (causal; past the window, query blocks with
    the query heads folded into their K/V head's rows under the band
    mask) against masked dense attention, window 16, 4 query heads a K/V
    head."""
    g = torch.Generator().manual_seed(T)
    q = torch.randn((2, T, 8, 16), generator=g)
    k, v = (torch.randn((2, T, 2, 16), generator=g) for _ in range(2))
    got = mellum_paged.prompt_attention(q, k, v, 16, sliding)
    want = _dense_attention(q, k, v, 16 if sliding else None)
    assert got.shape == q.shape
    assert float((got.double() - want).abs().max()) < 1e-5
