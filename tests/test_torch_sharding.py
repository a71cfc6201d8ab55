"""Tensor and data parallelism of the port (llmc_paged_tpu_torch/parallel/
sharding.py, the engine's mesh_shape) against the JAX package on the CPU,
the counterparts of tests/test_sharding.py.

The port runs in four gloo rank processes (one module-scoped RankPool,
every case a task; TP 4 is {"model": 4}, TP 2 is {"data": 2, "model": 2},
two TP-2 replicas); every rank's result is checked. The JAX side runs on
one device (use_kernel=False), its TP layout on the 8 virtual CPU
devices of tests/conftest.py.

Tolerances: the layout is exact (f32, bf16 casts and int8 values and
scales); fp32 decode-step logits within 1e-5, the embedding within 1e-6
and the logits of that embedding within 1e-4 relative (sums in another order:
torch against XLA, and over the ranks); bf16 and int8 step logits within
test_sharding.py's 0.05 and 1e-4; the DP losses within 1e-5 of the
port's single-device steps (its grad_fn is held to JAX's by
test_torch_train.py); engine
streams exactly (greedy on the CPU, where both routes are deterministic).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_paged_tpu import formats as JF
from llmc_paged_tpu.config import EngineConfig as JEngineConfig
from llmc_paged_tpu.config import GPT2Config as JGPT2Config
from llmc_paged_tpu.config import PageConfig as JPageConfig
from llmc_paged_tpu.engine.engine import InferenceEngine as JEngine
from llmc_paged_tpu.engine.scheduler import Request as JRequest
from llmc_paged_tpu.kv.layouts import init_pool as j_init_pool
from llmc_paged_tpu.kv.layouts import token_coords as j_token_coords
from llmc_paged_tpu.models import gpt2 as JG
from llmc_paged_tpu.models import gpt2_paged as JGP
from llmc_paged_tpu.ops.int8 import quantize_params as j_quantize_params
from llmc_paged_tpu.parallel import sharding as jsh
from llmc_paged_tpu_torch.config import EngineConfig as TEngineConfig
from llmc_paged_tpu_torch.config import GPT2Config as TGPT2Config
from llmc_paged_tpu_torch.config import PageConfig as TPageConfig
from llmc_paged_tpu_torch.engine.engine import InferenceEngine as TEngine
from llmc_paged_tpu_torch.models import gpt2 as TG
from llmc_paged_tpu_torch.ops.int8 import quantize_params as t_quantize_params
from llmc_paged_tpu_torch.parallel import sharding as tsh
from llmc_paged_tpu_torch.parallel.mp_dryrun import RankPool, weight_bytes
from test_torch_common import one_thread  # noqa: F401
from test_torch_common import params_np, to_np

pytestmark = pytest.mark.usefixtures("one_thread")

TASKS = "llmc_paged_tpu_torch.parallel.mp_dryrun:"
# the two TP widths over four ranks: (mesh_shape, data replicas)
MESHES = {2: {"data": 2, "model": 2}, 4: {"model": 4}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    with RankPool(4, workdir=str(tmp_path_factory.mktemp("ranks")),
                  timeout_s=300) as pool:
        yield pool


@pytest.fixture(scope="module")
def golden(fixtures_dir):
    """The tiny fixture: L=4, NH=4 (TP 2 and 4 both divide), C=64."""
    cfg_j, p = JF.read_checkpoint(os.path.join(fixtures_dir,
                                               "model_tiny.bin"))
    state = JF.read_debug_state(os.path.join(fixtures_dir,
                                             "state_tiny.bin"), cfg_j)
    stream = JF.read_token_stream(os.path.join(fixtures_dir,
                                               "tokens_tiny.bin"))
    return cfg_j, _port_cfg(cfg_j), p, state, stream


def _port_cfg(cfg_j):
    return TGPT2Config(cfg_j.max_seq_len, cfg_j.vocab_size,
                       cfg_j.num_layers, cfg_j.num_heads, cfg_j.channels)


def _same(results):
    """Every rank's result equal to rank 0's; returns it."""
    for r in results[1:]:
        assert r == results[0]
    return results[0]


# ---- the layout, no process group ------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_prepare_tp_params_equals_jax_shards(golden, dtype, tp):
    """Every leaf of the port's shard at model_rank r equals shard r of
    the JAX package's prepare_tp_params, exactly."""
    cfg_j, cfg_t, p, _, _ = golden
    want = jsh.prepare_tp_params(p, cfg_j, jsh.make_mesh(model=tp),
                                 param_dtype=dtype)
    for r in range(tp):
        got = tsh.prepare_tp_params(p, cfg_t, tsh.Mesh.local(r, tp),
                                    param_dtype=dtype, device="cpu")
        assert set(got) == set(want)
        for k, v in got.items():
            shard = np.asarray(want[k].addressable_shards[r].data)
            assert v.is_contiguous(), k
            assert str(v.dtype).split(".")[-1] == str(shard.dtype), k
            np.testing.assert_array_equal(to_np(v), to_np(shard),
                                          err_msg=f"{k} rank {r}")


def test_prepare_tp_params_refuses_quantized_and_uneven(golden):
    cfg_j, cfg_t, p, _, _ = golden
    q = t_quantize_params(TG.to_device(p, cfg_t, device="cpu"))
    with pytest.raises(ValueError, match="FLOAT params"):
        tsh.prepare_tp_params(q, cfg_t, tsh.Mesh.local(0, 2),
                              param_dtype="int8", device="cpu")
    with pytest.raises(ValueError, match="divisible by 3"):
        tsh.prepare_tp_params(p, cfg_t, tsh.Mesh.local(0, 3), device="cpu")
    pool = tsh.init_tp_pool(cfg_t, TPageConfig(page_size=8, num_pages=4),
                            tsh.Mesh.local(1, 2), dtype="int8", device="cpu")
    assert pool.k[0].shape == (4, 2, 16, 8) and pool.k[0].is_contiguous()
    assert pool.k_scale[0].shape == (4, 2, 8)


# ---- ranks -----------------------------------------------------------------------

def _jax_step_logits(cfg_j, params, x, page, kv_dtype):
    """JAX single device: prefill of x[:, :T-1], one decode step of
    x[:, T-1] (rows on pages [b·pps, (b+1)·pps))."""
    B, T = x.shape
    pps = page.pages_per_seq
    tables = np.arange(B * pps, dtype=np.int32).reshape(B, pps)
    pos = np.tile(np.arange(T - 1, dtype=np.int32), (B, 1))
    pg, sl = j_token_coords(jnp.asarray(tables), jnp.asarray(pos),
                            page.page_size, jnp.ones((B, T - 1), bool),
                            page.num_pages)
    pool = j_init_pool(cfg_j, page, dtype=kv_dtype)
    _, pool = JGP.prefill_paged(params, jnp.asarray(x[:, : T - 1]), pg, sl,
                                pool, cfg_j)
    last = np.full(B, T - 1, np.int32)
    pg1 = tables[:, (T - 1) // page.page_size]
    sl1 = np.full(B, (T - 1) % page.page_size, np.int32)
    logits, _ = JGP.decode_step_paged(
        params, jnp.asarray(x[:, T - 1]), jnp.asarray(last),
        jnp.asarray(pg1), jnp.asarray(sl1), jnp.asarray(tables),
        jnp.asarray(last + 1), pool, cfg_j, use_kernel=False)
    return to_np(logits).astype(np.float32)


STEP_CASES = {
    # (tp, param dtype, kv dtype): (rtol, atol), test_sharding.py's
    # tolerances for the reduced dtypes
    (2, "float32", "float32"): (1e-5, 1e-5),
    (4, "float32", "float32"): (1e-5, 1e-5),
    (2, "bfloat16", "bfloat16"): (0.05, 0.05),
    (4, "int8", "int8"): (1e-4, 1e-4),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_tp_decode_step_matches_jax_single_device(ranks, golden, case):
    """TP prefill + one TP decode step against the JAX package's
    single-device prefill + step (decode_step_paged, use_kernel=False)."""
    tp, dtype, kv = case
    cfg_j, cfg_t, p, state, _ = golden
    x = state["x"][:2, :9] if dtype != "float32" else state["x"][:2, :12]
    page_j = JPageConfig(page_size=8, num_pages=32, max_seqs=4,
                         pages_per_seq=4)
    page_t = TPageConfig(page_size=8, num_pages=32, max_seqs=4,
                         pages_per_seq=4)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
           "int8": jnp.float32}[dtype]
    params = JG.to_device(p, cfg_j, jdt)
    if dtype == "int8":
        params = j_quantize_params(params)
    want = _jax_step_logits(cfg_j, params, x, page_j, kv)
    got = ranks.run(TASKS + "step_logits", p, cfg_t, page_t, x,
                    data=4 // tp, param_dtype=dtype, kv_dtype=kv)
    rtol, atol = STEP_CASES[case]
    for r, g in enumerate(got):
        np.testing.assert_array_equal(g, got[0])
        np.testing.assert_allclose(g, want, rtol=rtol, atol=atol,
                                   err_msg=f"rank {r}")


def test_tp_embed_and_logits_roundtrip(ranks, golden):
    """The vocab-sharded embedding and lm_head at TP 4 against the
    whole-vocab ones."""
    cfg_j, cfg_t, p, state, _ = golden
    toks = state["x"][0, :8].astype(np.int64)
    wpe_pos = np.arange(8)
    params = JG.to_device(p, cfg_j)
    emb = params["wte"][jnp.asarray(toks)] + params["wpe"][wpe_pos]
    logits = JG._logits(emb, params, cfg_j)
    for g_emb, g_logits in ranks.run(TASKS + "embed_logits", p, cfg_t, toks,
                                     wpe_pos):
        np.testing.assert_allclose(g_emb, to_np(emb), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g_logits, to_np(logits), rtol=1e-4,
                                   atol=1e-5)


def _jax_engine(p, cfg_j, econf_kw, page_kw, reqs, runs=1, window=None):
    """JAX single-device engine (use_kernel=False): per run (streams,
    stats)."""
    eng = JEngine(p, cfg_j, JEngineConfig(page=JPageConfig(**page_kw),
                                          **econf_kw), use_kernel=False)
    out = []
    for _ in range(runs):
        done = eng.run([JRequest(**r) for r in reqs], window=window)
        out.append(({r.rid: list(r.tokens) for r in done}, dict(eng.stats)))
    return out


def _tp_engine(ranks, p, cfg_t, econf_kw, page_kw, reqs, tp, runs=1,
               window=None):
    """The port's engine at TP ``tp`` on every rank: per run (streams,
    stats, collectives), the same on every rank."""
    econf = TEngineConfig(page=TPageConfig(**page_kw), mesh_shape=MESHES[tp],
                          **econf_kw)
    res = ranks.run(TASKS + "engine_run", p, cfg_t, econf, reqs, runs=runs,
                    window=window)
    res = [[(run["streams"], run["stats"], run["collectives"]) for run in r]
           for r in res]
    _same([[(s, c) for s, _, c in r] for r in res])
    return res[0]


def _fixture_reqs(stream, n=2, length=7, new=10):
    return [dict(rid=i, prompt=stream[i * 5: i * 5 + length].tolist(),
                 max_new_tokens=new) for i in range(n)]


PAGE = dict(page_size=8, num_pages=32, max_seqs=4, pages_per_seq=6)
ENGINE_CASES = {
    # name: (tp, EngineConfig fields, PageConfig fields)
    "f32-tp2": (2, dict(max_batch=2), {}),
    "f32-tp4": (4, dict(max_batch=2), {}),
    "int8-int8": (2, dict(max_batch=2, decode_chunk=8, param_dtype="int8"),
                  dict(kv_dtype="int8")),
    "int8-f32": (2, dict(max_batch=2, decode_chunk=8, param_dtype="int8"),
                 {}),
}


@pytest.mark.parametrize("name", sorted(ENGINE_CASES))
def test_engine_tp_streams_equal_jax_single_device(ranks, golden, name):
    """The whole continuous-batching loop at TP 2 or 4 gives the greedy
    streams of the JAX package's single-device engine."""
    tp, econf_kw, page_kw = ENGINE_CASES[name]
    cfg_j, cfg_t, p, _, stream = golden
    reqs = _fixture_reqs(stream)
    kw = dict(cache_mode="paged", greedy=True, **econf_kw)
    page = dict(PAGE, **page_kw)
    (want, _), = _jax_engine(p, cfg_j, kw, page, reqs)
    (got, stats, coll), = _tp_engine(ranks, p, cfg_t, kw, page, reqs, tp)
    assert got == want
    # one all-gather a forward; 2L + 1 all-reduces
    forwards = coll["all_gather"]
    assert forwards >= 1 + stats["decode_steps"] // 2
    assert coll["all_reduce"] == (2 * cfg_t.num_layers + 1) * forwards


def test_engine_tp_int8_bf16_prefill_copy(ranks, golden):
    """int8 weights and KV with the bf16 prefill copy at TP 2: the TP
    prefill runs on a second, bf16 shard of the weights. Its streams
    equal the port's single-device engine's; against JAX's single-device
    engine the first token after each prompt agrees (test_sharding.py's
    bf16 gate: the two packages round different bf16 elements, ROADMAP
    §3, and a later greedy pick may part)."""
    cfg_j, cfg_t, p, _, stream = golden
    reqs = _fixture_reqs(stream)
    kw = dict(cache_mode="paged", greedy=True, max_batch=2, decode_chunk=8,
              param_dtype="int8", prefill_param_dtype="bfloat16")
    page = dict(PAGE, kv_dtype="int8")
    (got, _, _), = _tp_engine(ranks, p, cfg_t, kw, page, reqs, 2)
    single = ranks.run(TASKS + "engine_run", p, cfg_t,
                       TEngineConfig(page=TPageConfig(**page), **kw), reqs)
    assert all(r[0]["streams"] == got for r in single)
    (want, _), = _jax_engine(p, cfg_j, kw, page, reqs)
    for r in reqs:
        n = len(r["prompt"]) + 1
        assert got[r["rid"]][:n] == want[r["rid"]][:n]
        assert len(got[r["rid"]]) == n - 1 + r["max_new_tokens"]


def test_engine_tp_rank_holds_only_its_shard(ranks, golden):
    """A paged TP engine puts on its device this rank's shards (int8 for
    decode, bf16 for the prefill copy) and nothing of the whole model."""
    _, cfg_t, p, _, stream = golden
    kw = dict(cache_mode="paged", greedy=True, max_batch=2, decode_chunk=8,
              param_dtype="int8", prefill_param_dtype="bfloat16")
    econf = TEngineConfig(page=TPageConfig(**PAGE), mesh_shape=MESHES[2],
                          **kw)
    res = ranks.run(TASKS + "engine_run", p, cfg_t, econf,
                    _fixture_reqs(stream, new=2))

    def nbytes(d):
        return sum(t.numel() * t.element_size() for t in d.values())

    single = weight_bytes(TEngine(p, cfg_t, TEngineConfig(
        page=TPageConfig(**PAGE), **kw), device="cpu"))
    for rank, r in enumerate(res):
        mesh = tsh.Mesh.local(model_rank=rank % 2, model_size=2)
        want = (nbytes(tsh.prepare_tp_params(p, cfg_t, mesh, "int8",
                                             device="cpu"))
                + nbytes(tsh.prepare_tp_params(p, cfg_t, mesh, "bfloat16",
                                               device="cpu")))
        assert r[0]["weight_bytes"] == want
        assert want < single


def test_engine_tp_window_matches_jax_single_device(ranks, golden):
    """Sliding-window decode (window 8, a 14-token prompt: the truncation
    path too) under TP 2."""
    cfg_j, cfg_t, p, _, stream = golden
    reqs = [dict(rid=0, prompt=stream[:14].tolist(), max_new_tokens=12)]
    kw = dict(cache_mode="paged", greedy=True, max_batch=1, decode_chunk=8)
    (want, _), = _jax_engine(p, cfg_j, kw, PAGE, reqs, window=8)
    (got, _, _), = _tp_engine(ranks, p, cfg_t, kw, PAGE, reqs, 2, window=8)
    assert got == want


def test_engine_tp_device_sampling_topk1_equals_greedy(ranks, golden):
    """Device sampling at top_k=1 under TP 2: every rank seeds its
    generator with EngineConfig.seed and draws from the same gathered
    logits, so the stream is the greedy one, on every rank."""
    cfg_j, cfg_t, p, _, stream = golden
    reqs = [dict(rid=0, prompt=stream[:7].tolist(), max_new_tokens=12)]
    base = dict(cache_mode="paged", max_batch=1, decode_chunk=8)
    (greedy, _, _), = _tp_engine(ranks, p, cfg_t, dict(base, greedy=True),
                                 PAGE, reqs, 2)
    (sampled, stats, _), = _tp_engine(
        ranks, p, cfg_t, dict(base, greedy=False, top_k=1,
                              device_sampling=True), PAGE, reqs, 2)
    assert sampled == greedy and stats["single_steps"] == 0
    (want, _), = _jax_engine(p, cfg_j, dict(base, greedy=True), PAGE, reqs)
    assert greedy == want


def test_engine_tp_bf16_deterministic_and_close(ranks, golden):
    """bf16 TP serving runs deterministically (two runs, every rank) and
    its first token after the prompt agrees with JAX's single-device
    bf16 engine (test_sharding.py's gate: later bf16 picks may part)."""
    cfg_j, cfg_t, p, _, stream = golden
    reqs = [dict(rid=0, prompt=stream[:7].tolist(), max_new_tokens=8)]
    kw = dict(cache_mode="paged", greedy=True, max_batch=1, decode_chunk=8,
              param_dtype="bfloat16")
    page = dict(PAGE, kv_dtype="bfloat16")
    a, b = _tp_engine(ranks, p, cfg_t, kw, page, reqs, 2, runs=2)
    assert a[0] == b[0] and len(a[0][0]) == 7 + 8
    (single, _), = _jax_engine(p, cfg_j, kw, page, reqs)
    assert a[0][0][:8] == single[0][:8]


def _params(cfg):
    return params_np(cfg, seed=2)


SPEC_CFG = dict(max_seq_len=128, vocab_size=96, num_layers=2, num_heads=4,
                channels=32)


@pytest.mark.parametrize("dtypes", [("float32", "float32"),
                                    ("int8", "int8")])
def test_engine_tp_spec_decode_token_equality(ranks, dtypes):
    """Speculative decoding at TP 2 gives the streams of plain TP greedy
    and of JAX's single-device spec engine, with drafts accepted."""
    param_dtype, kv_dtype = dtypes
    cfg_t, cfg_j = TGPT2Config.tiny(**SPEC_CFG), JGPT2Config.tiny(**SPEC_CFG)
    p = _params(cfg_t)
    rng = np.random.default_rng(7)
    base = rng.integers(0, 96, 6).tolist()
    reqs = [dict(rid=i, prompt=base * 3 + rng.integers(0, 96, n).tolist(),
                 max_new_tokens=12) for i, n in enumerate((3, 5, 2, 7))]
    page = dict(page_size=8, num_pages=64, max_seqs=8, pages_per_seq=12,
                kv_dtype=kv_dtype)

    def kw(spec_k):
        return dict(cache_mode="paged", greedy=True, max_batch=4,
                    decode_chunk=3 if spec_k else 6, spec_k=spec_k,
                    param_dtype=param_dtype,
                    activation_dtype=("bfloat16" if param_dtype == "int8"
                                      else "float32"))

    (plain, _, _), = _tp_engine(ranks, p, cfg_t, kw(0), page, reqs, 2)
    (spec, st, _), = _tp_engine(ranks, p, cfg_t, kw(3), page, reqs, 2)
    (spec_1, _), = _jax_engine(p, cfg_j, kw(3), page, reqs)
    assert spec == plain, "TP spec diverged from plain TP greedy"
    assert spec == spec_1, "TP spec diverged from single-device spec"
    assert st["verify_steps"] > 0 and st["spec_tok_per_step"] > 1.0, st


def _prefix_reqs(vocab=128, seed=11):
    rng = np.random.default_rng(seed)
    sys_prompt = rng.integers(0, vocab, 24).tolist()  # 3 full pages @ ps=8
    return [dict(rid=i, prompt=sys_prompt + rng.integers(0, vocab, n)
                 .tolist(), max_new_tokens=10)
            for i, n in enumerate((5, 9, 3, 7, 6, 4))]


PREFIX_CFG = dict(max_seq_len=128, vocab_size=128, num_layers=2,
                  num_heads=4, channels=32)


@pytest.mark.parametrize("case", [(2, "float32"), (4, "float32"),
                                  (2, "int8")])
def test_engine_tp_prefix_cache_token_equality(ranks, case):
    """Prefix caching under TP: two runs of one engine (wave 1 registers
    the system prompt's pages, later waves and run 2 adopt them) give
    JAX's single-device prefix-cache streams; run 2 equals run 1."""
    tp, dtype = case
    cfg_t, cfg_j = (TGPT2Config.tiny(**PREFIX_CFG),
                    JGPT2Config.tiny(**PREFIX_CFG))
    p = _params(cfg_t)
    reqs = _prefix_reqs()
    page = dict(page_size=8, num_pages=48, max_seqs=8, pages_per_seq=10,
                kv_dtype=dtype, prefix_cache=True)
    kw = dict(cache_mode="paged", greedy=True, max_batch=3, decode_chunk=4,
              param_dtype=dtype,
              activation_dtype="bfloat16" if dtype == "int8" else "float32")
    (want, _), = _jax_engine(p, cfg_j, kw, page, reqs)
    (run1, _, _), (run2, stats, _) = _tp_engine(ranks, p, cfg_t, kw, page,
                                                reqs, tp, runs=2)
    assert run1 == want, "TP prefix run diverged from single-device"
    assert run2 == run1, "second TP run diverged (stale cached K/V?)"
    assert stats["prefix_hit_pages"] >= 18, stats
    assert stats["prefix_pages_registered"] == 0
    assert stats["suffix_prefills"] >= 1


def test_dp_train_step_matches_single_device(ranks, golden):
    """Two DP AdamW steps over 4 ranks (one row each) against the
    port's single-device steps on the whole batch (its grad_fn is held to
    JAX's by test_torch_train.py): the losses within 1e-5."""
    cfg_j, cfg_t, p, state, _ = golden
    params = {k: v.requires_grad_(True)
              for k, v in TG.to_device(p, cfg_t, device="cpu").items()}
    opt = torch.optim.AdamW(params.values(), lr=1e-4, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=0.0)
    x, y = torch.from_numpy(state["x"]), torch.from_numpy(state["y"])
    want = []
    for _ in range(2):
        opt.zero_grad(set_to_none=True)
        loss = TG.loss_fn(params, x, y, cfg_t)
        loss.backward()
        opt.step()
        want.append(float(loss.detach()))
    got = ranks.run(TASKS + "dp_losses", p, cfg_t, state["x"], state["y"],
                    steps=2)
    for losses in got:
        assert losses == got[0]
        np.testing.assert_allclose(losses, want, rtol=0, atol=1e-5)
