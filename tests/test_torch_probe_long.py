"""The long-context probes (llmc_paged_tpu_torch/ops/dev/probe_longctx.py,
probe_longrange.py) and their engine-run helpers (serving_runs.py) on the
CPU: the helpers equal the repo-root bench.py's, an fp32 engine run gives
the JAX engine's greedy streams on the same numpy parameters, the probes'
parts return their records at small sizes, and the scale check's plain
parts equal the JAX package's XLA oracle on the same inputs."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from llmc_paged_tpu.ops.paged_attention import (
    paged_decode_attention_quant_parts_xla,
)
from llmc_paged_tpu_torch.config import GPT2Config
from llmc_paged_tpu_torch.convert import params_from_numpy
from llmc_paged_tpu_torch.ops.dev import probe_longctx, probe_longrange
from llmc_paged_tpu_torch.ops.dev import serving_runs as SR
from test_torch_common import jax_cfg, params_np, port_cfg

T_KEYS = {"t_prefill_dispatch_s", "t_chain_dispatch_s", "t_step_dispatch_s",
          "t_materialize_s"}


@pytest.mark.parametrize("which", ["124m", "1558m"])
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_model_cfg_equals_bench(which, smoke, monkeypatch):
    """The same fields as bench._model_cfg, LLMC_BENCH_SMOKE's tiny
    configuration included."""
    if smoke:
        monkeypatch.setenv("LLMC_BENCH_SMOKE", "1")
    else:
        monkeypatch.delenv("LLMC_BENCH_SMOKE", raising=False)
    got = dataclasses.asdict(SR.model_cfg(which))
    want = dataclasses.asdict(bench._model_cfg(which))
    assert got == want
    assert SR.cfg_name(SR.model_cfg(which)) == (
        "L2-C128" if smoke else which)


@pytest.mark.parametrize("B,n,seed", [(8, 896, 11), (32, 128, 0), (3, 5, 7)])
def test_prompts_equal_bench(B, n, seed):
    """bench._prompts' token lists, draw for draw (1558M's vocabulary)."""
    got = SR.prompts(GPT2Config.gpt2_1558m(), B, n, seed=seed)
    want = bench._prompts(bench._model_cfg("1558m"), B, n, seed=seed)
    assert got == want
    assert len(got) == B and all(len(p) == n for p in got)


def _streams(done):
    return [r.generated for r in sorted(done, key=lambda r: r.rid)]


def test_engine_run_streams_equal_bench():
    """fp32, page size 8: run_requests(engine(...)) against
    bench._run_requests(bench._engine(...)) on the same numpy parameters,
    ragged prompts, chunks of 4: the same greedy streams."""
    jcfg, tcfg = jax_cfg(), port_cfg()
    p = params_np(tcfg, seed=3)
    kw = dict(param_dtype="float32", kv_dtype="float32", B=3, CHUNK=4,
              num_pages=24, pages_per_seq=6, page_size=8)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, tcfg.vocab_size, n).tolist()
               for n in (13, 5, 21)]
    want = _streams(bench._run_requests(bench._engine(p, jcfg, **kw),
                                        prompts, 12))
    eng = SR.engine(params_from_numpy(p, tcfg, device="cpu"), tcfg,
                    device="cpu", **kw)
    got = _streams(SR.run_requests(eng, prompts, 12))
    assert got == want
    assert all(len(s) == 12 for s in got)


def test_run_paged_keeps_the_best_run():
    """run_paged at the tiny size: every run's tok/s, the best run's stats
    and the decode weights' bytes (int8 weights and KV)."""
    cfg = port_cfg()
    params = SR.device_params(cfg, "cpu")
    prompts = SR.prompts(cfg, 2, 9)
    st = SR.run_paged(params, cfg, 2, prompts, 6, 4, "int8", "int8",
                      warmups=1, runs=2, device="cpu")
    assert len(st["runs"]) == 2
    assert st["decode_tok_per_s"] == pytest.approx(max(st["runs"]), abs=0.01)
    assert st["decode_tokens"] > 0 and T_KEYS <= set(st)
    quantized = SR.engine(params, cfg, param_dtype="int8", kv_dtype="int8",
                          B=2, CHUNK=4, device="cpu").params
    assert st["param_bytes"] == SR.param_bytes(quantized)
    assert any(v.dtype == torch.int8 for v in quantized.values())


def test_long_ctx_engine_small(capsys):
    """The long-context engine at small sizes (int8, bf16 prefill copy):
    the warm run and two runs, each with every t_* bucket in its stats and
    every row finished; completion only (bf16 rounding, ROADMAP §3)."""
    cfg = port_cfg()
    params = params_from_numpy(params_np(cfg, seed=1), cfg, device="cpu")
    recs = probe_longctx.long_ctx_engine(
        cfg=cfg, params=params, B=2, prompt=40, new=8, chunk=4,
        page_size=16, warm_new=2, device="cpu")
    assert [r["tag"] for r in recs] == ["warm", "run0", "run1"]
    assert [r["generated"] for r in recs] == [[2, 2], [8, 8], [8, 8]]
    for r in recs:
        assert T_KEYS <= set(r["stats"])
        assert r["config"] == (2, 40, r["generated"][0], 4, 16, 4)
        assert r["tok_s"] > 0 and r["ms_step"] == pytest.approx(
            2 / r["tok_s"] * 1e3)
        assert r["launches"] == {}
    out = capsys.readouterr().out
    assert out.count("host buckets: t_") == 2
    assert out.count("full stats: ") == 2 and "-- engine up" in out


def test_chunk_matrix_two_by_two(capsys):
    """One record a cell, with its (B, ps, prompt, pool_mult)."""
    cfg = GPT2Config.tiny(max_seq_len=256)
    recs = probe_longctx.chunk_matrix(cfg=cfg, B=2, prompts=(16, 40),
                                      pool_mults=(1, 2), page_size=16,
                                      device="cpu")
    assert [r["config"] for r in recs] == [
        (2, 16, 16, 1), (2, 16, 16, 2), (2, 16, 40, 1), (2, 16, 40, 2)]
    # (B * pps + 8) * pool_mult pages, pps = ceil((prompt + 32) / ps)
    assert [r["num_pages"] for r in recs] == [14, 28, 18, 36]
    assert all(r["suite"] == "chunk" and r["name"] == "int8"
               and r["launches"] == {} for r in recs)
    assert capsys.readouterr().out.count("== chunk cell L2-C32") == 4


def test_probe_longrange_main_on_the_cpu(monkeypatch, capsys):
    """main at the smoke configuration with a short prompt and a small
    scale-check pool: the plain-parts cell, the ring-depth line, the scale
    check and the pool_mult 16 cell."""
    monkeypatch.setenv("LLMC_BENCH_SMOKE", "1")
    monkeypatch.setattr(probe_longrange, "PROMPT", 40)
    monkeypatch.setattr(probe_longrange, "SCALE_PAGES", 66)
    recs = probe_longrange.main(["--device", "cpu", "--skip-b32"])
    out = capsys.readouterr().out
    assert "int8 NBUF=8: no counterpart" in out
    assert [r["suite"] for r in recs] == ["chunk", "scale_check", "chunk"]
    plain, scale, pooled = recs
    assert plain["name"] == "int8-xlaattn" and plain["config"] == (
        8, 128, 40, 1)
    assert pooled["name"] == "int8" and pooled["config"] == (8, 128, 40, 16)
    assert scale["P"] == 66 and scale["diffs"] == [0.0, 0.0, 0.0]
    assert all(r["kernels"] == {} for r in recs)


def test_probe_longrange_b32_on_the_cpu(monkeypatch, capsys):
    """The B=32 run at the smoke sizes (bench.py's: prompt 32, 16 new
    tokens, chunks of 8): its record and every row finished."""
    monkeypatch.setenv("LLMC_BENCH_SMOKE", "1")
    recs = probe_longrange.main(["--device", "cpu", "--skip-cells"])
    (rec,) = recs
    assert rec["suite"] == "m1558_b32"
    assert (rec["batch"], rec["new_tokens"]) == (32, 16)
    assert len(rec["runs"]) == 2 and rec["tok_s"] == max(rec["runs"])
    # the prefill gives each row's first token, the decode the other 15
    assert rec["stats"]["decode_tokens"] == 32 * 15
    assert "== m1558_b32 (L2-C128): " in capsys.readouterr().out


@pytest.mark.parametrize("P,pps", [(64, 8), (40, 4)])
def test_scale_check_plain_parts_equal_jax_oracle(P, pps):
    """scale_check's plain parts on the JAX probe's rng(5) inputs against
    paged_decode_attention_quant_parts_xla on the same inputs: within
    1e-5 (f32 sums in another order)."""
    sc = probe_longrange.scale_check(P, device="cpu", pps=pps)
    inputs = probe_longrange.scale_inputs(P, pps=pps)
    want = paged_decode_attention_quant_parts_xla(
        *[jnp.asarray(a) for a in inputs])
    for got, ref in zip(sc["ref"], want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
    lengths = inputs[6]
    assert (lengths >= 1).all() and (lengths < pps * 128).all()
    assert sc["diffs"] == [0.0, 0.0, 0.0] and sc["kernels"] == {}


def test_scale_inputs_follow_the_jax_draws():
    """The draws in the JAX probe's order and dtypes, seeded with 5."""
    q, kq, vq, ks, vs, tables, lengths, starts = \
        probe_longrange.scale_inputs(72)
    rng = np.random.default_rng(5)
    np.testing.assert_array_equal(
        q, rng.standard_normal((8, 12, 64)).astype(np.float32))
    assert kq.dtype == vq.dtype == np.int8 and kq.shape == (72, 12, 64, 128)
    assert ks.dtype == np.float32 and ks.min() >= 0.005 and ks.max() < 0.02
    assert tables.shape == (8, 8) and len(np.unique(tables)) == 64
    assert starts.tolist() == [0] * 8 and lengths.dtype == np.int32
