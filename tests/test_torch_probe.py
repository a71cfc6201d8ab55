"""The port's decode-step probe (llmc_paged_tpu_torch/ops/dev/
probe_decode.py) on the CPU: every suite at a tiny configuration returns
its records; the unrolled chunk's greedy tokens equal the port's and the
JAX package's decode_chunk_paged on the same numpy parameters at fp32;
the JAX probe's TPU-only flag is refused."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_paged_tpu.config import PageConfig as JPageConfig
from llmc_paged_tpu.kv.layouts import init_pool as j_init_pool
from llmc_paged_tpu.kv.layouts import token_coords as j_token_coords
from llmc_paged_tpu.models import gpt2 as JG
from llmc_paged_tpu.models import gpt2_paged as JGP
from llmc_paged_tpu_torch.config import GPT2Config, PageConfig
from llmc_paged_tpu_torch.convert import params_from_numpy
from llmc_paged_tpu_torch.kv.layouts import PagePool, init_pool
from llmc_paged_tpu_torch.models import gpt2_paged as TGP
from llmc_paged_tpu_torch.ops.dev import probe_decode as P
from test_torch_common import jax_cfg, params_np, port_cfg

# GPT2Config.tiny with room for the suites' 128-token prompts plus a
# 32-step chunk
TINY = GPT2Config.tiny(max_seq_len=256)
B = 4


@pytest.mark.parametrize("suite,kw,names", [
    (P.gemv_suite, dict(iters=2), None),
    (P.kernel_suite, dict(iters=2), None),
    (P.kernel_serving, dict(iters=2, deep=True), None),
    (P.matmul_suite, {}, ["float32", "bfloat16", "int8", "int8xla",
                          "int8+head"]),
    (P.attention_suite, {}, ["float32", "bfloat16", "int8",
                             "int8-scatteronly", "int8-attendonly",
                             "float32-P2", "bfloat16-P4", "int8-stale"]),
    (P.prefill_suite, {}, ["float32", "bfloat16", "int8", "int8bf16"]),
    (P.chunk_suite, {}, ["float32", "bfloat16", "int8", "int8b",
                         "int8b:bfloat16", "float32-xlaattn"]),
    (P.chunk_suite_unrolled, {}, ["float32", "bfloat16"]),
], ids=lambda x: getattr(x, "__name__", None) if callable(x) else None)
def test_suite_returns_its_records_on_the_cpu(suite, kw, names, capsys):
    """One record a printed line, named by its dtype where the suite takes
    dtypes, host time only (no device numbers on the CPU), no launch."""
    if names is not None:
        kw = dict(kw, dtypes=names)
    records = suite(B, TINY, device="cpu", **kw)
    out = capsys.readouterr().out
    n = {P.gemv_suite: 15, P.kernel_suite: 1, P.kernel_serving: 7}.get(
        suite, len(names or ()))
    assert len(records) == n
    if names is not None:
        assert [r["name"] for r in records] == names
    for r in records:
        assert r["ms"] == r["host_ms"] > 0
        assert r["device_ms"] is r["busy_ms"] is r["covered"] is None
        assert r["kernels"] == {} and r["units"] >= 2
    assert out.count(" ms") >= n


def test_unrolled_chunk_tokens_equal_both_chunks():
    """fp32, page size 8: prefill three prompts in both packages, then
    6 greedy steps through the JAX decode_chunk_paged, the
    port's, and the probe's unrolled chunk (each on its own copy of the
    pool): the same tokens."""
    jcfg, tcfg = jax_cfg(), port_cfg()
    p = params_np(tcfg, seed=0)
    jp = JG.to_device(p, jcfg)
    tp = params_from_numpy(p, tcfg, device="cpu")
    PS, NP, PPS, K = 8, 24, 6, 6
    lens = np.array([13, 5, 16], np.int32)
    T = 16
    rng = np.random.default_rng(1)
    xs = np.zeros((3, T), np.int32)
    valid = np.zeros((3, T), bool)
    for b, n in enumerate(lens):
        xs[b, :n] = rng.integers(0, tcfg.vocab_size, n)
        valid[b, :n] = True
    tables = np.arange(3 * PPS, dtype=np.int32).reshape(3, PPS)[:, ::-1].copy()

    def coords(pos, ok):
        pg, sl = j_token_coords(jnp.asarray(tables), jnp.asarray(pos), PS,
                                jnp.asarray(ok), NP)
        return np.array(pg), np.array(sl)

    pg, sl = coords(np.tile(np.arange(T, dtype=np.int32), (3, 1)), valid)
    jpool = j_init_pool(jcfg, JPageConfig(page_size=PS, num_pages=NP,
                                          pages_per_seq=PPS))
    jl, jpool = JGP.prefill_paged(jp, jnp.asarray(xs), jnp.asarray(pg),
                                  jnp.asarray(sl), jpool, jcfg,
                                  last_pos=jnp.asarray(lens - 1))
    tpool = init_pool(tcfg, PageConfig(page_size=PS, num_pages=NP,
                                       pages_per_seq=PPS), device="cpu")
    _, tpool = TGP.prefill_paged(tp, torch.from_numpy(xs),
                                 torch.from_numpy(pg), torch.from_numpy(sl),
                                 tpool, tcfg,
                                 last_pos=torch.from_numpy(lens - 1))
    first = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
    cpos = lens[None, :] + np.arange(K, dtype=np.int32)[:, None]    # (K, B)
    pgs, sls = coords(cpos.T, np.ones((3, K), bool))
    pgs, sls = pgs.T.copy(), sls.T.copy()
    want, _ = JGP.decode_chunk_paged(
        jp, jnp.asarray(first), jnp.asarray(lens), jnp.asarray(pgs),
        jnp.asarray(sls), jnp.asarray(tables), jpool, jcfg, num_steps=K,
        window=jcfg.max_seq_len, use_kernel=False)
    args = [torch.from_numpy(a) for a in (first, lens, pgs, sls, tables)]
    copy = PagePool([t.clone() for t in tpool.k],
                    [t.clone() for t in tpool.v])
    chunk, _ = TGP.decode_chunk_paged(tp, *args, tpool, tcfg, num_steps=K,
                                      window=tcfg.max_seq_len)
    unrolled, _ = P.chunk_unrolled(tp, *args, copy, tcfg, K,
                                   tcfg.max_seq_len)
    np.testing.assert_array_equal(chunk.numpy(), np.asarray(want))
    np.testing.assert_array_equal(unrolled.numpy(), np.asarray(want))


def test_attn_variants_are_refused(capsys):
    with pytest.raises(SystemExit) as e:
        P.main(["--device", "cpu", "--attn-variants", "flat2"])
    assert e.value.code != 0
    assert "no counterpart in the port" in capsys.readouterr().err


def test_main_runs_the_suites_it_is_not_told_to_skip(monkeypatch):
    """main() dispatches each suite with its flags and tags the records
    with their suite and its seconds; skipped suites do not run."""
    calls = []

    def fake(name):
        def suite(*a, **kw):
            calls.append((name, kw))
            return [dict(name=name)]
        return suite

    for fn in ("gemv_suite", "kernel_suite", "kernel_serving",
               "matmul_suite", "prefill_suite", "attention_suite",
               "chunk_suite", "chunk_suite_unrolled"):
        monkeypatch.setattr(P, fn, fake(fn))
    records = P.main(["--device", "cpu", "--model", "1558m", "--skip",
                      "matmul,prefill,attention,unrolled,kdeep", "--prompt",
                      "128,896", "--dtypes", "int8,int8xla,int8:bfloat16",
                      "--iters", "3"])
    assert [c[0] for c in calls] == ["gemv_suite", "kernel_suite",
                                     "kernel_serving", "chunk_suite",
                                     "chunk_suite"]
    assert calls[2][1]["deep"] is False and calls[0][1]["iters"] == 3
    assert [c[1]["prompt"] for c in calls[3:]] == [128, 896]
    assert calls[3][1]["dtypes"] == ["int8", "int8xla", "int8:bfloat16"]
    assert [r["suite"] for r in records] == ["gemv", "kernel", "kserve",
                                             "chunk", "chunk"]
    assert all(r["suite_s"] >= 0 for r in records)


def test_prefill_suite_sizes_the_pool_from_T(capsys):
    """T = 512 needs 4 pages of 128 a row (the pool was fixed at 3): the
    suite runs, one record a dtype (no dense line on the CPU, where the
    flash route is never taken), host time only, no launch."""
    cfg = GPT2Config.tiny(max_seq_len=512)
    records = P.prefill_suite(2, cfg, dtypes=("bfloat16", "int8bf16"),
                              T=512, device="cpu")
    assert [r["name"] for r in records] == ["bfloat16", "int8bf16"]
    assert all(r["config"] == (2, 512) and r["kernels"] == {}
               and r["host_ms"] > 0 for r in records)
    assert "B=2 T=512" in capsys.readouterr().out


def test_main_sweeps_the_prefill_lengths(monkeypatch):
    """--prefill-lengths runs the prefill suite once a length (default:
    128 alone, as before)."""
    seen = []

    def fake(B, cfg, T=128, **kw):
        seen.append(T)
        return [dict(name="bfloat16")]

    monkeypatch.setattr(P, "prefill_suite", fake)
    skip = "gemv,kernel,kserve,matmul,attention,chunk,unrolled"
    P.main(["--device", "cpu", "--skip", skip])
    records = P.main(["--device", "cpu", "--skip", skip,
                      "--prefill-lengths", "256,896"])
    assert seen == [128, 256, 896]
    assert [r["suite"] for r in records] == ["prefill", "prefill"]
