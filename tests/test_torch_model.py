"""models/ of the port against the JAX package on the same weights: the
dense forward, prefill_paged, decode_chunk_paged and decode_step_paged
(JAX with use_kernel=False). fp32: logits within 1e-4, tokens exactly,
pools after the commit within 1e-5. The int8-weights + int8-KV + bf16
mode (the serving headline) has its own stated tolerances."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_paged_tpu.config import EngineConfig as JEngineConfig
from llmc_paged_tpu.config import PageConfig as JPageConfig
from llmc_paged_tpu.engine.engine import InferenceEngine as JEngine
from llmc_paged_tpu.kv.layouts import init_pool as j_init_pool
from llmc_paged_tpu.kv.layouts import token_coords as j_token_coords
from llmc_paged_tpu.models import gpt2 as JG
from llmc_paged_tpu.models import gpt2_paged as JGP
from llmc_paged_tpu_torch.config import EngineConfig as TEngineConfig
from llmc_paged_tpu_torch.config import PageConfig as TPageConfig
from llmc_paged_tpu_torch.convert import params_from_numpy
from llmc_paged_tpu_torch.engine.engine import InferenceEngine as TEngine
from llmc_paged_tpu_torch.kv.layouts import init_pool as t_init_pool
from llmc_paged_tpu_torch.models import gpt2 as TG
from llmc_paged_tpu_torch.models import gpt2_paged as TGP
from test_torch_common import jax_cfg, params_np, port_cfg, to_np

PS, NP, PPS = 8, 24, 6
LOGIT_TOL = 1e-4
POOL_TOL = 1e-5


@pytest.fixture(scope="module")
def fp32():
    jcfg, tcfg = jax_cfg(), port_cfg()
    p = params_np(tcfg, seed=0)
    jp = JG.to_device(p, jcfg)                    # wte padded to 2048 rows
    # the carry-over takes the JAX package's padded wte as it is
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, tcfg,
                           device="cpu")
    assert tp["wte"].shape[0] == tcfg.vocab_size
    return jcfg, tcfg, jp, tp


def test_dense_forward(fp32):
    jcfg, tcfg, jp, tp = fp32
    toks = np.random.default_rng(0).integers(0, 512, (2, 20)).astype(np.int32)
    ref = np.asarray(JG.forward(jp, jnp.asarray(toks), jcfg))
    got = TG.forward(tp, torch.from_numpy(toks), tcfg).numpy()
    assert got.shape == ref.shape == (2, 20, tcfg.vocab_size)
    np.testing.assert_allclose(got, ref, atol=LOGIT_TOL, rtol=0)


def _prefill_inputs():
    """Three right-padded prompts of lengths 13, 5, 16 on distinct pages."""
    rng = np.random.default_rng(1)
    lens = np.array([13, 5, 16], np.int32)
    T = 16
    xs = np.zeros((3, T), np.int32)
    valid = np.zeros((3, T), bool)
    for b, n in enumerate(lens):
        xs[b, :n] = rng.integers(0, 512, n)
        valid[b, :n] = True
    tables = np.arange(3 * PPS, dtype=np.int32).reshape(3, PPS)[:, ::-1].copy()
    return xs, valid, lens, tables


def _coords(tables, pos, valid):
    pg, sl = j_token_coords(jnp.asarray(tables), jnp.asarray(pos), PS,
                            jnp.asarray(valid), NP)
    return np.array(pg), np.array(sl)


def _compare_pools(jpool, tpool, tol, what):
    for jl, tl in zip(jpool, tpool):
        for j, t in zip(jl, tl):
            np.testing.assert_allclose(to_np(t), to_np(j), atol=tol, rtol=0,
                                       err_msg=what)


def _layers(pool):
    """numpy snapshot of every layer (JAX donates the pool to the next
    call and the port updates it in place)."""
    return [tuple(to_np(a).copy() for a in pool.layer(i))
            for i in range(pool.num_layers)]


def _run_paged(jcfg, tcfg, jp, tp, jpp, tpp, kv_dtype, window, K=5):
    """prefill → chunk → single step through both packages; returns the
    intermediate results side by side."""
    page_j = JPageConfig(page_size=PS, num_pages=NP, pages_per_seq=PPS,
                         kv_dtype=kv_dtype)
    page_t = TPageConfig(page_size=PS, num_pages=NP, pages_per_seq=PPS,
                         kv_dtype=kv_dtype)
    jpool = j_init_pool(jcfg, page_j, dtype=kv_dtype)
    tpool = t_init_pool(tcfg, page_t, dtype=kv_dtype)
    xs, valid, lens, tables = _prefill_inputs()
    pos = np.tile(np.arange(xs.shape[1], dtype=np.int32), (3, 1))
    pg, sl = _coords(tables, pos, valid)
    last = lens - 1
    out = {}
    jl, jpool = JGP.prefill_paged(jpp, jnp.asarray(xs), jnp.asarray(pg),
                                  jnp.asarray(sl), jpool, jcfg,
                                  last_pos=jnp.asarray(last))
    tl, tpool = TGP.prefill_paged(tpp, torch.from_numpy(xs),
                                  torch.from_numpy(pg), torch.from_numpy(sl),
                                  tpool, tcfg, last_pos=torch.from_numpy(last))
    out["prefill"] = (to_np(jl), to_np(tl))
    out["prefill_pool"] = (_layers(jpool), _layers(tpool))

    # a K-step chunk: row 1 inactive; the first token at position len
    first = np.argmax(to_np(jl), axis=-1).astype(np.int32)
    pos0 = lens.copy()
    pos0[1] = -1
    cpos = pos0[None, :] + np.arange(K, dtype=np.int32)[:, None]   # (K, B)
    cvalid = (pos0 >= 0)[None, :] & np.ones((K, 1), bool)
    pgs, sls = _coords(tables, cpos.T, cvalid.T)
    pgs, sls = pgs.T.copy(), sls.T.copy()
    jt, jpool = JGP.decode_chunk_paged(
        jp, jnp.asarray(first), jnp.asarray(pos0), jnp.asarray(pgs),
        jnp.asarray(sls), jnp.asarray(tables), jpool, jcfg, num_steps=K,
        window=window, use_kernel=False)
    tt, tpool = TGP.decode_chunk_paged(
        tp, torch.from_numpy(first), torch.from_numpy(pos0),
        torch.from_numpy(pgs), torch.from_numpy(sls),
        torch.from_numpy(tables), tpool, tcfg, num_steps=K, window=window,
        use_kernel=False)
    out["chunk"] = (np.asarray(jt), tt.numpy())
    out["chunk_pool"] = (_layers(jpool), _layers(tpool))

    # one single step after the chunk (rows 0 and 2)
    toks = np.asarray(jt)[-1]
    p = np.where(pos0 >= 0, pos0 + K, 0).astype(np.int32)
    act = pos0 >= 0
    pg1, sl1 = _coords(tables, p[:, None], act[:, None])
    pg1, sl1 = pg1[:, 0].copy(), sl1[:, 0].copy()
    lengths = np.where(act, p + 1, 0).astype(np.int32)
    starts = np.maximum(0, p + 1 - window).astype(np.int32)
    wpe = np.minimum(p, window - 1).astype(np.int32)
    args = (np.array(toks), wpe, pg1, sl1, tables, lengths)
    jl1, _ = JGP.decode_step_paged(jp, *(jnp.asarray(a) for a in args),
                                   jpool, jcfg, use_kernel=False,
                                   starts=jnp.asarray(starts))
    res = []
    for use_kernel in (False, True):     # the CPU route of both wrappers
        tl1, _ = TGP.decode_step_paged(
            tp, *(torch.from_numpy(a) for a in args), tpool, tcfg,
            use_kernel=use_kernel, starts=torch.from_numpy(starts))
        res.append(to_np(tl1))
    out["step"] = (to_np(jl1), res)
    return out


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [128, 12])
def test_paged_paths_fp32(fp32, kv_dtype, window):
    """fp32 weights; float32 or bfloat16 pool; full context or a 12-token
    sliding window (masks prompt pages, clamps wpe)."""
    jcfg, tcfg, jp, tp = fp32
    out = _run_paged(jcfg, tcfg, jp, tp, jp, tp, kv_dtype, window)
    j, t = out["prefill"]
    np.testing.assert_allclose(t, j, atol=LOGIT_TOL, rtol=0)
    # bf16 pools: the same f32 K/V rounded to bf16, so one bf16 ulp
    ptol = POOL_TOL if kv_dtype == "float32" else 1e-2
    _compare_pools(*out["prefill_pool"], ptol, "prefill pool")
    j, t = out["chunk"]
    np.testing.assert_array_equal(t, j)
    _compare_pools(*out["chunk_pool"], ptol, "chunk pool")
    j, (t_plain, t_kernel_route) = out["step"]
    np.testing.assert_allclose(t_plain, j, atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(t_kernel_route, j, atol=LOGIT_TOL, rtol=0)


def _int8_params():
    """Serving params built by each package's engine: weights cast to
    bf16, int8-quantized from there, plus the bf16 prefill copy."""
    jcfg, tcfg = jax_cfg(), port_cfg()
    p = params_np(tcfg, seed=0)
    kw = dict(greedy=True, param_dtype="int8", activation_dtype="bfloat16",
              prefill_param_dtype="bfloat16")
    je = JEngine(p, jcfg, dataclasses.replace(JEngineConfig(), **kw),
                 use_kernel=False)
    te = TEngine(p, tcfg, dataclasses.replace(TEngineConfig(), **kw),
                 device="cpu", use_kernel=False)
    return jcfg, tcfg, je, te


def test_int8_params_match():
    """The port's int8 weights and scales equal the JAX package's; the
    bf16 prefill copy is the bf16 cast of the float weights."""
    jcfg, tcfg, je, te = _int8_params()
    for k, v in te.params.items():
        j = np.asarray(je.params[k])[: v.shape[0]] if k.startswith("wte") \
            else np.asarray(je.params[k])
        np.testing.assert_array_equal(to_np(v), to_np(j), err_msg=k)
        assert str(v.dtype).split(".")[-1] == str(je.params[k].dtype), k
    for k, v in te._prefill_params.items():
        assert v.dtype == (torch.float32 if k in TG.LN_KEYS
                           else torch.bfloat16), k


def test_paged_paths_int8_bf16():
    """int8 weights, int8 KV, bf16 activations, bf16 prefill copy.

    Tolerances, and why: the bf16 prefill rounds every matmul output to
    8 mantissa bits in both packages, but XLA and torch may round a
    different element (sums taken in another order), so prefill logits
    agree to a few bf16 ulps of their size (|logit| < 1: 2e-2). Such
    ulps compound through the layers and move a K/V element across int8
    rounding boundaries, so the pools agree to a few quantization steps
    (compared dequantized; measured up to 2 steps at these sizes, bound
    4).
    The decode path runs f32 activations with the activation rounded to
    bf16 before each int8 product; its logits agree to 5e-3. Greedy
    tokens are compared exactly: the test asserts that every pick has a
    top-2 margin larger than the logit tolerance."""
    jcfg, tcfg, je, te = _int8_params()
    out = _run_paged(jcfg, tcfg, je.params, te.params, je._prefill_params,
                     te._prefill_params, "int8", 128)
    j, t = out["prefill"]
    np.testing.assert_allclose(t, j, atol=2e-2, rtol=0)
    for jl, tl in zip(*out["chunk_pool"]):
        jk, jv, jks, jvs = (a.astype(np.float32) for a in jl)
        tk, tv, tks, tvs = (a.astype(np.float32) for a in tl)
        for jq, js, tq, ts in ((jk, jks, tk, tks), (jv, jvs, tv, tvs)):
            jd = jq * js[:, :, None, :]
            td = tq * ts[:, :, None, :]
            step = np.maximum(js, ts)[:, :, None, :]
            assert np.all(np.abs(jd - td) <= 4 * step + 1e-6)
    j, t = out["chunk"]
    np.testing.assert_array_equal(t, j)
    j, (t_plain, t_kernel_route) = out["step"]
    for t_ in (t_plain, t_kernel_route):
        np.testing.assert_allclose(t_, j, atol=5e-3, rtol=0)
    top2 = np.sort(j[[0, 2]], axis=-1)[:, -2:]
    assert np.all(top2[:, 1] - top2[:, 0] > 5e-3)
