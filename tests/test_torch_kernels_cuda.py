"""The CUDA paged-attention kernels (the single-query and multi-query
parts kernels, the normalized grid kernel) against their plain PyTorch
versions, on the card (marked ``cuda``; skipped where there is no GPU).

This file imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from llmc_paged_tpu_torch.ops import paged_attention as T
from test_torch_common import cuda  # noqa: F401  (fixture)

NH, HS = 2, 64


def _case(ps, quant, seed=0, B=5, pps=4):
    """Ragged lengths with a zero-length row and a page-boundary length;
    window starts that mask whole pages and one fully masked row."""
    rng = np.random.default_rng(seed)
    P = B * pps + 3
    q = rng.standard_normal((B, NH, HS)).astype(np.float32)
    if quant:
        k = rng.integers(-127, 128, (P, NH, HS, ps)).astype(np.int8)
        v = rng.integers(-127, 128, (P, NH, HS, ps)).astype(np.int8)
        ks = rng.uniform(1e-3, 2e-2, (P, NH, ps)).astype(np.float32)
        vs = rng.uniform(1e-3, 2e-2, (P, NH, ps)).astype(np.float32)
        pool = (k, v, ks, vs)
    else:
        pool = tuple(rng.standard_normal((P, NH, HS, ps)).astype(np.float32)
                     for _ in range(2))
    tables = rng.permutation(P)[: B * pps].reshape(B, pps).astype(np.int32)
    cap = ps * pps
    lengths = np.array([cap, 0, ps, 1 + ps // 2, cap - 3], np.int32)
    starts = np.array([ps + 1, 0, 0, lengths[3] + 1, cap - 2 * ps + 1],
                      np.int32)
    return q, pool, tables, lengths, starts


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8", "int8-qbf16"])
@pytest.mark.parametrize("ps", [8, 32, 128])
def test_kernel_matches_plain_on_the_card(cuda, kv, ps):  # noqa: F811
    """CUDA kernel vs plain version on the same tensors; bf16 pools are
    compared with the plain version over the same bf16 values (it upcasts
    to f32); "int8-qbf16" is the int8 pool under the bf16 q the headline
    engine sends. Tolerance 1e-4 abs + 1e-4 rel: f32 sums in another
    order."""
    quant = kv.startswith("int8")
    q, pool, tables, lengths, starts = _case(ps, quant, seed=11)
    a = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
         for x in (q, *pool, tables, lengths, starts)]
    if kv == "int8-qbf16":
        a[0] = a[0].to(torch.bfloat16)
    if kv == "bfloat16":
        a[1], a[2] = a[1].to(torch.bfloat16), a[2].to(torch.bfloat16)
    fn = T.paged_decode_attention_quant_parts if quant \
        else T.paged_decode_attention_parts
    ref_fn = T.paged_decode_attention_quant_parts_ref if quant \
        else T.paged_decode_attention_parts_ref
    name = ("paged_decode_attention_quant_parts" if quant
            else "paged_decode_attention_parts")
    before = T.LAUNCHES[name]
    got = fn(*a)
    torch.cuda.synchronize()
    assert T.LAUNCHES[name] == before + 1
    for g, r in zip(got, ref_fn(*a)):
        torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):  # noqa: F811
    q, pool, tables, lengths, starts = _case(8, False)
    q, k, v, tables, lengths, starts = (
        torch.from_numpy(x).to(cuda)
        for x in (q, *pool, tables, lengths, starts))
    with pytest.raises(TypeError):
        T.paged_decode_attention_parts(q, k.half(), v.half(), tables,
                                       lengths, starts)
    strided = q.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        T.paged_decode_attention_parts(strided, k, v, tables, lengths, starts)
    with pytest.raises(ValueError, match="is on"):
        T.paged_decode_attention_parts(q, k, v, tables.cpu(), lengths,
                                       starts)


def _mq_case(ps, KQ, quant, seed=0, B=5, pps=4):
    """The single-query case's pool, lengths and starts with KQ queries a
    row."""
    q1, pool, tables, lengths, starts = _case(ps, quant, seed, B, pps)
    rng = np.random.default_rng(seed + 1)
    q = rng.standard_normal((B, KQ, NH, HS)).astype(np.float32)
    return q, pool, tables, lengths, starts


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8", "int8-qbf16"])
@pytest.mark.parametrize("ps,KQ", [(8, 3), (32, 1), (128, 4), (32, 37),
                                   (128, 96)])
def test_mq_kernel_matches_plain_on_the_card(cuda, kv, ps, KQ):  # noqa: F811
    """Multi-query kernel vs its plain version: one query tile (KQ <= 16)
    and several (37, 96 — above the TPU kernel's 64), ragged, zero and
    windowed rows; "int8-qbf16" is the int8 pool under the bf16 q of the
    headline's spec verify and suffix prefill. Tolerance 1e-4 abs + 1e-4
    rel (f32 sums in another order)."""
    quant = kv.startswith("int8")
    q, pool, tables, lengths, starts = _mq_case(ps, KQ, quant, seed=5)
    a = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
         for x in (q, *pool, tables, lengths, starts)]
    if kv in ("bfloat16", "int8-qbf16"):
        a[0] = a[0].to(torch.bfloat16)
    if kv == "bfloat16":
        a[1], a[2] = a[1].to(torch.bfloat16), a[2].to(torch.bfloat16)
    fn = T.paged_decode_attention_quant_parts_mq if quant \
        else T.paged_decode_attention_parts_mq
    ref_fn = T.paged_decode_attention_quant_parts_mq_ref if quant \
        else T.paged_decode_attention_parts_mq_ref
    name = ("paged_decode_attention_quant_parts_mq" if quant
            else "paged_decode_attention_parts_mq")
    before = T.LAUNCHES[name]
    got = fn(*a)
    torch.cuda.synchronize()
    assert T.LAUNCHES[name] == before + 1
    assert got[0].shape == (q.shape[0], KQ, NH, HS)
    for g, r in zip(got, ref_fn(*a)):
        torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_mq_kernel_rejects_what_it_does_not_take(cuda):  # noqa: F811
    q, pool, tables, lengths, starts = _mq_case(8, 4, False)
    q, k, v, tables, lengths, starts = (
        torch.from_numpy(x).to(cuda)
        for x in (q, *pool, tables, lengths, starts))
    with pytest.raises(ValueError, match="KQ"):
        T.paged_decode_attention_parts_mq(q[:, 0], k, v, tables, lengths,
                                          starts)
    with pytest.raises(TypeError):
        T.paged_decode_attention_parts_mq(q, k.half(), v.half(), tables,
                                          lengths, starts)
    big = torch.zeros(2, NH, HS, 1024, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        T.paged_decode_attention_parts_mq(q[:1], big, big, tables[:1, :1],
                                          lengths[:1], starts[:1])


def _grid_case(ps, seed=0, B=6, pps=4):
    """Ragged lengths, a zero-length row, a start >= length row (length 5,
    start 7), window starts masking whole pages."""
    rng = np.random.default_rng(seed)
    P = B * pps + 3
    q = rng.standard_normal((B, NH, HS)).astype(np.float32)
    k, v = (rng.standard_normal((P, NH, HS, ps)).astype(np.float32)
            for _ in range(2))
    ks, vs = (rng.uniform(1e-3, 2e-2, (P, NH, ps)).astype(np.float32)
              for _ in range(2))
    kq, vq = (rng.integers(-127, 128, (P, NH, HS, ps)).astype(np.int8)
              for _ in range(2))
    tables = rng.permutation(P)[: B * pps].reshape(B, pps).astype(np.int32)
    cap = ps * pps
    lengths = np.array([cap, 0, 5, ps + 3, cap - 3, 1], np.int32)
    starts = np.array([ps + 1, 0, 7, 0, cap - 2 * ps + 1, 0], np.int32)
    return q, (k, v), (kq, vq, ks, vs), tables, lengths, starts


@pytest.mark.cuda
@pytest.mark.parametrize("qd", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("ps", [8, 16, 32, 96])
def test_grid_kernel_matches_plain_on_the_card(cuda, ps, kv, qd):  # noqa: F811
    """The normalized grid kernel vs its plain version, reached through
    the normalized wrappers (ps % 128 != 0 routes there). Tolerance: an
    f32 output within 1e-5 abs + 1e-5 rel (f32 sums in another order); a
    bf16 output within one bf16 ulp (both compute in f32 and round once)
    plus 1e-6 (the f32 sums differ by ~1e-7 of the values they sum, more
    than a bf16 ulp of an output near 0). The zero-length and
    start >= length rows are exact zeros."""
    q, fpool, qpool, tables, lengths, starts = _grid_case(ps, seed=ps)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    tq = torch.from_numpy(q).to(cuda).to(dt[qd])
    idx = [torch.from_numpy(a).to(cuda) for a in (tables, lengths, starts)]
    if kv == "int8":
        pool = [torch.from_numpy(a).to(cuda) for a in qpool]
        fn, ref_fn = (T.paged_decode_attention_quant,
                      T.paged_decode_attention_quant_grid_ref)
        name = "paged_decode_attention_quant_grid"
    else:
        pool = [torch.from_numpy(a).to(cuda).to(dt[kv]) for a in fpool]
        fn, ref_fn = (T.paged_decode_attention,
                      T.paged_decode_attention_grid_ref)
        name = "paged_decode_attention_grid"
    before = T.LAUNCHES[name]
    got = fn(tq, *pool, *idx)
    torch.cuda.synchronize()
    assert T.LAUNCHES[name] == before + 1
    ref = ref_fn(tq, *pool, *idx)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    g, r = got.float(), ref.float()
    if qd == "bfloat16":
        ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(
            2.0 ** -126))) - 7)
        assert bool(((g - r).abs() <= ulp + 1e-6).all())
    else:
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5)
    assert bool((g[1] == 0).all()) and bool((g[2] == 0).all())


@pytest.mark.cuda
def test_grid_kernel_rejects_what_it_does_not_take(cuda):  # noqa: F811
    q, (k, v), _, tables, lengths, starts = _grid_case(8)
    q, k, v, tables, lengths, starts = (
        torch.from_numpy(x).to(cuda)
        for x in (q, k, v, tables, lengths, starts))
    with pytest.raises(ValueError, match="head_dim"):
        T.paged_decode_attention_grid(q[..., :48].contiguous(),
                                      k[:, :, :48].contiguous(),
                                      v[:, :, :48].contiguous(), tables,
                                      lengths, starts)
    with pytest.raises(TypeError):
        T.paged_decode_attention_grid(q, k.half(), v.half(), tables,
                                      lengths, starts)
    with pytest.raises(ValueError, match="is on"):
        T.paged_decode_attention_grid(q, k, v, tables, lengths.cpu(),
                                      starts)
