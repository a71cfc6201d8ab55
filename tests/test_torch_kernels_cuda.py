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


# ---- the kernel lab's kernels (int8_matmul, layernorm_rows, softmax_rows,
# flatwide_parts) -----------------------------------------------------------

def _within_bf16_ulp(got, ref):
    """Every element within one bf16 ulp of |ref| plus 1e-6 (both sides
    compute in f32 and round once; f32 sums in another order move an
    output near 0 by more than its ulp)."""
    g, r = got.float(), ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(
        2.0 ** -126))) - 7)
    return bool(((g - r).abs() <= ulp + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("xd", ["float32", "bfloat16"])
@pytest.mark.parametrize("IC", [64, 70, 768, 6400])
@pytest.mark.parametrize("OC", [1, 96, 2304])
@pytest.mark.parametrize("B", [1, 8, 256])
def test_int8_matmul_matches_plain_on_the_card(cuda, B, OC, IC, xd):  # noqa: F811
    """The int8 kernel vs its plain version in both compute modes: IC 70
    takes the byte path (rows not 16-byte aligned), 64, 768 and 6400 the
    16-byte vectors, and 6400 (the 1.5B fcproj width, above the kernel's
    2048-column chunk) stages x chunk by chunk; OC 1 and 96 leave a
    block's channels partly empty, B 1 and 256 its rows. Tolerance 1e-5
    rel + 1e-5·max|ref| abs: f32 sums in another order."""
    from llmc_paged_tpu_torch.ops import int8 as Q
    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.default_rng(B * 7 + OC + IC)
    x = torch.from_numpy(rng.standard_normal((B, IC)).astype(np.float32))
    w = torch.from_numpy((0.05 * rng.standard_normal((OC, IC)))
                         .astype(np.float32))
    wq, s = Q.quantize_per_row(w)
    x, wq, s = x.to(cuda).to(getattr(torch, xd)), wq.to(cuda), s.to(cuda)
    for bf16 in (True, False):
        key = "int8_matmul_bf16" if bf16 else "int8_matmul_fp32"
        before = Q.LAUNCHES[key]
        got = Q.int8_matmul(x, wq, s, bf16_compute=bf16)
        torch.cuda.synchronize()
        assert Q.LAUNCHES[key] == before + 1
        ref = Q.int8_matmul_ref(x, wq, s, bf16_compute=bf16)
        assert got.dtype == torch.float32 and got.shape == (B, OC)
        tol = 1e-5 * float(ref.abs().max())
        torch.testing.assert_close(got, ref, atol=tol, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("xd", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [64, 768, 1600])
@pytest.mark.parametrize("R", [1, 8, 1000])
def test_layernorm_rows_matches_plain_on_the_card(cuda, R, C, xd):  # noqa: F811
    """The row layernorm kernel vs ops/layers.layernorm: f32 within 1e-5
    abs + 1e-5 rel, bf16 within one ulp (statistics in f32, one
    rounding)."""
    from llmc_paged_tpu_torch.ops.dev import bench_layernorm as LN
    from llmc_paged_tpu_torch.ops.layers import layernorm
    rng = np.random.default_rng(R + C)
    x, w, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda) for s in ((R, C), (C,), (C,)))
    x = x.to(getattr(torch, xd))
    before = LN.LAUNCHES["layernorm_rows"]
    got = LN.layernorm_rows(x, w, b)
    torch.cuda.synchronize()
    assert LN.LAUNCHES["layernorm_rows"] == before + 1
    ref = layernorm(x, w, b)
    assert got.dtype == x.dtype and got.shape == x.shape
    if xd == "bfloat16":
        assert _within_bf16_ulp(got, ref)
    else:
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("xd", ["float32", "bfloat16"])
@pytest.mark.parametrize("V", [1000, 50257, 50304])
@pytest.mark.parametrize("B", [1, 7, 8])
def test_softmax_rows_matches_plain_on_the_card(cuda, B, V, xd):  # noqa: F811
    """The vocab softmax kernel vs its plain version (max, exp, sum):
    f32 within 1e-6 abs + 1e-5 rel, bf16 within one ulp."""
    from llmc_paged_tpu_torch.ops.dev import bench_softmax as SM
    rng = np.random.default_rng(B + V)
    x = torch.from_numpy(4 * rng.standard_normal((B, V)).astype(np.float32))
    x = x.to(cuda).to(getattr(torch, xd))
    before = SM.LAUNCHES["softmax_rows"]
    got = SM.softmax_rows(x)
    torch.cuda.synchronize()
    assert SM.LAUNCHES["softmax_rows"] == before + 1
    ref = SM.softmax_rows_ref(x)
    assert got.dtype == x.dtype and got.shape == x.shape
    if xd == "bfloat16":
        assert _within_bf16_ulp(got, ref)
    else:
        torch.testing.assert_close(got, ref, atol=1e-6, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8", "int8-qbf16"])
@pytest.mark.parametrize("ps", [8, 32, 128])
def test_flatwide_matches_plain_on_the_card(cuda, kv, ps):  # noqa: F811
    """The flatwide parts kernel vs the plain parts versions on the
    zero, ragged and windowed rows of ``_case`` (row 3: start > length).
    Tolerance 1e-4 abs + 1e-4 rel: f32 sums in another order."""
    from llmc_paged_tpu_torch.ops.dev import lab_flatwide as FW
    quant = kv.startswith("int8")
    q, pool, tables, lengths, starts = _case(ps, quant, seed=17)
    a = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
         for x in (q, *pool, tables, lengths, starts)]
    if kv == "int8-qbf16":
        a[0] = a[0].to(torch.bfloat16)
    if kv == "bfloat16":
        a[1], a[2] = a[1].to(torch.bfloat16), a[2].to(torch.bfloat16)
    if quant:
        q, k, v, ks, vs, tables, lengths, starts = a
        scales, key = (ks, vs), "flatwide_quant_parts"
        ref = T.paged_decode_attention_quant_parts_ref(q, k, v, ks, vs, tables,
                                                       lengths, starts)
    else:
        q, k, v, tables, lengths, starts = a
        scales, key = None, "flatwide_parts"
        ref = T.paged_decode_attention_parts_ref(q, k, v, tables, lengths,
                                                 starts)
    before = FW.LAUNCHES[key]
    got = FW.flatwide_parts(q, k, v, tables, lengths, starts, scales)
    torch.cuda.synchronize()
    assert FW.LAUNCHES[key] == before + 1
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-4)
    assert float(got[2][1].abs().max()) == 0.0     # the zero-length row
    assert bool((got[1][3] == T.NEG_INF).all())    # start > length


@pytest.mark.cuda
def test_lab_kernels_reject_what_they_do_not_take(cuda):  # noqa: F811
    from llmc_paged_tpu_torch.ops import int8 as Q
    from llmc_paged_tpu_torch.ops.dev import bench_layernorm as LN
    from llmc_paged_tpu_torch.ops.dev import bench_softmax as SM
    from llmc_paged_tpu_torch.ops.dev import lab_flatwide as FW
    x = torch.zeros(4, 64, device=cuda)
    wq = torch.zeros(8, 64, dtype=torch.int8, device=cuda)
    s = torch.ones(8, device=cuda)
    with pytest.raises(TypeError):
        Q.int8_matmul(x.half(), wq, s)
    with pytest.raises(ValueError, match="is on"):
        Q.int8_matmul(x, wq, s.cpu())
    with pytest.raises(ValueError, match="shape"):
        Q.int8_matmul(x, wq[:, :32].contiguous(), s)
    with pytest.raises(ValueError, match="exceeds"):
        LN.layernorm_rows(torch.zeros(2, 4096, device=cuda),
                          torch.ones(4096, device=cuda),
                          torch.zeros(4096, device=cuda))
    with pytest.raises(ValueError, match="exceeds"):
        SM.softmax_rows(torch.zeros(1, 60000, device=cuda))
    q, pool, tables, lengths, starts = _case(8, False)
    q, k, v, tables, lengths, starts = (
        torch.from_numpy(x).to(cuda)
        for x in (q, *pool, tables, lengths, starts))
    with pytest.raises(ValueError, match="head_dim"):
        FW.flatwide_parts(q[..., :32].contiguous(), k[:, :, :32].contiguous(),
                          v[:, :, :32].contiguous(), tables, lengths, starts)
    big = torch.zeros(2, NH, HS, 32768, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        FW.flatwide_parts(q[:1], big, big, tables[:1, :2], lengths[:1],
                          starts[:1])


# ---- the stacked-pool ("full-pool") lab kernel -------------------------------

def _full_case(ps, seed, L=3, B=6, pps=4):
    """q and stacked (L, P, NH, HS, ps) pools (float, and int8 with
    scales); ragged lengths with a zero-length row, a start >= length row
    (5/7), windowed rows; every table entry outside a row's live range
    [start//ps, (len-1)//ps] is the sentinel P."""
    rng = np.random.default_rng(seed)
    P = B * pps + 3
    q = rng.standard_normal((B, NH, HS)).astype(np.float32)
    fpool = [rng.standard_normal((L, P, NH, HS, ps)).astype(np.float32)
             for _ in range(2)]
    qpool = [rng.integers(-127, 128, (L, P, NH, HS, ps)).astype(np.int8)
             for _ in range(2)]
    qpool += [rng.uniform(1e-3, 2e-2, (L, P, NH, ps)).astype(np.float32)
              for _ in range(2)]
    tables = rng.permutation(P)[: B * pps].reshape(B, pps).astype(np.int32)
    cap = ps * pps
    lengths = np.array([cap, 0, 5, ps + 3, cap - 3, 1], np.int32)
    starts = np.array([ps + 1, 0, 7, 0, cap - 2 * ps + 1, 0], np.int32)
    col = np.arange(pps)[None, :]
    live = ((col >= (starts // ps)[:, None])
            & (col <= ((lengths - 1) // ps)[:, None]) & (lengths > 0)[:, None])
    tables[~live] = P
    return q, fpool, qpool, tables, lengths, starts


def _full_close(got, ref):
    """f32 outputs within 1e-5 abs + 1e-5 rel (f32 sums in another
    order); bf16 within one bf16 ulp plus 1e-6 (both round an f32 result
    once)."""
    if got.dtype == torch.bfloat16:
        return _within_bf16_ulp(got, ref)
    return bool(((got - ref).abs() <= 1e-5 + 1e-5 * ref.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("qd", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("ps", [8, 32, 128])
def test_full_pool_kernel_matches_plain_on_the_card(cuda, ps, kv, qd):  # noqa: F811
    """The full-pool kernel vs its plain version on every plane, the
    layer as a (1,) int32 tensor on the card and as a host int. The
    zero-length and start >= length rows are exact zeros."""
    from llmc_paged_tpu_torch.ops.dev import lab_full_pool as FP
    q, fpool, qpool, tables, lengths, starts = _full_case(ps, seed=ps + 1)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    tq = torch.from_numpy(q).to(cuda).to(dt[qd])
    idx = [torch.from_numpy(a).to(cuda) for a in (tables, lengths, starts)]
    if kv == "int8":
        pool = [torch.from_numpy(a).to(cuda) for a in qpool]
        fn, ref_fn = (FP.paged_decode_attention_quant_full,
                      FP.paged_decode_attention_quant_full_ref)
        name = "paged_decode_attention_quant_full"
    else:
        pool = [torch.from_numpy(a).to(cuda).to(dt[kv]) for a in fpool]
        fn, ref_fn = (FP.paged_decode_attention_full,
                      FP.paged_decode_attention_full_ref)
        name = "paged_decode_attention_full"
    for layer in range(3):
        ref = ref_fn(tq, *pool, layer, *idx)
        for lay in (torch.tensor([layer], dtype=torch.int32, device=cuda),
                    layer):
            before = FP.LAUNCHES[name]
            got = fn(tq, *pool, lay, *idx)
            torch.cuda.synchronize()
            assert FP.LAUNCHES[name] == before + 1
            assert got.dtype == tq.dtype and got.shape == tq.shape
            assert _full_close(got, ref), (layer, float(
                (got.float() - ref.float()).abs().max()))
            assert bool((got[1] == 0).all()) and bool((got[2] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["int8", "float32"])
def test_full_pool_kernel_offsets_past_32_bits(cuda, kv):  # noqa: F811
    """Plane offsets past 2^31: an int8 pool at the 1.5B depth (L=48,
    P=224, NH=25, HS=64, ps=128: 2.2e9 elements a pool) read at layer
    47, and an f32 pool of 2.4e9 bytes read at its last layer. Only that
    plane holds data (the others are zero), so a wrong plane offset
    disagrees with the plain version."""
    from llmc_paged_tpu_torch.ops.dev import lab_full_pool as FP
    L, P, NH_, ps = (48, 224, 25, 128) if kv == "int8" else (24, 256, 12, 128)
    B, pps = 8, 3
    g = torch.Generator(device=cuda).manual_seed(5)
    dt = torch.int8 if kv == "int8" else torch.float32
    k, v = (torch.zeros((L, P, NH_, HS, ps), dtype=dt, device=cuda)
            for _ in range(2))
    assert k.numel() * k.element_size() > 2 ** 31
    for t in (k, v):
        if kv == "int8":
            t[L - 1] = torch.randint(-127, 128, t.shape[1:], generator=g,
                                     device=cuda, dtype=torch.int8)
        else:
            t[L - 1] = torch.randn(t.shape[1:], generator=g, device=cuda)
    tables = torch.randperm(P, generator=g, device=cuda)[: B * pps].reshape(
        B, pps).to(torch.int32)
    lengths = torch.tensor([384, 1, 129, 256, 300, 77, 383, 200],
                           dtype=torch.int32, device=cuda)
    starts = torch.tensor([0, 0, 100, 0, 256, 0, 5, 0], dtype=torch.int32,
                          device=cuda)
    layer = torch.tensor([L - 1], dtype=torch.int32, device=cuda)
    if kv == "int8":
        ks, vs = (torch.zeros((L, P, NH_, ps), device=cuda) for _ in range(2))
        ks[L - 1] = 1e-3 + 1e-2 * torch.rand(ks.shape[1:], generator=g,
                                             device=cuda)
        vs[L - 1] = 1e-3 + 1e-2 * torch.rand(vs.shape[1:], generator=g,
                                             device=cuda)
        q = torch.randn(B, NH_, HS, generator=g, device=cuda).bfloat16()
        got = FP.paged_decode_attention_quant_full(q, k, v, ks, vs, layer,
                                                   tables, lengths, starts)
        ref = FP.paged_decode_attention_quant_full_ref(q, k, v, ks, vs, L - 1,
                                                       tables, lengths, starts)
    else:
        q = torch.randn(B, NH_, HS, generator=g, device=cuda)
        got = FP.paged_decode_attention_full(q, k, v, layer, tables, lengths,
                                             starts)
        ref = FP.paged_decode_attention_full_ref(q, k, v, L - 1, tables,
                                                 lengths, starts)
    torch.cuda.synchronize()
    assert float(ref.float().abs().max()) > 0
    assert _full_close(got, ref), float((got.float() - ref.float()).abs()
                                        .max())
    del k, v
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_full_pool_kernel_rejects_what_it_does_not_take(cuda):  # noqa: F811
    from llmc_paged_tpu_torch.ops.dev import lab_full_pool as FP
    q, fpool, _, tables, lengths, starts = _full_case(8, seed=0)
    q, k, v, tables, lengths, starts = (
        torch.from_numpy(a).to(cuda)
        for a in (q, *fpool, tables, lengths, starts))
    layer = torch.tensor([1], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        FP.paged_decode_attention_full(
            q[..., :48].contiguous(), k[:, :, :, :48].contiguous(),
            v[:, :, :, :48].contiguous(), layer, tables, lengths, starts)
    with pytest.raises(TypeError):
        FP.paged_decode_attention_full(q, k, v, layer.long(), tables,
                                       lengths, starts)
    with pytest.raises(ValueError, match="is on"):
        FP.paged_decode_attention_full(q, k, v, layer.cpu(), tables,
                                       lengths, starts)
    with pytest.raises(ValueError, match="outside"):
        FP.paged_decode_attention_full(q, k, v, 3, tables, lengths, starts)
    with pytest.raises(ValueError, match="L, P, NH"):
        FP.paged_decode_attention_full(q, k[0], v[0], layer, tables, lengths,
                                       starts)
