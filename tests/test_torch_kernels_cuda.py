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


def _case(ps, quant, seed=0, B=6, pps=4):
    """Ragged lengths with a zero-length row and a page-boundary length;
    window starts that mask whole pages, or start and end inside a
    32-token chunk; one row with start > length; one row shorter than a
    chunk. Row 0 holds more 32-token chunks than a block has warps from
    ps 128 up."""
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
    lengths = np.array([cap, 0, ps, 1 + ps // 2, cap - 3, 21][:B], np.int32)
    starts = np.array([ps + 1, 0, 0, 0, cap - 2 * ps + 1, 3][:B], np.int32)
    starts[3] = lengths[3] + 1                    # start > length: masked
    return q, pool, tables, lengths, starts


PAGE_SIZES = [8, 16, 32, 96, 128, 256]   # every page size the engine uses


def _parts_call(cuda, kv, case, mq):
    """Run a parts kernel on ``case`` (numpy) on the card through its
    public wrapper (counted in LAUNCHES). Returns the outputs and the
    plain version's on the same tensors."""
    quant = kv.startswith("int8")
    q, pool, *idx = case
    a = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
         for x in (q, *pool, *idx)]
    if kv in ("int8-qbf16", "bfloat16-q"):
        a[0] = a[0].to(torch.bfloat16)
    if kv.startswith("bfloat16"):
        a[1], a[2] = a[1].to(torch.bfloat16), a[2].to(torch.bfloat16)
    name = ("paged_decode_attention" + ("_quant" if quant else "")
            + "_parts" + ("_mq" if mq else ""))
    before = T.LAUNCHES[name]
    got = getattr(T, name)(*a)
    torch.cuda.synchronize()
    assert T.LAUNCHES[name] == before + 1
    return got, getattr(T, name + "_ref")(*a)


def _check_parts(got, ref, masked_rows):
    """Tolerance 1e-4 abs + 1e-4 rel (f32 sums in another order); every
    output finite; a row with no live token gives (0, NEG_INF, 0)."""
    for g, r in zip(got, ref):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-4)
    acc, m, l = got
    for b in masked_rows:
        assert float(acc[b].abs().max()) == 0.0 and float(l[b].max()) == 0
        assert bool((m[b] == T.NEG_INF).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8", "int8-qbf16"])
@pytest.mark.parametrize("ps", PAGE_SIZES)
def test_kernel_matches_plain_on_the_card(cuda, kv, ps):  # noqa: F811
    """CUDA kernel vs plain version on the same tensors; bf16 pools are
    compared with the plain version over the same bf16 values (it upcasts
    to f32); "int8-qbf16" is the int8 pool under the bf16 q the headline
    engine sends. The zero-length row and the start > length row give
    zeros and NEG_INF."""
    case = _case(ps, kv.startswith("int8"), seed=11)
    got, ref = _parts_call(cuda, kv, case, False)
    _check_parts(got, ref, masked_rows=(1, 3))


def _refusals(fn, q, k, v, tables, lengths, starts):
    """What both parts kernels refuse: a page size that is not a multiple
    of the 4-token vector, a head size without an instance, a pool not
    aligned to the vector."""
    odd = torch.zeros(k.shape[0], NH, HS, 6, device=k.device)
    with pytest.raises(ValueError, match="page_size"):
        fn(q, odd, odd, tables, lengths, starts)
    with pytest.raises(ValueError, match="head_dim"):
        fn(q[..., :48].contiguous(), k[:, :, :48].contiguous(),
           v[:, :, :48].contiguous(), tables, lengths, starts)
    flat = torch.zeros(k.numel() + 1, device=k.device)
    shifted = flat[1:].view(k.shape)
    with pytest.raises(ValueError, match="aligned"):
        fn(q, shifted, shifted, tables, lengths, starts)


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
    _refusals(T.paged_decode_attention_parts, q, k, v, tables, lengths,
              starts)


def _mq_case(ps, KQ, quant, seed=0, B=6, pps=4):
    """The single-query case's pool, lengths and starts with KQ queries a
    row."""
    q1, pool, tables, lengths, starts = _case(ps, quant, seed, B, pps)
    rng = np.random.default_rng(seed + 1)
    q = rng.standard_normal((B, KQ, NH, HS)).astype(np.float32)
    return q, pool, tables, lengths, starts


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8", "int8-qbf16"])
@pytest.mark.parametrize("ps,KQ", [(8, 3), (32, 1), (128, 4), (32, 37),
                                   (128, 96), (16, 5), (96, 16), (256, 17),
                                   (8, 16), (128, 17)])
def test_mq_kernel_matches_plain_on_the_card(cuda, kv, ps, KQ):  # noqa: F811
    """Multi-query kernel vs its plain version: one query tile (KQ <= 4),
    a partial last tile (5, 17, 37), the 16/17 edge and KQ 96 (above the
    TPU kernel's 64), ragged, zero, windowed and start > length rows;
    bf16 pools and "int8-qbf16" (the int8 pool under the bf16 q of the
    headline's spec verify and suffix prefill) take bf16 q."""
    case = _mq_case(ps, KQ, kv.startswith("int8"), seed=5)
    got, ref = _parts_call(cuda, {"bfloat16": "bfloat16-q"}.get(kv, kv),
                           case, True)
    assert got[0].shape == (case[0].shape[0], KQ, NH, HS)
    _check_parts(got, ref, masked_rows=(1, 3))


@pytest.mark.cuda
def test_mq_kernel_rejects_what_it_does_not_take(cuda):  # noqa: F811
    """What the multi-query kernel refuses; a page of 1024 tokens runs
    (no page is staged in shared memory)."""
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
    _refusals(T.paged_decode_attention_parts_mq, q, k, v, tables, lengths,
              starts)
    big = torch.zeros(2, NH, HS, 1024, device=cuda)
    one = lambda x: torch.tensor([x], dtype=torch.int32, device=cuda)  # noqa: E731
    got = T.paged_decode_attention_parts_mq(q[:1], big, big, one(1)[None],
                                            one(1000), one(0))
    torch.cuda.synchronize()
    # ps 1024 runs: zero scores give p = 1 for each of the 1000 tokens
    assert bool((got[2] == 1000).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["int8", "float32"])
def test_parts_kernels_offsets_past_32_bits(cuda, kv):  # noqa: F811
    """Page offsets past 2^31: pools of more than 2^31 bytes (int8: 21,900
    pages of the 124M head shape; f32: 5,500) whose only non-zero pages
    are the last 12, named by the table; both parts kernels against their
    plain versions."""
    NH_, ps, B, pps = 12, 128, 4, 3
    P = 21900 if kv == "int8" else 5500
    g = torch.Generator(device=cuda).manual_seed(3)
    dt = torch.int8 if kv == "int8" else torch.float32
    k, v = (torch.zeros((P, NH_, HS, ps), dtype=dt, device=cuda)
            for _ in range(2))
    assert k.numel() * k.element_size() > 2 ** 31
    tail = (12, NH_, HS, ps)
    for t in (k, v):
        t[P - 12:] = (torch.randint(-127, 128, tail, generator=g, device=cuda,
                                    dtype=torch.int8) if kv == "int8"
                      else torch.randn(tail, generator=g, device=cuda))
    tables = (P - 1 - torch.arange(B * pps, device=cuda)).reshape(
        B, pps).to(torch.int32)
    lengths = torch.tensor([384, 300, 129, 5], dtype=torch.int32, device=cuda)
    starts = torch.tensor([0, 7, 0, 0], dtype=torch.int32, device=cuda)
    scales = []
    if kv == "int8":
        scales = [torch.zeros((P, NH_, ps), device=cuda) for _ in range(2)]
        for s in scales:
            s[P - 12:] = 1e-3 + 1e-2 * torch.rand((12, NH_, ps), generator=g,
                                                  device=cuda)
    quant = "_quant" if kv == "int8" else ""
    for KQ in (None, 4):
        shape = (B, NH_, HS) if KQ is None else (B, KQ, NH_, HS)
        q = torch.randn(shape, generator=g, device=cuda)
        name = f"paged_decode_attention{quant}_parts" + ("_mq" if KQ else "")
        args = (q, k, v, *scales, tables, lengths, starts)
        got = getattr(T, name)(*args)
        torch.cuda.synchronize()
        ref = getattr(T, name + "_ref")(*args)
        assert float(ref[2].min()) > 0
        for a, r in zip(got, ref):
            torch.testing.assert_close(a, r, atol=1e-4, rtol=1e-4)
        del got, ref
    del k, v, scales
    torch.cuda.empty_cache()


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


def _grid_call(cuda, case, kv, qd, shift=0):
    """Run the grid entry (paged_decode_attention[_quant]_grid, any page
    size) on ``case`` (numpy, from _grid_case) on the card; with
    ``shift``, K and V are views ``shift`` elements into their storage.
    Checks that one launch was counted; returns the output and the plain
    version's on the same tensors."""
    q, fpool, qpool, tables, lengths, starts = case
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    tq = torch.from_numpy(q).to(cuda).to(dt[qd])
    idx = [torch.from_numpy(a).to(cuda) for a in (tables, lengths, starts)]
    if kv == "int8":
        pool = [torch.from_numpy(a).to(cuda) for a in qpool]
        name = "paged_decode_attention_quant_grid"
    else:
        pool = [torch.from_numpy(a).to(cuda).to(dt[kv]) for a in fpool]
        name = "paged_decode_attention_grid"
    for i in (0, 1):
        if shift:
            t = pool[i]
            view = torch.empty(t.numel() + shift, dtype=t.dtype,
                               device=cuda)[shift:].view(t.shape)
            view.copy_(t)
            pool[i] = view
    before = T.LAUNCHES[name]
    got = getattr(T, name)(tq, *pool, *idx)
    torch.cuda.synchronize()
    assert T.LAUNCHES[name] == before + 1
    ref = getattr(T, name + "_ref")(tq, *pool, *idx)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert bool(torch.isfinite(got).all())
    return got, ref


def _check_grid(got, ref, qd):
    """An f32 output within 1e-5 abs + 1e-5 rel (f32 sums in another
    order); a bf16 output within one bf16 ulp (both compute in f32 and
    round once) plus 1e-6 (the f32 sums differ by ~1e-7 of the values
    they sum, more than a bf16 ulp of an output near 0)."""
    g, r = got.float(), ref.float()
    if qd == "bfloat16":
        ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(
            2.0 ** -126))) - 7)
        assert bool(((g - r).abs() <= ulp + 1e-6).all())
    else:
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("qd", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("ps", [6, 8, 16, 30, 32, 96, 128, 256])
def test_grid_kernel_matches_plain_on_the_card(cuda, ps, kv, qd):  # noqa: F811
    """The normalized grid kernel vs its plain version through the grid
    entries: the parts template's vector path at page sizes that are a
    multiple of 4 (128 and 256 too, which the normalized wrappers send to
    the parts kernel), the scalar path at 6 and 30 (_check_grid's
    tolerance). The zero-length and start >= length rows are exact
    zeros."""
    got, ref = _grid_call(cuda, _grid_case(ps, seed=ps), kv, qd)
    _check_grid(got, ref, qd)
    assert bool((got[1] == 0).all()) and bool((got[2] == 0).all())


def _grid_design_case(seed):
    """Rows for the template's design at ps 32: more chunks than warps
    (a 1024-token row, 11 live pages), a window start and a row end
    inside a 4-token group, start > length, negative starts below -ps
    and inside (-ps, 0)."""
    rng = np.random.default_rng(seed)
    B, ps, pps = 6, 32, 34
    P = B * pps + 3
    q = rng.standard_normal((B, NH, HS)).astype(np.float32)
    k, v = (rng.standard_normal((P, NH, HS, ps)).astype(np.float32)
            for _ in range(2))
    ks, vs = (rng.uniform(1e-3, 2e-2, (P, NH, ps)).astype(np.float32)
              for _ in range(2))
    kq, vq = (rng.integers(-127, 128, (P, NH, HS, ps)).astype(np.int8)
              for _ in range(2))
    tables = rng.permutation(P)[: B * pps].reshape(B, pps).astype(np.int32)
    lengths = np.array([1024, 330, 203, 40, 100, 7], np.int32)
    starts = np.array([0, 0, 37, 50, -40, -5], np.int32)
    return q, (k, v), (kq, vq, ks, vs), tables, lengths, starts


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("kv,qd", [("float32", "float32"),
                                   ("bfloat16", "bfloat16"),
                                   ("int8", "bfloat16"), ("int8", "float32")])
def test_grid_kernel_design_rows_on_the_card(cuda, kv, qd, shift):  # noqa: F811
    """_grid_design_case's rows against the plain version (_check_grid),
    on aligned pools (the template's vector path) and on views one
    element into their storage (the scalar path). The start > length row
    is exact zeros; a negative start gives exactly what start 0 gives."""
    case = _grid_design_case(seed=21)
    got, ref = _grid_call(cuda, case, kv, qd, shift)
    _check_grid(got, ref, qd)
    assert bool((got[3] == 0).all())
    q, fpool, qpool, tables, lengths, starts = case
    zero = (q, fpool, qpool, tables, lengths, np.maximum(starts, 0))
    got0, _ = _grid_call(cuda, zero, kv, qd, shift)
    assert torch.equal(got[4:], got0[4:])


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


def _int8_matmul_check(cuda, B, OC, IC, xd, x=None, modes=(True, False)):
    """int8_matmul vs int8_matmul_ref in the given compute modes, one
    launch each; x (B, IC) f32 numpy, or standard normal from a seed."""
    from llmc_paged_tpu_torch.ops import int8 as Q
    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.default_rng(B * 7 + OC + IC)
    if x is None:
        x = rng.standard_normal((B, IC)).astype(np.float32)
    x = torch.from_numpy(x)
    w = torch.from_numpy((0.05 * rng.standard_normal((OC, IC)))
                         .astype(np.float32))
    wq, s = Q.quantize_per_row(w)
    x, wq, s = x.to(cuda).to(getattr(torch, xd)), wq.to(cuda), s.to(cuda)
    for bf16 in modes:
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
@pytest.mark.parametrize("IC", [16, 64, 70, 768, 6400])
@pytest.mark.parametrize("OC", [1, 96, 2304])
@pytest.mark.parametrize("B", [1, 8, 9, 64, 256])
def test_int8_matmul_matches_plain_on_the_card(cuda, B, OC, IC, xd):  # noqa: F811
    """The int8 kernel vs its plain version in both compute modes, over
    the shapes its tile rules split on: IC 70 takes the scalar path (rows
    not 16-byte aligned), 16 and 64 one 64-column step (16 a partly
    empty one), 768 several, and 6400 (the 1.5B fcproj width) a split of
    IC over a block's warps; OC 1 and 96 leave a block's channels partly
    empty; B 1 a partly empty n8 tile, 8 a full one, 9, 64 and 256 the
    32-row prefill tiles (9 partly empty). Tolerance 1e-5 rel +
    1e-5·max|ref| abs: f32 sums in another order."""
    _int8_matmul_check(cuda, B, OC, IC, xd)


@pytest.mark.cuda
@pytest.mark.parametrize("xd", ["float32", "bfloat16"])
def test_int8_matmul_lm_head_on_the_card(cuda, xd):  # noqa: F811
    """The 124M lm_head shape (8, 51200, 768): the 32-channel decode
    tiles, at the same tolerance."""
    _int8_matmul_check(cuda, 8, 51200, 768, xd)


@pytest.mark.cuda
@pytest.mark.parametrize("IC,bf16", [(2048, False), (2432, False),
                                     (7168, True), (7232, True)])
def test_int8_matmul_decode_tile_rule_on_the_card(cuda, IC, bf16):  # noqa: F811
    """Decode rows at the least OC that takes 32-channel tiles (64 a
    streaming multiprocessor), on both sides of the 112 KB of staged x
    fragments: IC 2048 (fp32 mode) and 7168 (bf16 mode) stage x, 2432 and
    7232 do not and take the 16-channel tiles."""
    OC = 64 * torch.cuda.get_device_properties(0).multi_processor_count
    _int8_matmul_check(cuda, 8, OC, IC, "float32", modes=(bf16,))


@pytest.mark.cuda
@pytest.mark.parametrize("B,OC,IC", [(8, 2304, 768), (256, 3072, 768),
                                     (8, 1664, 6400)])
def test_int8_matmul_fp32_split_on_the_card(cuda, B, OC, IC):  # noqa: F811
    """The fp32 mode's three-term split on x that holds magnitudes from
    1e-30 to 1e30 in every row, beside values exact in bf16 (whose mid
    and lo terms are zero), against the f32 product at the same
    tolerance."""
    rng = np.random.default_rng(B + OC + IC)
    mag = 10.0 ** rng.uniform(-30, 30, (B, IC))
    x = (rng.choice([-1.0, 1.0], (B, IC)) * mag).astype(np.float32)
    exact = rng.random((B, IC)) < 0.5
    x[exact] = torch.from_numpy(rng.standard_normal(int(exact.sum()))
                                .astype(np.float32)).bfloat16().float().numpy()
    _int8_matmul_check(cuda, B, OC, IC, "float32", x=x, modes=(False,))


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


def _shifted(t, shift):
    """t's values in a view ``shift`` elements into its own storage."""
    view = torch.empty(t.numel() + shift, dtype=t.dtype,
                       device=t.device)[shift:].view(t.shape)
    view.copy_(t)
    return view


def _flatwide_call(cuda, kv, case, shift=0):
    """The flatwide parts kernel on ``case`` (numpy: q, pool, tables,
    lengths, starts) through its wrapper, one launch counted; with
    ``shift``, K and V are views ``shift`` elements into their storage.
    Tolerance 1e-4 abs + 1e-4 rel against the plain parts versions (f32
    sums in another order); returns the kernel's outputs."""
    from llmc_paged_tpu_torch.ops.dev import lab_flatwide as FW
    quant = kv.startswith("int8")
    q, pool, tables, lengths, starts = case
    a = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
         for x in (q, *pool, tables, lengths, starts)]
    if kv == "int8-qbf16":
        a[0] = a[0].to(torch.bfloat16)
    if kv == "bfloat16":
        a[1], a[2] = a[1].to(torch.bfloat16), a[2].to(torch.bfloat16)
    if shift:
        a[1], a[2] = _shifted(a[1], shift), _shifted(a[2], shift)
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
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-4)
    return got


def _softmax_case(case):
    """(B, V) inputs of the softmax cluster tests: 64 rows; 1, 7 and 33
    columns (most blocks of a 16-block cluster hold none); a masked vocab
    tail (-inf from column 50257 of 50304); bf16 at V = 50257 (rows of
    odd b start 2 bytes past a 16-byte boundary)."""
    B, V, dt = {"B64": (64, 50304, "float32"), "V1": (8, 1, "float32"),
                "V7": (8, 7, "float32"), "V33": (8, 33, "bfloat16"),
                "tail-inf": (8, 50304, "float32"),
                "bf16-50257": (7, 50257, "bfloat16")}[case]
    rng = np.random.default_rng(B * V)
    x = torch.from_numpy(4 * rng.standard_normal((B, V)).astype(np.float32))
    if case == "tail-inf":
        x[:, 50257:] = float("-inf")
    return x.to(getattr(torch, dt))


def _softmax_close(got, ref, x):
    assert got.dtype == x.dtype and got.shape == x.shape
    if x.dtype == torch.bfloat16:
        assert _within_bf16_ulp(got, ref)
    else:
        torch.testing.assert_close(got, ref, atol=1e-6, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [None, 1, 2, 4, 8, 16])
@pytest.mark.parametrize("case", ["B64", "V1", "V7", "V33", "tail-inf",
                                  "bf16-50257"])
def test_softmax_rows_cluster_sizes_on_the_card(cuda, case, cluster):  # noqa: F811
    """The cluster kernel at every cluster size the rule can pick (None:
    the rule's own pick), forced through the wrapper's private argument,
    vs the plain version (f32 within 1e-6 abs + 1e-5 rel, bf16 within one
    ulp). A masked tail gives exact zeros, as the plain version does."""
    from llmc_paged_tpu_torch.ops.dev import bench_softmax as SM
    x = _softmax_case(case).to(cuda)
    before = SM.LAUNCHES["softmax_rows"]
    got = SM.softmax_rows(x, _cluster=cluster)
    torch.cuda.synchronize()
    assert SM.LAUNCHES["softmax_rows"] == before + 1
    _softmax_close(got, SM.softmax_rows_ref(x), x)
    if case == "tail-inf":
        assert bool((got[:, 50257:] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 16])
@pytest.mark.parametrize("xd", ["float32", "bfloat16"])
def test_softmax_rows_unaligned_input_on_the_card(cuda, xd, cluster):  # noqa: F811
    """x a view one element into its storage (so x and out differ in
    alignment) takes the scalar instance; same tolerance."""
    from llmc_paged_tpu_torch.ops.dev import bench_softmax as SM
    rng = np.random.default_rng(3)
    x = torch.from_numpy(4 * rng.standard_normal((8, 1000)).astype(
        np.float32)).to(cuda).to(getattr(torch, xd))
    x = _shifted(x, 1)
    got = SM.softmax_rows(x, _cluster=cluster)
    torch.cuda.synchronize()
    _softmax_close(got, SM.softmax_rows_ref(x), x)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8", "int8-qbf16"])
@pytest.mark.parametrize("ps", [6, 8, 32, 128])
def test_flatwide_matches_plain_on_the_card(cuda, kv, ps):  # noqa: F811
    """The flatwide parts kernel vs the plain parts versions on the
    zero, ragged and windowed rows of ``_case`` (row 3: start > length):
    the vector kernel at page sizes that are a multiple of 4, the scalar
    kernel at 6. Tolerance as in _flatwide_call."""
    got = _flatwide_call(cuda, kv, _case(ps, kv.startswith("int8"),
                                         seed=17))
    assert float(got[2][1].abs().max()) == 0.0     # the zero-length row
    assert bool((got[1][3] == T.NEG_INF).all())    # start > length


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8", "int8-qbf16"])
def test_flatwide_unaligned_pool_on_the_card(cuda, kv):  # noqa: F811
    """K and V as views one element into their storage take the scalar
    kernel at ps 32, and give what the aligned pools give through the
    vector kernel (both within _flatwide_call's tolerance)."""
    case = _case(32, kv.startswith("int8"), seed=19)
    got = _flatwide_call(cuda, kv, case, shift=1)
    want = _flatwide_call(cuda, kv, case)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
    assert float(got[2][1].abs().max()) == 0.0
    assert bool((got[1][3] == T.NEG_INF).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["float32", "int8-qbf16"])
def test_flatwide_at_the_large_head_count_on_the_card(cuda, kv):  # noqa: F811
    """The 1.5B head count (NH = 25) at the lab's decode shape (B = 8,
    ps 128, 3 pages a row, lengths 1-384), one row windowed inside a
    4-token group and one past its length."""
    rng = np.random.default_rng(25)
    B, nh, ps, pps, P = 8, 25, 128, 3, 28
    q = rng.standard_normal((B, nh, HS)).astype(np.float32)
    if kv.startswith("int8"):
        pool = tuple(rng.integers(-127, 128, (P, nh, HS, ps)).astype(np.int8)
                     for _ in range(2))
        pool += tuple(rng.uniform(1e-3, 2e-2, (P, nh, ps)).astype(np.float32)
                      for _ in range(2))
    else:
        pool = tuple(rng.standard_normal((P, nh, HS, ps)).astype(np.float32)
                     for _ in range(2))
    tables = rng.permutation(P)[: B * pps].reshape(B, pps).astype(np.int32)
    lengths = rng.integers(1, pps * ps + 1, B).astype(np.int32)
    lengths[:2] = (300, 17)
    starts = np.array([131, 18, 0, 0, 0, 0, 0, 0], np.int32)
    got = _flatwide_call(cuda, kv, (q, pool, tables, lengths, starts))
    assert bool((got[1][1] == T.NEG_INF).all())


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
    with pytest.raises(ValueError, match="cluster size"):
        SM.softmax_rows(torch.zeros(1, 64, device=cuda), _cluster=3)
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
@pytest.mark.parametrize("ps", [8, 30, 32, 128])
def test_full_pool_kernel_matches_plain_on_the_card(cuda, ps, kv, qd):  # noqa: F811
    """The full-pool kernel vs its plain version on every plane, the
    layer as a (1,) int32 tensor on the card and as a host int. The
    zero-length and start >= length rows are exact zeros. ps 30 takes
    the scalar path, the others the parts template's plane instance."""
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
@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("ps", [30, 32])
def test_full_pool_kernel_clamps_entries_and_layers(cuda, ps, kv):  # noqa: F811
    """Live table entries of -1 and P read pages 0 and P - 1, a layer of
    -1 or L on the card reads plane 0 or L - 1, and a start below -ps
    reads from position 0, with no fault: the kernel's clamps against
    the plain version on the clamped indices, on both paths (ps 30
    scalar, ps 32 the plane instance)."""
    from llmc_paged_tpu_torch.ops.dev import lab_full_pool as FP
    q, fpool, qpool, tables, lengths, starts = _full_case(ps, seed=3)
    L, P = fpool[0].shape[:2]
    tables[0, 1], tables[4, 3] = -1, P       # live entries of rows 0 and 4
    starts[5] = -2 * ps - 1                  # row 5 (length 1) from 0
    tq = torch.from_numpy(q).to(cuda)
    idx = [torch.from_numpy(a).to(cuda) for a in (tables, lengths, starts)]
    if kv == "int8":
        pool = [torch.from_numpy(a).to(cuda) for a in qpool]
        fn, ref_fn = (FP.paged_decode_attention_quant_full,
                      FP.paged_decode_attention_quant_full_ref)
        tq = tq.bfloat16()
    else:
        pool = [torch.from_numpy(a).to(cuda) for a in fpool]
        fn, ref_fn = (FP.paged_decode_attention_full,
                      FP.paged_decode_attention_full_ref)
    for layer, plane in ((-1, 0), (L, L - 1), (1, 1)):
        got = fn(tq, *pool, torch.tensor([layer], dtype=torch.int32,
                                         device=cuda), *idx)
        torch.cuda.synchronize()
        ref = ref_fn(tq, *pool, plane, *idx)
        assert _full_close(got, ref), (layer, float(
            (got.float() - ref.float()).abs().max()))


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


# ---- the prefill's causal flash attention -----------------------------------

# (B, NH, T): chip_smoke.py's phase-14 shapes (124M and 1558M head counts,
# the long-context wave and the smallest T the prefill routes), and the
# kernel's smallest T
FLASH_SHAPES = [(1, 12, 256), (8, 12, 896), (8, 12, 1024), (8, 25, 896),
                (2, 25, 1024), (3, 1, 128)]
# the heads as the model hands them over: q, k and v cut from one
# (B, T, 3 NH 64) qkv buffer, at both head counts, T = 128 and 1024
FLASH_QKV_SHAPES = [(3, 12, 128), (2, 25, 128), (2, 12, 1024), (1, 25, 1024),
                    (8, 12, 896)]


def _flash_inputs(cuda, B, NH, T, qkv):
    """N(0, 1) bf16 q, k, v from a seed: contiguous (B, NH, T, 64), or the
    (B, NH, T, 64) views of one (B, T, 3 NH 64) buffer."""
    rng = np.random.default_rng(B * 1000 + NH * 10 + T + (7 if qkv else 0))
    if not qkv:
        return [torch.from_numpy(rng.standard_normal((B, NH, T, 64))
                                 .astype(np.float32)).to(cuda).bfloat16()
                for _ in range(3)]
    buf = torch.from_numpy(rng.standard_normal((B, T, 3 * NH * 64))
                           .astype(np.float32)).to(cuda).bfloat16()
    return [x.reshape(B, T, NH, 64).transpose(1, 2)
            for x in buf.split(NH * 64, dim=-1)]


def _flash_check(cuda, q, k, v):
    """causal_attention_flash against its plain version: |kernel - plain|
    <= 2^-7 |plain| + 2e-3 (one bf16 ulp, plus room for the kernel's other
    tile order, which rounds p to bf16 at other points), and within 2e-2
    of the f32 dense attention (the JAX kernel's docstring scale); one
    launch a call. Returns the kernel's output."""
    from llmc_paged_tpu_torch.ops import flash_attention as FA
    from llmc_paged_tpu_torch.ops.layers import causal_attention
    assert not torch.backends.cuda.matmul.allow_tf32
    before = FA.LAUNCHES["causal_attention_flash"]
    got = FA.causal_attention_flash(q, k, v)
    torch.cuda.synchronize()
    assert FA.LAUNCHES["causal_attention_flash"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    ref = FA.causal_attention_flash_ref(q, k, v).float()
    d = (got.float() - ref).abs()
    assert bool((d <= 2.0 ** -7 * ref.abs() + 2e-3).all()), float(d.max())
    dense = causal_attention(q.float(), k.float(), v.float())
    assert float((got.float() - dense).abs().max()) <= 2e-2
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("B,NH,T", FLASH_SHAPES)
def test_flash_attention_matches_plain_on_the_card(cuda, B, NH, T):  # noqa: F811
    """causal_attention_flash against its plain version on contiguous
    N(0, 1) bf16 inputs (tolerances of _flash_check)."""
    _flash_check(cuda, *_flash_inputs(cuda, B, NH, T, qkv=False))


@pytest.mark.cuda
@pytest.mark.parametrize("B,NH,T", FLASH_QKV_SHAPES)
def test_flash_attention_reads_qkv_views_on_the_card(cuda, B, NH, T):  # noqa: F811
    """The kernel on the head views of one qkv buffer, uncopied (same
    tolerances); its output is the (B, NH, T, 64) view of a (B, T, NH, 64)
    tensor, so the callers' transpose(1, 2).reshape(B, T, C) shares its
    storage."""
    q, k, v = _flash_inputs(cuda, B, NH, T, qkv=True)
    assert not q.is_contiguous()
    got = _flash_check(cuda, q, k, v)
    flat = got.transpose(1, 2).reshape(B, T, NH * 64)
    assert flat.data_ptr() == got.data_ptr()
    assert (flat.untyped_storage().data_ptr()
            == got.untyped_storage().data_ptr())
    assert flat.is_contiguous()


@pytest.mark.cuda
def test_flash_attention_rejects_what_it_does_not_take(cuda):  # noqa: F811
    """Each refusal raises before any launch: dtype, head size, T, a last
    dim that is not contiguous, a stride that is not a multiple of 8
    elements, shapes that differ, another device, an unaligned base (also
    of a strided view)."""
    from llmc_paged_tpu_torch.ops import flash_attention as FA
    shape = (2, 3, 256, 64)
    q = torch.randn(shape, device=cuda).bfloat16()
    before = FA.LAUNCHES["causal_attention_flash"]
    with pytest.raises(TypeError):
        FA.causal_attention_flash(q.float(), q.float(), q.float())
    wide = torch.randn((2, 3, 256, 128), device=cuda).bfloat16()
    with pytest.raises(ValueError, match="head size"):
        FA.causal_attention_flash(wide, wide, wide)
    odd = torch.randn((2, 3, 400, 64), device=cuda).bfloat16()
    with pytest.raises(ValueError, match="multiple of 128"):
        FA.causal_attention_flash(odd, odd, odd)
    with pytest.raises(ValueError, match="contiguous"):
        FA.causal_attention_flash(q, q.transpose(2, 3).contiguous()
                                  .transpose(2, 3), q)
    with pytest.raises(ValueError, match="contiguous"):
        FA.causal_attention_flash(q, wide[..., ::2], q)
    ragged = torch.randn((2, 3, 256, 68), device=cuda).bfloat16()[..., :64]
    with pytest.raises(ValueError, match="multiple of 8"):
        FA.causal_attention_flash(q, ragged, q)
    with pytest.raises(ValueError, match="shape"):
        FA.causal_attention_flash(q, q[:1].contiguous(), q)
    with pytest.raises(ValueError, match="is on"):
        FA.causal_attention_flash(q, q.cpu(), q)
    flat = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device=cuda)
    shifted = flat[1:].view(shape)              # contiguous, 2 bytes off
    with pytest.raises(ValueError, match="16-byte aligned"):
        FA.causal_attention_flash(q, shifted, q)
    buf = torch.randn((2, 256, 3 * 64 + 8), device=cuda).bfloat16()
    off = buf[..., 4:4 + 3 * 64].reshape(2, 256, 3, 64).transpose(1, 2)
    with pytest.raises(ValueError, match="16-byte aligned"):  # 8 bytes off
        FA.causal_attention_flash(q, off, q)
    assert FA.LAUNCHES["causal_attention_flash"] == before
