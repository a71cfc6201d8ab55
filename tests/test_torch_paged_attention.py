"""ops/paged_attention.py of the port.

On the CPU: the plain parts (float and int8 pools) against the JAX
package's paged_decode_attention[_quant]_parts_xla at atol 1e-5, over
ragged and zero lengths, window starts and fully masked pages, ps in
{8, 32, 128}; one tiny ps=128 case against the JAX flat Pallas kernel in
interpret mode. The same for the multi-query parts (KQ queries a row,
against paged_decode_attention[_quant]_parts_mq_xla and the JAX flat mq
kernel in interpret mode). The normalized grid entries (the kernel of
the normalized wrappers at page sizes that are not a multiple of 128)
against the JAX package's grid Pallas kernels in interpret mode. The
CUDA kernels against the plain versions are in test_torch_kernels_cuda.py
(they run on the card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_paged_tpu.ops import paged_attention as J
from llmc_paged_tpu_torch.ops import paged_attention as T

NH, HS = 2, 64
ATOL = 1e-5


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
    lengths = np.array([cap, 0, ps, 1 + ps // 2, cap - 3][:B], np.int32)
    starts = np.array([ps + 1, 0, 0, 0, cap - 2 * ps + 1][:B], np.int32)
    if B > 3:
        starts[3] = lengths[3] + 1                # start > length: masked
    return q, pool, tables, lengths, starts


def _jax_parts(q, pool, tables, lengths, starts):
    a = [jnp.asarray(x) for x in (q, *pool, tables, lengths, starts)]
    fn = (J.paged_decode_attention_quant_parts_xla if len(pool) == 4
          else J.paged_decode_attention_parts_xla)
    return [np.asarray(o) for o in fn(*a)]


def _port_parts(q, pool, tables, lengths, starts, device="cpu", plain=False):
    a = [torch.from_numpy(np.ascontiguousarray(x)).to(device)
         for x in (q, *pool, tables, lengths, starts)]
    if len(pool) == 4:
        fn = (T.paged_decode_attention_quant_parts_ref if plain
              else T.paged_decode_attention_quant_parts)
    else:
        fn = (T.paged_decode_attention_parts_ref if plain
              else T.paged_decode_attention_parts)
    return fn(*a)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("ps", [8, 16, 32, 96, 128, 256])
def test_parts_plain_matches_jax(ps, quant):
    case = _case(ps, quant, seed=ps)
    ref = _jax_parts(*case)
    got = [t.numpy() for t in _port_parts(*case)]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, atol=ATOL, rtol=1e-6)
    acc, m, l = got
    assert np.all(m[1] == T.NEG_INF) and np.all(l[1] == 0)   # length 0
    assert np.all(acc[1] == 0)
    assert np.all(m[3] == T.NEG_INF) and np.all(l[3] == 0)   # masked row


@pytest.mark.parametrize("quant", [False, True])
def test_normalized_wrappers(quant):
    """paged_decode_attention[_quant] == acc / l (l == 0 → 1), equal to
    the JAX package's normalized XLA path; the *_ref route (the engine's
    use_kernel=False) too."""
    q, pool, tables, lengths, starts = _case(32, quant, seed=7)
    case = (q, *pool, tables, lengths, starts)
    a = [jnp.asarray(x) for x in case]
    jfn = (J.paged_decode_attention_quant_xla if quant
           else J.paged_decode_attention_xla)
    ref = np.asarray(jfn(*a))
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in case]
    for fn in ((T.paged_decode_attention_quant,
                T.paged_decode_attention_quant_ref) if quant else
               (T.paged_decode_attention, T.paged_decode_attention_ref)):
        np.testing.assert_allclose(fn(*t).numpy(), ref, atol=ATOL, rtol=1e-6)


def test_parts_plain_matches_jax_flat_kernel_interpret():
    """One tiny ps=128 case against the JAX flat Pallas kernel run in
    interpret mode (slow, hence one case)."""
    case = _case(128, False, seed=3, B=2, pps=2)
    q, pool, tables, lengths, starts = case
    lengths = np.array([200, 0], np.int32)
    starts = np.array([100, 0], np.int32)
    a = [jnp.asarray(x) for x in (q, *pool, tables, lengths, starts)]
    ref = J.paged_decode_attention_parts(*a, interpret=True)
    got = _port_parts(q, pool, tables, lengths, starts)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL,
                                   rtol=1e-6)


def test_cpu_route_counts_no_launch():
    T.LAUNCHES["paged_decode_attention_parts"] = 0
    _port_parts(*_case(8, False))
    assert T.LAUNCHES["paged_decode_attention_parts"] == 0


def _mq_case(ps, KQ, quant, seed):
    q1, pool, tables, lengths, starts = _case(ps, quant, seed=seed)
    q = np.random.default_rng(seed + 1).standard_normal(
        (q1.shape[0], KQ, NH, HS)).astype(np.float32)
    return q, pool, tables, lengths, starts


def _jax_parts_mq(q, pool, tables, lengths, starts):
    a = [jnp.asarray(x) for x in (q, *pool, tables, lengths, starts)]
    fn = (J.paged_decode_attention_quant_parts_mq_xla if len(pool) == 4
          else J.paged_decode_attention_parts_mq_xla)
    return [np.asarray(o) for o in fn(*a)]


def _port_parts_mq(q, pool, tables, lengths, starts):
    a = [torch.from_numpy(np.ascontiguousarray(x))
         for x in (q, *pool, tables, lengths, starts)]
    fn = (T.paged_decode_attention_quant_parts_mq if len(pool) == 4
          else T.paged_decode_attention_parts_mq)
    return [t.numpy() for t in fn(*a)]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("KQ", [1, 3, 4, 5, 16, 17])
@pytest.mark.parametrize("ps", [8, 32, 128])
def test_parts_mq_plain_matches_jax(ps, KQ, quant):
    """Ragged, zero-length, windowed and fully masked rows; every query
    of a row attends the same range."""
    case = _mq_case(ps, KQ, quant, seed=ps + KQ)
    ref = _jax_parts_mq(*case)
    got = _port_parts_mq(*case)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, atol=ATOL, rtol=1e-6)
    acc, m, l = got
    assert acc.shape == (5, KQ, NH, HS) and m.shape == (5, KQ, NH)
    assert np.all(m[1] == T.NEG_INF) and np.all(l[1] == 0)   # length 0
    assert np.all(m[3] == T.NEG_INF) and np.all(acc[3] == 0)  # masked row


def test_parts_mq_plain_is_single_query_per_query():
    """Each query of the multi-query parts equals the single-query parts
    of that query alone (the pool part has no causal structure)."""
    q, pool, tables, lengths, starts = _mq_case(32, 3, True, seed=2)
    got = _port_parts_mq(q, pool, tables, lengths, starts)
    for j in range(3):
        one = _port_parts(q[:, j], pool, tables, lengths, starts)
        for g, o in zip(got, one):
            np.testing.assert_allclose(g[:, j], o.numpy(), atol=ATOL,
                                       rtol=1e-6)


def test_parts_mq_plain_matches_jax_mq_kernel_interpret():
    """One tiny ps=128 case against the JAX flat multi-query Pallas kernel
    run in interpret mode (slow, hence one case)."""
    q, pool, tables, lengths, starts = _mq_case(128, 3, False, seed=4)
    q, tables = q[:2], tables[:2]
    lengths = np.array([200, 0], np.int32)
    starts = np.array([100, 0], np.int32)
    a = [jnp.asarray(x) for x in (q, *pool, tables, lengths, starts)]
    ref = J.paged_decode_attention_parts_mq(*a, interpret=True)
    got = _port_parts_mq(q, pool, tables, lengths, starts)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(r), atol=ATOL, rtol=1e-6)


@pytest.mark.parametrize("mq", [False, True])
def test_parts_launch_refuses_what_the_kernels_do_not_take(mq):
    """The parts kernels' launch path raises before any build on what
    the kernels do not take: a page size that is not a multiple of their
    4-token vector loads, a head size with no instance, a pool not aligned
    to the vector. Nothing is launched or counted."""
    q, pool, tables, lengths, starts = (_mq_case(8, 4, False, seed=0) if mq
                                        else _case(8, False))
    q, k, v, tables, lengths, starts = (
        torch.from_numpy(np.ascontiguousarray(x))
        for x in (q, *pool, tables, lengths, starts))
    name = "paged_decode_attention_parts" + ("_mq" if mq else "")
    before = T.LAUNCHES[name]

    def launch(q_, k_, v_):
        return T._launch(name, mq, q_, k_, v_, None, tables, lengths, starts)

    odd = torch.zeros(k.shape[0], NH, HS, 6)
    with pytest.raises(ValueError, match="page_size 6"):
        launch(q, odd, odd)
    with pytest.raises(ValueError, match="head_dim 48"):
        launch(q[..., :48].contiguous(), k[:, :, :48].contiguous(),
               v[:, :, :48].contiguous())
    shifted = torch.zeros(k.numel() + 1)[1:].view(k.shape)
    with pytest.raises(ValueError, match="aligned"):
        launch(q, shifted, shifted)
    assert T.LAUNCHES[name] == before


def test_cpu_route_counts_no_mq_launch():
    for k in ("paged_decode_attention_parts_mq",
              "paged_decode_attention_quant_parts_mq"):
        T.LAUNCHES[k] = 0
    _port_parts_mq(*_mq_case(8, 2, False, seed=0))
    _port_parts_mq(*_mq_case(8, 2, True, seed=0))
    assert T.LAUNCHES["paged_decode_attention_parts_mq"] == 0
    assert T.LAUNCHES["paged_decode_attention_quant_parts_mq"] == 0


# ---- the normalized grid entries --------------------------------------------

def _grid_case(ps, seed):
    """Ragged lengths, a zero-length row, window starts masking whole
    pages, and a start >= length row (length 5, start 7: the JAX
    package's fully-masked-page case)."""
    rng = np.random.default_rng(seed)
    B, pps = 5, 4
    P = B * pps + 3
    q = rng.standard_normal((B, NH, HS)).astype(np.float32)
    k, v = (rng.standard_normal((P, NH, HS, ps)).astype(np.float32)
            for _ in range(2))
    tables = rng.permutation(P)[: B * pps].reshape(B, pps).astype(np.int32)
    cap = ps * pps
    lengths = np.array([cap, 0, ps + 3, 5, cap - 3], np.int32)
    starts = np.array([ps + 1, 0, 0, 7, cap - 2 * ps + 1], np.int32)
    return q, k, v, tables, lengths, starts


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    ax = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(ax)) - 7)


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("qd", ["float32", "bfloat16"])
@pytest.mark.parametrize("ps", [6, 8, 16, 30, 32, 96])
def test_grid_plain_matches_jax_grid_kernel_interpret(ps, qd, kv):
    """The port's CPU route of paged_decode_attention[_quant]_grid (and of
    the normalized wrappers, which route there at ps % 128 != 0) against
    the JAX grid Pallas kernels run in interpret mode on the same values.
    Tolerances: an f32 q within 1e-5 (f32 sums in another order); a bf16
    q within one bf16 ulp of the output (both compute in f32 and round
    once to bf16). Masked rows give exact zeros."""
    from llmc_paged_tpu.kv.layouts import quantize_pages
    q, k, v, tables, lengths, starts = _grid_case(ps, seed=ps)
    jdt = jnp.bfloat16 if qd == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if qd == "bfloat16" else torch.float32
    jq = jnp.asarray(q).astype(jdt)
    tq = torch.from_numpy(np.array(jq.astype(jnp.float32))).to(tdt)
    jidx = [jnp.asarray(a) for a in (tables, lengths, starts)]
    tidx = [torch.from_numpy(a) for a in (tables, lengths, starts)]
    if kv == "int8":
        kq, ks = quantize_pages(jnp.asarray(k))
        vq, vs = quantize_pages(jnp.asarray(v))
        jpool = (kq, vq, ks, vs)
        ref = J.paged_decode_attention_quant_grid(jq, *jpool, *jidx,
                                                  interpret=True)
        tpool = [torch.from_numpy(np.array(a)) for a in jpool]
        outs = [T.paged_decode_attention_quant_grid(tq, *tpool, *tidx),
                T.paged_decode_attention_quant(tq, *tpool, *tidx)]
    else:
        pdt = jnp.bfloat16 if kv == "bfloat16" else jnp.float32
        jpool = (jnp.asarray(k).astype(pdt), jnp.asarray(v).astype(pdt))
        ref = J.paged_decode_attention_grid(jq, *jpool, *jidx,
                                            interpret=True)
        tpool = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16 if kv == "bfloat16" else torch.float32)
            for a in jpool]
        outs = [T.paged_decode_attention_grid(tq, *tpool, *tidx),
                T.paged_decode_attention(tq, *tpool, *tidx)]
    r = np.asarray(ref.astype(jnp.float32))
    for got in outs:
        assert got.dtype == tdt and tuple(got.shape) == r.shape
        g = got.float().numpy()
        if qd == "bfloat16":
            assert np.all(np.abs(g - r) <= _bf16_ulp(r))
        else:
            np.testing.assert_allclose(g, r, atol=ATOL, rtol=0)
        assert np.all(g[1] == 0) and np.all(g[3] == 0)   # empty, masked


def test_grid_launch_refuses_what_the_kernel_does_not_take():
    """The grid kernel's launch path raises before any build on a head
    size it has no instance for; nothing is launched or counted. Every
    page size and alignment is taken (the scalar path covers the rest)."""
    q, k, v, tables, lengths, starts = (
        torch.from_numpy(x) for x in _grid_case(8, seed=0))
    name = "paged_decode_attention_grid"
    before = T.LAUNCHES[name]
    with pytest.raises(ValueError, match="head_dim 48"):
        T._launch_grid(name, q[..., :48].contiguous(),
                       k[:, :, :48].contiguous(), v[:, :, :48].contiguous(),
                       None, tables, lengths, starts)
    assert T.LAUNCHES[name] == before


@pytest.mark.parametrize("ps", [32, 128])
def test_normalized_wrappers_route_by_page_size(ps):
    """ps % 128 != 0 → the grid entry; ps % 128 == 0 → parts / l, as in
    the JAX package. On the CPU neither counts a launch."""
    q, pool, tables, lengths, starts = _case(ps, False, seed=9)
    t = [torch.from_numpy(np.ascontiguousarray(x))
         for x in (q, *pool, tables, lengths, starts)]
    for key in T.LAUNCHES:
        T.LAUNCHES[key] = 0
    calls = []
    orig_grid, orig_parts = (T.paged_decode_attention_grid,
                             T.paged_decode_attention_parts)
    T.paged_decode_attention_grid = (
        lambda *a, **k: calls.append("grid") or orig_grid(*a, **k))
    T.paged_decode_attention_parts = (
        lambda *a, **k: calls.append("parts") or orig_parts(*a, **k))
    try:
        out = T.paged_decode_attention(*t)
    finally:
        T.paged_decode_attention_grid = orig_grid
        T.paged_decode_attention_parts = orig_parts
    assert calls == (["grid"] if ps % 128 else ["parts"])
    np.testing.assert_allclose(out.numpy(),
                               T.paged_decode_attention_ref(*t).numpy(),
                               atol=ATOL, rtol=0)
    assert all(v == 0 for v in T.LAUNCHES.values())
