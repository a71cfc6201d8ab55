"""The port's stacked-pool ("full-pool") lab, llmc_paged_tpu_torch/ops/dev/
lab_full_pool.py, against the JAX package's on the CPU: the same numpy
inputs through the JAX Pallas full-pool kernels in interpret mode (as the
JAX package's own tests run them), its ``_xla`` oracles and writes, and
the port's wrappers, whose CPU route is the plain version of
``csrc/lab_full_pool.cu``. Then the lab's entry point with ``--device
cpu``. The CUDA kernel against its plain version is in
test_torch_kernels_cuda.py (on the card)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_paged_tpu.kv.layouts import PagePool, QuantPagePool
from llmc_paged_tpu.kv.layouts import quantize_pages as j_quantize_pages
from llmc_paged_tpu.ops.dev import lab_full_pool as J
from llmc_paged_tpu_torch.ops.dev import lab_full_pool as T

# the shapes of tests/test_paged_attention.py's full-pool tests, plus a
# third row whose start is past its length
LK, B, NH, HS, P, PS, PPS = 3, 3, 4, 64, 12, 8, 4
LENGTHS = np.array([29, 7, 5], np.int32)
STARTS = np.array([4, 0, 7], np.int32)


def _bf16_ulp(ref):
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126)))
                   - 7)


def _case(quant):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, NH, HS), dtype=np.float32)
    pool = [rng.standard_normal((LK, P, NH, HS, PS), dtype=np.float32)
            for _ in range(2)]
    if quant:
        (kq, ks), (vq, vs) = (j_quantize_pages(jnp.asarray(a)) for a in pool)
        pool = [np.asarray(a) for a in (kq, vq, ks, vs)]
    tables = rng.permutation(P)[: B * PPS].reshape(B, PPS).astype(np.int32)
    return q, pool, tables


@pytest.mark.parametrize("qd", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", [False, True])
def test_full_pool_plain_matches_the_jax_kernel(quant, qd):
    """On every layer: the port's plain full-pool route against the JAX
    Pallas full-pool kernel in interpret mode (f32 q within 1e-6 abs; bf16
    q within one bf16 ulp: both compute in f32 and round once) and against
    the JAX ``_xla`` oracle (2e-5, as the JAX test holds its kernel; the
    oracle computes a bf16 q's scores in bf16 before promoting). The row
    with start >= length gives zeros, as the oracle does; the JAX Pallas
    kernel has no guard there (exp(NEG_INF - NEG_INF) = 1 sums the
    masked page), so that row is held to the oracle only."""
    q, pool, tables = _case(quant)
    jd, td = getattr(jnp, qd), getattr(torch, qd)
    jq = jnp.asarray(q, jd)
    jpool = [jnp.asarray(a) for a in pool]
    idx = [jnp.asarray(a) for a in (tables, LENGTHS, STARTS)]
    tpool = T.pool_from_numpy(*pool, device="cpu")
    tidx = [torch.from_numpy(a) for a in (tables, LENGTHS, STARTS)]
    kern = J.paged_decode_attention_quant_full if quant \
        else J.paged_decode_attention_full
    oracle = J.paged_decode_attention_quant_full_xla if quant \
        else J.paged_decode_attention_full_xla
    port = T.paged_decode_attention_quant_full if quant \
        else T.paged_decode_attention_full
    port_xla = T.paged_decode_attention_quant_full_xla if quant \
        else T.paged_decode_attention_full_xla
    inside = STARTS < LENGTHS
    for layer in range(LK):
        ref = np.asarray(kern(jq, *jpool, jnp.int32(layer), *idx,
                              interpret=True).astype(jnp.float32))
        ora = np.asarray(oracle(jq, *jpool, layer, *idx).astype(jnp.float32))
        for lay in (layer, torch.tensor([layer], dtype=torch.int32)):
            got = port(torch.from_numpy(q).to(td), *tpool, lay, *tidx)
            assert got.dtype == td and got.shape == (B, NH, HS)
            g = got.float().numpy()
            if qd == "float32":
                np.testing.assert_allclose(g[inside], ref[inside], atol=1e-6,
                                           rtol=0)
            else:
                assert np.all(np.abs(g[inside] - ref[inside])
                              <= _bf16_ulp(ref[inside]))
            np.testing.assert_allclose(g, ora, atol=2e-5 if qd == "float32"
                                       else 1e-2, rtol=0)
            assert not g[~inside].any()
        # the port's copy of the oracle equals the JAX oracle
        tx = port_xla(torch.from_numpy(q).to(td), *tpool, layer, *tidx)
        np.testing.assert_allclose(tx.float().numpy(), ora, atol=2e-5 if
                                   qd == "float32" else 1e-2, rtol=0)


@pytest.mark.parametrize("as_tensor", [False, True],
                         ids=["int-layer", "tensor-layer"])
@pytest.mark.parametrize("quant", [False, True])
def test_write_kv_full_matches_the_jax_writes(quant, as_tensor):
    """write_kv_full[_quant] into each plane is bit-equal to the JAX
    writes (a row whose page is P is dropped); the other planes are
    untouched; the layer as a Python int or a (1,) int32 tensor."""
    rng = np.random.default_rng(9)
    Lk, NH_, P_, ps, HS_, N = 3, 2, 6, 4, 8, 5
    k0, v0 = (rng.standard_normal((Lk, P_, NH_, HS_, ps), dtype=np.float32)
              for _ in range(2))
    k_new, v_new = (rng.standard_normal((N, NH_, HS_), dtype=np.float32)
                    for _ in range(2))
    page = np.array([0, 0, 3, 5, P_], np.int32)      # last row: dropped
    slot = np.array([0, 1, 2, 3, 0], np.int32)
    if quant:
        (kq, ks), (vq, vs) = (j_quantize_pages(jnp.asarray(a))
                              for a in (k0, v0))
        start = [np.asarray(a) for a in (kq, vq, ks, vs)]
    else:
        start = [k0, v0]
    for layer in range(Lk):
        jargs = (jnp.int32(layer), jnp.asarray(k_new), jnp.asarray(v_new),
                 jnp.asarray(page), jnp.asarray(slot))
        if quant:
            want = J.write_kv_quant_full(
                QuantPagePool(*(jnp.asarray(a) for a in start)), *jargs)
        else:
            want = J.write_kv_full(PagePool(*(jnp.asarray(a) for a in start)),
                                   *jargs)
        pool = T.pool_from_numpy(*start, device="cpu")
        lay = torch.tensor([layer], dtype=torch.int32) if as_tensor else layer
        write = T.write_kv_quant_full if quant else T.write_kv_full
        got = write(*pool, lay, torch.from_numpy(k_new),
                    torch.from_numpy(v_new), torch.from_numpy(page),
                    torch.from_numpy(slot))
        assert all(g is p for g, p in zip(got, pool))       # in place
        for g, w, s in zip(got, want, start):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            others = [i for i in range(Lk) if i != layer]
            np.testing.assert_array_equal(g.numpy()[others], s[others])


def test_pool_from_numpy_rejects_a_misshapen_pool():
    k = np.zeros((2, 3, 4, 8, 16), np.float32)
    with pytest.raises(ValueError, match="L, P, NH"):
        T.pool_from_numpy(k, k[:1], device="cpu")
    with pytest.raises(ValueError, match="L, P, NH"):
        T.pool_from_numpy(k, k, np.zeros((2, 3, 4, 8), np.float32),
                          np.zeros((2, 3, 4, 8), np.float32), device="cpu")
    assert [t.shape for t in T.pool_from_numpy(
        k, k, np.zeros((2, 3, 4, 16), np.float32),
        np.zeros((2, 3, 4, 16), np.float32), device="cpu")] == [
        (2, 3, 4, 8, 16)] * 2 + [(2, 3, 4, 16)] * 2


def test_full_pool_entry_point_on_the_cpu(monkeypatch, capsys):
    """main() with --device cpu at small configurations (at ps 32 B*pps >
    P: rows share pages), 2 timed calls a run: both versions
    validate OK against the plain version, and the harness counts each
    version's calls (3 warm-up, 3 runs of 2, one more to validate)."""
    configs = [(3, 2, 64, 3, 12, 8, 4, "f32"),
               (3, 2, 64, 2, 8, 32, 4, "int8")]
    monkeypatch.setattr(T, "CONFIGS", configs)
    records = T.main(["--device", "cpu", "--iters", "2"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("[validate]")]
    assert len(lines) == 4 and all(ln.endswith(" OK") for ln in lines), out
    assert len(records) == len(configs) * len(T.VERSIONS)
    for r in records:
        assert r["calls"] == 3 + 3 * 2 + r["validated"]
        assert r["validated"] == (r["name"] != "v0_gather_ref (naive)")
    q, k, v, scales, layer, layer_t, tables, lengths, starts = T.make_args(
        *configs[1], device="cpu")
    assert layer == 1 and layer_t.tolist() == [1] and q.dtype == torch.bfloat16
    assert k.shape == (2, 8, 2, 64, 32) and scales[0].shape == (2, 8, 2, 32)
