"""The port's kernel lab (llmc_paged_tpu_torch/ops/dev and ops/int8's
int8_matmul) against the JAX package, on the CPU: the same numpy inputs
through the JAX Pallas kernels in interpret mode (as the JAX package's own
tests run them) and the port's wrappers, whose CPU route is the plain
version of each CUDA kernel. Then every lab entry point on the CPU
(``--device cpu``) at one small configuration. The CUDA kernels against
their plain versions are in test_torch_kernels_cuda.py (on the card)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_paged_tpu.kv.layouts import quantize_pages as j_quantize_pages
from llmc_paged_tpu.kv.layouts import quantize_rows as j_quantize_rows
from llmc_paged_tpu.ops import int8 as J8
from llmc_paged_tpu.ops import layers as JL
from llmc_paged_tpu.ops.dev.bench_layernorm import pallas_layernorm
from llmc_paged_tpu.ops.dev.bench_softmax import pallas_softmax_rows
from llmc_paged_tpu.ops.dev.lab_flatwide import _flatwide_parts_call
from llmc_paged_tpu_torch.ops import int8 as T8
from llmc_paged_tpu_torch.ops import layers as TL
from llmc_paged_tpu_torch.ops.dev import (
    bench_fusion,
    bench_int8_matmul,
    bench_layernorm,
    bench_matmul,
    bench_paged_attention,
    bench_softmax,
    lab_flatwide,
)

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _within_bf16_ulp(got, ref):
    """Every element within one bf16 ulp of |ref| (both compute in f32
    and round once) plus 1e-6 for outputs near 0."""
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126)))
                  - 7)
    return bool(np.all(np.abs(got - ref) <= ulp + 1e-6))


@pytest.mark.parametrize("bf16_compute", [True, False])
@pytest.mark.parametrize("B,OC,IC", [(8, 96, 64), (5, 256, 128),
                                     (16, 130, 70)])
def test_int8_matmul_matches_the_jax_kernel(B, OC, IC, bf16_compute):
    """int8_matmul (plain route) against the JAX Pallas kernel in
    interpret mode; 1e-5 rel + 1e-5·max|ref| abs: the f32 sums run in
    another order."""
    rng = np.random.default_rng(B + OC + IC)
    x = rng.standard_normal((B, IC)).astype(np.float32)
    w = (0.05 * rng.standard_normal((OC, IC))).astype(np.float32)
    wq, s = j_quantize_rows(jnp.asarray(w))
    ref = np.asarray(J8.int8_matmul(jnp.asarray(x), wq, s, interpret=True,
                                    bf16_compute=bf16_compute))
    got = T8.int8_matmul(torch.from_numpy(x), _t(wq), _t(s),
                         bf16_compute=bf16_compute)
    assert got.dtype == torch.float32 and got.shape == (B, OC)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    # the validation reference, int8_linear_xla's counterpart, agrees too
    lin = np.asarray(J8.int8_linear_xla(jnp.asarray(x), wq, s))
    np.testing.assert_allclose(
        T8.int8_linear_ref(torch.from_numpy(x), _t(wq), _t(s)).numpy(), lin,
        rtol=1e-5, atol=1e-5 * np.abs(lin).max())
    np.testing.assert_array_equal(T8.dequantize(_t(wq), _t(s)).numpy(),
                                  np.asarray(J8.dequantize(wq, s)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,C", [(16, 64), (8, 768)])
def test_layernorm_rows_matches_the_jax_kernel(R, C, dtype):
    """layernorm_rows (plain route) against pallas_layernorm in interpret
    mode: f32 within 1e-5, bf16 within one ulp."""
    rng = np.random.default_rng(R * C)
    x = rng.standard_normal((R, C)).astype(np.float32)
    w, b = (rng.standard_normal(C).astype(np.float32) for _ in range(2))
    jd, td = DT[dtype]
    ref = np.asarray(pallas_layernorm(jnp.asarray(x, jd), jnp.asarray(w),
                                      jnp.asarray(b), block_rows=8,
                                      interpret=True)).astype(np.float32)
    got = bench_layernorm.layernorm_rows(torch.from_numpy(x).to(td),
                                         torch.from_numpy(w),
                                         torch.from_numpy(b))
    assert got.dtype == td
    got = got.float().numpy()
    if dtype == "bfloat16":
        assert _within_bf16_ulp(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,V", [(8, 1000), (8, 50304)])
def test_softmax_rows_matches_the_jax_kernel(B, V):
    """softmax_rows (plain route: max, exp, sum) against
    pallas_softmax_rows in interpret mode: 1e-6 abs, 1e-5 rel."""
    x = (4 * np.random.default_rng(V).standard_normal((B, V))
         ).astype(np.float32)
    ref = np.asarray(pallas_softmax_rows(jnp.asarray(x), interpret=True))
    got = bench_softmax.softmax_rows(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("B,sms,full_above,want", [
    (1, 132, None, 8), (8, 132, None, 8), (64, 132, None, 4),
    (132, 132, None, 1), (1000, 132, None, 1), (17, 132, None, 8),
    (33, 132, None, 4), (64, 114, None, 2), (8, 132, 4, 4), (64, 132, 2, 2),
    (8, 132, 0, 1), (3, 16, None, 8),
])
def test_softmax_cluster_size_rule(B, sms, full_above, want):
    """The blocks softmax_rows splits a row over: the smallest power of
    two c with B * c >= the SM count, at most 8 (RULE_CLUSTER), halved
    while the card holds no cluster of c blocks (``full_above``: the
    largest c the occupancy query admits; None, every c)."""
    asked = []

    def active(c):
        asked.append(c)
        return 0 if full_above is not None and c > full_above else 3

    assert bench_softmax.RULE_CLUSTER == 8
    assert bench_softmax.cluster_size(B, sms, active) == want
    # the query is asked only about sizes above 1, largest first
    assert asked == sorted(asked, reverse=True) and 1 not in asked


@pytest.mark.parametrize("quant", [False, True])
def test_flatwide_matches_the_jax_kernel(quant):
    """flatwide_parts (plain route) against the JAX flatwide kernel in
    interpret mode on the case of tests/test_paged_attention.py's
    test_lab_flatwide_matches_oracle (a zero-length row, a window start
    inside a page): 1e-5 abs + rel (float), 2e-5 abs (int8)."""
    ps, P, pps, B, NH, HS = 128, 14, 4, 3, 4, 64
    rng = np.random.default_rng(21)
    q = rng.standard_normal((B, NH, HS), dtype=np.float32)
    k = rng.standard_normal((P, NH, HS, ps), dtype=np.float32)
    v = rng.standard_normal((P, NH, HS, ps), dtype=np.float32)
    tables = rng.permutation(P)[: B * pps].reshape(B, pps).astype(np.int32)
    lengths = np.array([0, 2 * ps + 3, 4 * ps], np.int32)
    starts = np.array([0, ps + 5, 2], np.int32)
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    scales = None
    if quant:
        (jk, ks), (jv, vs) = j_quantize_pages(jk), j_quantize_pages(jv)
        scales = (ks, vs)
    ref = _flatwide_parts_call(jnp.asarray(q), jk, jv, jnp.asarray(tables),
                               jnp.asarray(lengths), jnp.asarray(starts),
                               scales, True)
    got = lab_flatwide.flatwide_parts(
        torch.from_numpy(q), _t(jk), _t(jv), torch.from_numpy(tables),
        torch.from_numpy(lengths), torch.from_numpy(starts),
        None if scales is None else tuple(_t(s) for s in scales))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                   rtol=1e-5 if not quant else 0,
                                   atol=2e-5 if quant else 1e-5)


@pytest.mark.parametrize("shape", [(2, 5, 97), (1, 3, 1000)])
def test_softmax_cross_entropy_matches_jax(shape):
    rng = np.random.default_rng(shape[-1])
    logits = (3 * rng.standard_normal(shape)).astype(np.float32)
    targets = rng.integers(0, shape[-1], shape[:2]).astype(np.int32)
    ref = float(JL.softmax_cross_entropy(jnp.asarray(logits),
                                         jnp.asarray(targets)))
    got = TL.softmax_cross_entropy(torch.from_numpy(logits),
                                   torch.from_numpy(targets))
    assert got.shape == () and abs(float(got) - ref) <= 1e-6 * abs(ref)


# one small configuration per lab module, and how many of its versions
# are validated against its reference
SMALL = {
    bench_int8_matmul: ({"124m": [(8, 96, 64)], "1558m": [(5, 130, 70)]}, 2),
    bench_layernorm: ([(16, 64)], 1),
    bench_softmax: ([(8, 1000)], 1),
    bench_matmul: ([(8, 96, 64)], 0),
    bench_fusion: ([(8, 64, 1000)], 0),
    bench_paged_attention: ([(3, 2, 64, 16, 8, 4), (3, 2, 64, 16, 128, 2)],
                            1),
    lab_flatwide: ([(3, 2, 64, 16, 8, 4, "f32"),
                    (3, 2, 64, 16, 32, 2, "int8")], 2),
}


@pytest.mark.parametrize("mod", list(SMALL), ids=lambda m: m.__name__
                         .rsplit(".", 1)[-1])
def test_lab_entry_point_on_the_cpu(mod, monkeypatch, capsys):
    """Each lab module's main() with --device cpu at a small
    configuration, 2 timed calls a run: every validated version prints
    OK, and the harness counts each version's calls (3 warm-up, 3 runs of
    2, one more to validate)."""
    configs, n_valid = SMALL[mod]
    monkeypatch.setattr(mod, "CONFIGS", configs)
    argv = ["--device", "cpu", "--iters", "2"]
    if mod is bench_int8_matmul:
        argv += ["--set", "all"]
    records = mod.main(argv)
    out = capsys.readouterr().out
    n_cfg = sum(map(len, configs.values())) if isinstance(configs, dict) \
        else len(configs)
    lines = [ln for ln in out.splitlines() if ln.startswith("[validate]")]
    assert all(" OK" in ln and "NOT OK" not in ln for ln in lines), out
    # bench_fusion validates its two pairs against each other once first
    assert len(lines) == n_cfg * n_valid + (mod is bench_fusion), out
    assert "-- device cpu, host clock" in out
    assert len(records) == n_cfg * len(mod.VERSIONS)
    assert sum(r["validated"] for r in records) == n_cfg * n_valid
    for r in records:
        assert r["calls"] == 3 + 3 * 2 + r["validated"]
        assert r["ms"] > 0 and (r["max_abs_err"] is not None) == r["validated"]


@pytest.mark.parametrize("off,opts,ok", [
    (1e-5, {}, True),                                   # harness default
    (1e-5, {"atol": 1e-6, "rtol": 1e-6}, False),
    (1e-5, {"atol": 1e-4, "rtol": 0, "atol_of_max": True}, True),
    (1e-5, {"atol": 1e-6, "rtol": 0, "atol_of_max": True}, False),
    (1e-5, {"ref": "shifted"}, True),
    (2e-5, {"ref": "shifted", "atol": 1e-6, "rtol": 0}, False),
])
def test_sweep_holds_a_version_to_its_own_reference(off, opts, ok, capsys):
    """A version's options choose its reference (another version) and its
    tolerance; a version off by more than that tolerance stops the
    sweep. The inputs' max |x| is 4, so atol_of_max scales atol by 4."""
    from llmc_paged_tpu_torch.ops.dev import harness
    versions = {
        "ref": lambda x: x,
        "shifted": (lambda x: x + 1e-5, {"validate": False}),
        "version": (lambda x: x + off, opts),
    }
    make_args = lambda n, device: (torch.linspace(-4, 4, n, device=device),)
    run = lambda: harness.sweep(versions, make_args, [(9,)], "ref", iters=1,
                                device="cpu")
    if ok:
        records = run()
        assert [r["validated"] for r in records] == [False, False, True]
    else:
        with pytest.raises(AssertionError, match="version mismatch"):
            run()
        assert "[validate] version" in capsys.readouterr().out


def test_lab_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_softmax.main(["--iters", "1"])
