"""The fp32-mode split of int8_matmul (ops/int8.py::split_bf16x3, the plain
mirror of the CUDA kernel's three bf16 terms), checked with numpy on the
CPU: the terms are bf16 values that sum to x exactly, and three bf16
products summed in f32 give the fp32-exact product."""

import numpy as np
import pytest
import torch

from llmc_paged_tpu_torch.ops import int8 as T8

F32 = np.finfo(np.float32)
EDGES = np.array([0.0, -0.0, 1e38, -1e38, 1e-38, -1e-38,
                  np.nextafter(np.float32(1), np.float32(2)),
                  np.nextafter(np.float32(1), np.float32(0)),
                  -np.nextafter(np.float32(1), np.float32(2)),
                  F32.max, -F32.max, F32.tiny, -F32.tiny, 1.0, -1.0],
                 np.float32)


def _split(x: np.ndarray):
    """split_bf16x3 of a numpy f32 array: three float64 arrays."""
    return [t.float().double().numpy()
            for t in T8.split_bf16x3(torch.from_numpy(x))]


def _is_bf16(a: np.ndarray) -> bool:
    return bool((a.astype(np.float32).view(np.uint32) & 0xFFFF == 0).all())


def _normal_patterns(n, seed):
    """n random f32 bit patterns of normal numbers: any sign and mantissa,
    biased exponent 1..254."""
    rng = np.random.default_rng(seed)
    sign = rng.integers(0, 2, n, dtype=np.uint32) << 31
    exp = rng.integers(1, 255, n, dtype=np.uint32) << 23
    man = rng.integers(0, 1 << 23, n, dtype=np.uint32)
    return (sign | exp | man).view(np.float32)


@pytest.mark.parametrize("values", ["random", "edges"])
def test_split_bf16x3_sums_to_x_exactly(values):
    """hi + mid + lo == x in float64, for 2^16 random f32 bit patterns of
    normal numbers (or the edge values: ±0, ±1e±38, 1 ± one ulp, ±the
    largest f32, ±the smallest normal), each term a bf16 value. Exact
    for zeros and wherever x's lowest bit lies on the bf16 grid (|x| >=
    2^-110: the bf16 subnormals are multiples of 2^-133); below it, as
    for the f32 subnormal 1e-38 and the normals under 2^-110, the terms
    miss x by less than 2^-133."""
    x = _normal_patterns(1 << 16, seed=8) if values == "random" else EDGES
    hi, mid, lo = _split(x)
    assert all(_is_bf16(t) for t in (hi, mid, lo))
    err = np.abs(hi + mid + lo - x.astype(np.float64))
    big = (np.abs(x.astype(np.float64)) >= 2.0 ** -110) | (x == 0)
    assert big.sum() >= (0.9 * x.size if values == "random" else 11)
    np.testing.assert_array_equal(err[big], 0.0)
    assert bool((err[~big] < 2.0 ** -133).all())
    assert np.isfinite(hi).all()            # the largest f32 stays finite


@pytest.mark.parametrize("B,OC,IC", [(8, 96, 64), (5, 256, 128),
                                     (16, 130, 70)])
def test_split_products_match_the_fp32_reference(B, OC, IC):
    """The three bf16-rounded products summed in f32 (as the kernel's
    three MMAs accumulate) against int8_matmul_ref(..., bf16_compute=False),
    at the shapes of test_int8_matmul_matches_the_jax_kernel; 1e-5 rel +
    1e-5·max|ref| abs: f32 sums in another order."""
    rng = np.random.default_rng(B + OC + IC)
    x = rng.standard_normal((B, IC)).astype(np.float32)
    w = (0.05 * rng.standard_normal((OC, IC))).astype(np.float32)
    wq, s = T8.quantize_per_row(torch.from_numpy(w))
    ref = T8.int8_matmul_ref(torch.from_numpy(x), wq, s,
                             bf16_compute=False).numpy()
    wf = wq.float()
    got = sum(torch.matmul(t.float(), wf.t())
              for t in reversed(T8.split_bf16x3(torch.from_numpy(x))))
    got = (got * s).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_chip_smoke_logs_int8_matmul_beside_the_serving_linear(monkeypatch,
                                                               capsys):
    """chip_smoke.py's phase 11 line for every bench_int8_matmul shape:
    both kernel modes, the serving int8 linear and the bf16 dense
    product, from the sweep's records (here a CPU sweep at two small
    shapes)."""
    import os
    from llmc_paged_tpu_torch.ops.dev import bench_int8_matmul
    monkeypatch.syspath_prepend(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    monkeypatch.setattr(bench_int8_matmul, "CONFIGS",
                        {"124m": [(8, 96, 64)], "1558m": [(5, 130, 70)]})
    recs = bench_int8_matmul.main(["--device", "cpu", "--iters", "2",
                                   "--set", "all"])
    capsys.readouterr()
    chip_smoke.log_int8_lab(recs)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("  int8_matmul beside the serving int8 linear")
    assert [ln.split(":")[0].strip() for ln in lines[1:]] == [
        "(8, 96, 64)", "(5, 130, 70)"]
    for ln in lines[1:]:
        for label in ("bf16 mode", "fp32 mode", "int8_linear (port)",
                      "bf16 dense"):
            assert f"{label} " in ln, ln
