"""ops/int8.py host half of the port against the JAX package: int8 values
and scales EQUAL (zero rows and .5 ties included), the int8 linear within
atol 1e-5 in both compute modes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_paged_tpu.kv.layouts import quantize_rows as j_quantize_rows
from llmc_paged_tpu.ops import int8 as J
from llmc_paged_tpu_torch.ops import int8 as T
from test_torch_common import params_np, port_cfg


def _rows():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 64)).astype(np.float32)
    x[1] = 0.0                                   # zero row → scale 1.0
    # absmax 127 → scale exactly 1.0, so these land on .5 ties
    x[2, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    x[2, 8:] = 0.0
    x[3] *= 1e-3                                 # tiny magnitudes
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_equal(dtype):
    x = _rows()
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = j_quantize_rows(jnp.asarray(x, getattr(jnp, dtype)))
    tq, ts = T.quantize_rows(xt)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[1] == 1.0 and not tq[1].any()
    assert tq[2, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]


def test_quantize_per_row_refuses_int8():
    with pytest.raises(ValueError):
        T.quantize_per_row(torch.zeros(2, 2, dtype=torch.int8))


def test_quantize_params_equal():
    """Stacked (L, OC, IC) weights get per-(layer, row) scales. The tiny
    widths are multiples of 128, so the JAX package's Mosaic padding is a
    no-op and the arrays compare whole."""
    p = params_np(port_cfg())
    jp = J.quantize_params({k: jnp.asarray(v) for k, v in p.items()})
    tp = T.quantize_params({k: torch.from_numpy(v) for k, v in p.items()})
    assert set(jp) == set(tp)
    for k in T.QUANT_KEYS:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]), k)
        np.testing.assert_array_equal(tp[k + "_scale"].numpy(),
                                      np.asarray(jp[k + "_scale"]), k)
    np.testing.assert_array_equal(tp["ln1w"].numpy(), p["ln1w"])


@pytest.mark.parametrize("bf16_compute", [True, False])
@pytest.mark.parametrize("bias", [True, False])
def test_int8_linear(bf16_compute, bias):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 128)).astype(np.float32)
    w = (0.05 * rng.standard_normal((192, 128))).astype(np.float32)
    b = (0.1 * rng.standard_normal(192)).astype(np.float32) if bias else None
    wq, s = j_quantize_rows(jnp.asarray(w))
    ref = np.asarray(J.int8_linear(jnp.asarray(x), wq, s,
                                   None if b is None else jnp.asarray(b),
                                   bf16_compute=bf16_compute))
    got = T.int8_linear(torch.from_numpy(x), torch.from_numpy(np.array(wq)),
                        torch.from_numpy(np.array(s)),
                        None if b is None else torch.from_numpy(b),
                        bf16_compute=bf16_compute)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
