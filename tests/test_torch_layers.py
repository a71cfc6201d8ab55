"""ops/layers.py of the port against the JAX package's, fp32, atol 1e-5
(the same inputs through both; results differ only by summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_paged_tpu.ops import layers as JL
from llmc_paged_tpu_torch.ops import layers as TL

ATOL = 1e-5


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def test_layernorm():
    rng = np.random.default_rng(0)
    x, w, b = _rand(rng, 4, 7, 128, scale=3.0), _rand(rng, 128), _rand(rng, 128)
    ref = np.asarray(JL.layernorm(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b)))
    got = TL.layernorm(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_layernorm_keeps_dtype_and_fp32_statistics():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(_rand(rng, 3, 64)).to(torch.bfloat16)
    w, b = torch.ones(64), torch.zeros(64)
    out = TL.layernorm(x, w, b)
    assert out.dtype == torch.bfloat16
    ref = np.asarray(JL.layernorm(jnp.asarray(x.float().numpy(),
                                              jnp.bfloat16),
                                  jnp.ones(64), jnp.zeros(64)),
                     dtype=np.float32)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=1e-2)


def test_gelu_tanh():
    x = _rand(np.random.default_rng(2), 1000, scale=4.0)
    ref = np.asarray(JL.gelu_tanh(jnp.asarray(x)))
    got = TL.gelu_tanh(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("bias", [True, False])
def test_linear(bias):
    rng = np.random.default_rng(3)
    x, w = _rand(rng, 5, 3, 128), _rand(rng, 96, 128, scale=0.1)
    b = _rand(rng, 96) if bias else None
    ref = np.asarray(JL.linear(jnp.asarray(x), jnp.asarray(w),
                               None if b is None else jnp.asarray(b)))
    got = TL.linear(torch.from_numpy(x), torch.from_numpy(w),
                    None if b is None else torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_causal_attention():
    rng = np.random.default_rng(4)
    q, k, v = (_rand(rng, 2, 2, 19, 64) for _ in range(3))
    ref = np.asarray(JL.causal_attention(*(jnp.asarray(a) for a in (q, k, v))))
    got = TL.causal_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("with_start", [False, True])
def test_decode_attention(with_start):
    """Ragged lengths, a zero-length row and (with starts) a fully masked
    row, which must give zeros."""
    rng = np.random.default_rng(5)
    q = _rand(rng, 4, 2, 64)
    k, v = _rand(rng, 4, 2, 40, 64), _rand(rng, 4, 2, 40, 64)
    length = np.array([40, 17, 0, 9], np.int32)
    start = np.array([0, 5, 0, 12], np.int32) if with_start else None
    ref = np.asarray(JL.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(length),
        None if start is None else jnp.asarray(start)))
    got = TL.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(length),
        None if start is None else torch.from_numpy(start)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    assert np.all(got[2] == 0)                  # length 0
    if with_start:
        assert np.all(got[3] == 0)              # start >= length
