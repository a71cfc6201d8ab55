"""ops/paged_attention.py of the port.

On the CPU: the plain parts (float and int8 pools) against the JAX
package's paged_decode_attention[_quant]_parts_xla at atol 1e-5, over
ragged and zero lengths, window starts and fully masked pages, ps in
{8, 32, 128}; one tiny ps=128 case against the JAX flat Pallas kernel in
interpret mode. The CUDA kernel against the plain version is in
test_torch_kernels_cuda.py (it runs on the card).
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
@pytest.mark.parametrize("ps", [8, 32, 128])
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
