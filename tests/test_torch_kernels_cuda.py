"""The CUDA flash-decode parts kernel against its plain PyTorch version,
on the card (marked ``cuda``; skipped where there is no GPU).

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
@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("ps", [8, 32, 128])
def test_kernel_matches_plain_on_the_card(cuda, kv, ps):  # noqa: F811
    """CUDA kernel vs plain version on the same tensors; bf16 pools are
    compared with the plain version over the same bf16 values (it upcasts
    to f32). Tolerance 1e-4 abs + 1e-4 rel: f32 sums in another order."""
    q, pool, tables, lengths, starts = _case(ps, kv == "int8", seed=11)
    a = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
         for x in (q, *pool, tables, lengths, starts)]
    if kv == "bfloat16":
        a[1], a[2] = a[1].to(torch.bfloat16), a[2].to(torch.bfloat16)
    quant = kv == "int8"
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
