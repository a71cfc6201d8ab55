"""LAB ARTIFACT: the "flatwide" paged-attention experiment, port of
llmc_paged_tpu/ops/dev/lab_flatwide.py.

On the TPU the flatwide kernel DMA'd every live page of the batch into one
wide VMEM buffer and ran the whole batch's attention as two masked dots
and one masked softmax, with no online rescaling; it measured 40x slower
than the flat ring kernel there (the JAX module's docstring has the
numbers), and stays as the design record. The port keeps the idea on
Hopper: ``flatwide_parts`` (``csrc/lab_flatwide.cu``) gives one block a
(row, head), writes every live token's score to shared memory, takes ONE
max, one exp pass and one sum, then the PV sum; no cross-row work, no
4096-lane cap, any page size. Its K and V loads are the parts template's
(8 warps on 32-token chunks, 4 tokens x 16 head dims a lane as vectors);
page sizes that are not a multiple of 4, and unaligned pools, take a
scalar kernel in the same source. Whether the design pays on this card,
against the online-softmax parts kernel (``csrc/paged_attention.cu``)
on the same tensors, is what this lab measures.

Run: python -m llmc_paged_tpu_torch.ops.dev.lab_flatwide [--device cpu]
     [--iters N]
"""

from __future__ import annotations

import ctypes
import math

import torch

from llmc_paged_tpu_torch.kv.layouts import quantize_pages
from llmc_paged_tpu_torch.ops._build import entry, launch
from llmc_paged_tpu_torch.ops.dev.harness import parse_args, sweep
from llmc_paged_tpu_torch.ops.paged_attention import (
    _KIND,
    _check_operands,
    paged_decode_attention_parts,
    paged_decode_attention_parts_ref,
    paged_decode_attention_quant_parts,
    paged_decode_attention_quant_parts_ref,
)

# launches of the CUDA kernel, by pool kind (plain ints; reset by callers)
LAUNCHES = {"flatwide_parts": 0, "flatwide_quant_parts": 0}
HEAD_DIMS = (64,)          # the .cu's register tile (every GPT-2 size)
_WARPS = 8                 # the vector kernel's (the scalar one has 4)
_GROUP, _VEC = 4, 4        # lanes a token group, tokens a lane vector
_MAX_SMEM = 232448         # Hopper's opt-in shared memory a block


def smem_bytes(HS: int, ps: int, pps: int) -> int:
    """Shared memory of one block of the vector kernel (the scalar one
    needs less): the scores of up to pps*ps tokens, q padded to 20 floats
    a lane group, the warps' acc rows, maxima and l, all f32."""
    return 4 * (pps * ps + _GROUP * (HS // _GROUP + _VEC) + _WARPS * HS
                + 2 * _WARPS)


def flatwide_parts(q, k_pages, v_pages, block_tables, lengths, starts=None,
                   scales=None):
    """Single-query paged attention parts without online rescaling: acc
    (B, NH, HS), m (B, NH), l (B, NH), all f32, under the port's parts
    contract (a row with no live token: m = NEG_INF, l = 0, acc = 0).
    q (B, NH, HS) f32/bf16; pages (P, NH, HS, ps) f32/bf16, or int8 with
    ``scales`` = (k_scale, v_scale) (P, NH, ps) f32 folded in after the
    dots. A CPU tensor takes the plain version
    (``paged_decode_attention[_quant]_parts_ref``); a CUDA tensor
    launches the kernel or raises."""
    if starts is None:
        starts = torch.zeros_like(lengths)
    if q.device.type == "cpu":
        if scales is None:
            return paged_decode_attention_parts_ref(
                q, k_pages, v_pages, block_tables, lengths, starts)
        return paged_decode_attention_quant_parts_ref(
            q, k_pages, v_pages, *scales, block_tables, lengths, starts)
    if q.device.type != "cuda":
        raise ValueError(f"no flatwide_parts route for device {q.device}")
    B, _, NH, HS, ps, pps = _check_operands(
        q, k_pages, v_pages, scales, block_tables, lengths, starts, False)
    if HS not in HEAD_DIMS:
        raise ValueError(f"head_dim {HS} is not one of the kernel's "
                         f"{HEAD_DIMS}")
    if smem_bytes(HS, ps, pps) > _MAX_SMEM:
        raise ValueError(f"pages_per_seq {pps} x page_size {ps} tokens "
                         "exceed the kernel's shared memory")
    dev = q.device
    acc = torch.empty((B, NH, HS), dtype=torch.float32, device=dev)
    m = torch.empty((B, NH), dtype=torch.float32, device=dev)
    l = torch.empty((B, NH), dtype=torch.float32, device=dev)
    if B == 0 or NH == 0:
        return acc, m, l
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn = entry("lab_flatwide", "flatwide_parts",
               [i32, i32] + [ptr] * 11 + [i32] * 5 + [ctypes.c_float, ptr])
    ks, vs = scales if scales is not None else (None, None)
    key = "flatwide_parts" if scales is None else "flatwide_quant_parts"
    launch(fn, dev, (
        _KIND[q.dtype], _KIND[k_pages.dtype], q.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(),
        ks.data_ptr() if ks is not None else None,
        vs.data_ptr() if vs is not None else None, block_tables.data_ptr(),
        lengths.data_ptr(), starts.data_ptr(), acc.data_ptr(), m.data_ptr(),
        l.data_ptr(), B, NH, HS, ps, pps, 1.0 / math.sqrt(HS)), key)
    LAUNCHES[key] += 1
    return acc, m, l


def make_args(B, NH, HS, P, ps, pps, kv, device):
    """q and a pool of P pages (distinct table entries), ragged lengths
    in [1, pps*ps], starts 0; "int8" quantizes the pool per token and
    sends q in bf16, as the int8 headline engine does."""
    g = torch.Generator(device=device).manual_seed(0)
    q = torch.randn(B, NH, HS, generator=g, device=device)
    k = torch.randn(P, NH, HS, ps, generator=g, device=device)
    v = torch.randn(P, NH, HS, ps, generator=g, device=device)
    tables = torch.randperm(P, generator=g, device=device)[: B * pps]
    tables = tables.reshape(B, pps).to(torch.int32)
    lengths = torch.randint(1, pps * ps + 1, (B,), generator=g,
                            device=device, dtype=torch.int32)
    starts = torch.zeros_like(lengths)
    if kv == "int8":
        (k, ks), (v, vs) = quantize_pages(k), quantize_pages(v)
        return q.bfloat16(), k, v, (ks, vs), tables, lengths, starts
    return q, k, v, None, tables, lengths, starts


def _parts(q, k, v, scales, tables, lengths, starts):
    if scales is None:
        return paged_decode_attention_parts(q, k, v, tables, lengths, starts)
    return paged_decode_attention_quant_parts(q, k, v, *scales, tables,
                                              lengths, starts)


def _parts_ref(q, k, v, scales, tables, lengths, starts):
    if scales is None:
        return paged_decode_attention_parts_ref(q, k, v, tables, lengths,
                                                starts)
    return paged_decode_attention_quant_parts_ref(q, k, v, *scales, tables,
                                                  lengths, starts)


VERSIONS = {
    "v0_gather_ref (naive)": _parts_ref,
    "v1_cuda_online_parts": _parts,
    "v2_cuda_flatwide": lambda q, k, v, scales, tables, lengths, starts:
        flatwide_parts(q, k, v, tables, lengths, starts, scales),
}


def kv_bytes(B, NH, HS, P, ps, pps, kv):
    """K and V of every table entry (an upper bound: the live tokens of
    the ragged rows are fewer)."""
    return 2 * B * NH * pps * ps * HS * (1 if kv == "int8" else 4)


CONFIGS = [
    # the GPT-2 124M decode shape (chip_smoke.py phase 3's headline), f32
    # and the int8 pool under bf16 q; then the 1.5B head count the TPU
    # experiment measured
    (8, 12, 64, 28, 128, 3, "f32"),
    (8, 12, 64, 28, 128, 3, "int8"),
    (8, 25, 64, 28, 128, 3, "f32"),
    (8, 25, 64, 28, 128, 3, "int8"),
]


def main(argv=None):
    a = parse_args(argv)
    return sweep(VERSIONS, make_args, CONFIGS,
                 ref_name="v0_gather_ref (naive)", bytes_fn=kv_bytes,
                 iters=a.iters, device=a.device)


if __name__ == "__main__":
    main()
