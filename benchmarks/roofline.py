"""The yardstick's arithmetic: the H100's published peaks, the FLOPs a
GPT-2 token needs, and the bytes and operations of the two attention
kernels the cells measure.

Peaks are NVIDIA's data-sheet figures for the H100 SXM (dense, at its
700 W limit): 989 TFLOP/s in bf16 on the tensor cores, 67 TFLOP/s in
f32 outside them, 3.35 TB/s of HBM. A share of a peak is reported with
the card's power limit beside it (the result line's ``device``).

Counts are of REAL tokens: padding rows and padded positions of a
prefill wave, and decode steps past a row's last token, are work the
program chose to do and are not counted.
"""

from __future__ import annotations

from typing import Iterable, Sequence

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# bytes of one element, by the dtype names the config files use
DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}


def linear_flops(L: int, C: int) -> float:
    """One token through the 12·L·C² weights of the blocks (qkv 3C²,
    attproj C², fc 4C², fcproj 4C²), two operations a multiply-add."""
    return 2.0 * 12 * L * C * C


def lm_head_flops(C: int, V: int) -> float:
    """One row of the tied lm_head."""
    return 2.0 * C * V


def attention_flops(L: int, C: int, ctx: int) -> float:
    """One query over ``ctx`` keys in every layer: QK and PV, 4·ctx·C·L."""
    return 4.0 * ctx * C * L


def prefill_flops(L: int, C: int, V: int, n: int, lm_rows: int) -> float:
    """A prompt of ``n`` real tokens: the linears, causal attention (query
    t attends t + 1 keys, a sum of 2·n(n+1)·C·L) and ``lm_rows`` rows of
    the lm_head (1 where only the last position is projected, n for
    prompt scoring)."""
    return (n * linear_flops(L, C) + 2.0 * n * (n + 1) * C * L
            + lm_rows * lm_head_flops(C, V))


def decode_flops(L: int, C: int, V: int, ctx: int) -> float:
    """One decode token whose query attends ``ctx`` keys (itself
    included), with its lm_head row."""
    return linear_flops(L, C) + attention_flops(L, C, ctx) \
        + lm_head_flops(C, V)


def kv_bytes_per_token(L: int, NH: int, HS: int, kv_dtype: str) -> float:
    """K and V of one token in every layer, int8 pages with one f32 scale
    a (token, head) for each (bench.py's ``_kv_bytes_per_token``)."""
    if kv_dtype == "int8":
        return L * NH * (2.0 * HS + 2 * 4)
    return L * NH * 2.0 * HS * DTYPE_BYTES[kv_dtype]


def parts_call_bytes(lengths: Sequence[int], B: int, NH: int, HS: int,
                     ps: int, q_bytes: int = 4) -> float:
    """One single-query int8 parts call (one layer): each live row reads
    its committed K and V (int8, ``n`` tokens), their f32 scales, its
    block-table entries and its query (f32: the int8 linears return f32);
    the kernel writes acc (f32, HS a head) and m and l (f32) for every one
    of the B rows."""
    total = 0.0
    for n in lengths:
        if n <= 0:
            continue
        total += (n * kv_bytes_per_token(1, NH, HS, "int8")
                  + 4 * (-(-n // ps)) + NH * HS * q_bytes)
    return total + B * NH * (HS + 2) * 4


def parts_call_flops(lengths: Iterable[int], NH: int, HS: int) -> float:
    """QK and PV of one query per live row over its committed keys."""
    return sum(4.0 * n * NH * HS for n in lengths if n > 0)


def parts_call_bound_s(lengths: Sequence[int], B: int, NH: int, HS: int,
                       ps: int) -> float:
    """The least time of one parts call: its bytes at the HBM peak or its
    f32 operations (the kernel's dots run on the CUDA cores) at the f32
    peak, whichever is larger."""
    return max(parts_call_bytes(lengths, B, NH, HS, ps) / PEAK_HBM_BYTES,
               parts_call_flops(lengths, NH, HS) / PEAK_F32_FLOPS)


def flash_call_bound_s(lengths: Sequence[int], NH: int, HS: int) -> float:
    """The least time of one causal flash call (one layer of a wave) over
    the real tokens: 2·n(n+1)·C operations a row at the bf16 peak, or q,
    k, v in and o out in bf16 at the HBM peak, whichever is larger."""
    C = NH * HS
    flops = sum(2.0 * n * (n + 1) * C for n in lengths)
    nbytes = sum(4.0 * n * C * 2 for n in lengths)
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
