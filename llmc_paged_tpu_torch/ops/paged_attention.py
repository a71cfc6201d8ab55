"""Paged flash-decode attention: the hand-written CUDA kernels and their
plain PyTorch versions (port of llmc_paged_tpu/ops/paged_attention.py:
the single-query and multi-query parts paths and the normalized grid
path).

Two kernels compute the JAX package's PARTS contract: for each row,
attention over the row's live pages [start//ps, (len-1)//ps] read
through the block table, positions outside [start, len) masked,
returning UNNORMALIZED online-softmax parts. ``csrc/paged_attention.cu``
takes one query per row (acc (B,NH,HS) f32, m/l (B,NH) f32); the decode
chunk merges its parts with the in-flight tail. ``csrc/paged_attention_mq.cu``
takes KQ queries per row that all attend the same committed range, with
no causal mask inside the pool (acc (B,KQ,NH,HS) f32, m/l (B,KQ,NH)
f32): speculative verify and suffix prefill merge them with their causal
in-flight block. ``csrc/paged_attention_grid.cu`` computes NORMALIZED
single-query attention (B,NH,HS) in q's dtype, int8 scales applied
after the dots as in the parts kernels (the JAX grid kernel scales K and
V before them: the same maths, rounded elsewhere): the normalized
wrappers route to it when the page size is not a multiple of 128, as the
JAX package routes to its grid kernel, and divide the single-query parts
otherwise.

Dispatch: a tensor on the CPU goes to the plain version; a tensor on the
card launches the kernel or raises — there is no fallback. Each launch
adds one to ``LAUNCHES[<wrapper>]``, so a run can show that it went
through the kernel. Pool layout: pages (P, NH, HS, ps), int8 scales
(P, NH, ps), as in the JAX package.
"""

from __future__ import annotations

import ctypes
import math

import torch

from llmc_paged_tpu_torch.kv.layouts import dequant_layer, gather_layer_kv
from llmc_paged_tpu_torch.ops._build import check_operand, entry, launch
from llmc_paged_tpu_torch.ops import layers as L

NEG_INF = -1e30

# launches of the CUDA kernel, by wrapper (plain ints; reset by callers)
LAUNCHES = {"paged_decode_attention_parts": 0,
            "paged_decode_attention_quant_parts": 0,
            "paged_decode_attention_parts_mq": 0,
            "paged_decode_attention_quant_parts_mq": 0,
            "paged_decode_attention_grid": 0,
            "paged_decode_attention_quant_grid": 0}

_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}  # the .cu enum
# head sizes the parts and grid kernels are instantiated for (their
# register tiles): every GPT-2 size has head_dim 64, Mellum 2 has 128
PARTS_HEAD_DIMS = (64, 128)
GRID_HEAD_DIMS = (64,)
# tokens a parts-kernel lane loads as one vector: the page size and the
# pools' alignment must be multiples of it
PARTS_VEC = 4


# ---- plain PyTorch versions -------------------------------------------------

def _parts_from_dense(q, k, v, lengths, starts):
    """Unnormalized online-softmax parts over gathered dense KV
    (B, NH, S, HS): the plain twin of the kernel's output contract."""
    B, NH, S, HS = k.shape
    qf = q.float()
    scale = float(torch.rsqrt(torch.tensor(float(HS))))
    scores = torch.einsum("bhd,bhkd->bhk", qf, k.float()) * scale
    pos = torch.arange(S, device=q.device).view(1, 1, S)
    valid = pos < lengths.view(B, 1, 1)
    if starts is not None:
        valid = valid & (pos >= starts.view(B, 1, 1))
    scores = torch.where(valid, scores, NEG_INF)
    m = scores.amax(dim=-1)                       # (B, NH); NEG_INF if none
    p = torch.where(valid, torch.exp(scores - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhk,bhkd->bhd", p, v.float())
    return acc, m, l


def paged_decode_attention_parts_ref(q, k_pages, v_pages, block_tables,
                                     lengths, starts=None):
    """Plain version of paged_decode_attention_parts: gather the whole
    block table, then masked dense parts."""
    k, v = gather_layer_kv(k_pages, v_pages, block_tables)
    return _parts_from_dense(q, k, v, lengths, starts)


def paged_decode_attention_quant_parts_ref(q, k_pages, v_pages, k_scale,
                                           v_scale, block_tables, lengths,
                                           starts=None):
    """Plain version of paged_decode_attention_quant_parts: dequantize,
    gather, dense parts."""
    k, v = gather_layer_kv(dequant_layer(k_pages, k_scale),
                           dequant_layer(v_pages, v_scale), block_tables)
    return _parts_from_dense(q, k, v, lengths, starts)


def _parts_from_dense_mq(q, k, v, lengths, starts):
    """Multi-query twin of _parts_from_dense: q (B, KQ, NH, HS) over
    gathered dense KV (B, NH, S, HS) → acc (B,KQ,NH,HS), m/l (B,KQ,NH)."""
    B, NH, S, HS = k.shape
    qf = q.float()
    scale = float(torch.rsqrt(torch.tensor(float(HS))))
    scores = torch.einsum("bqhd,bhkd->bhqk", qf, k.float()) * scale
    pos = torch.arange(S, device=q.device).view(1, 1, 1, S)
    valid = pos < lengths.view(B, 1, 1, 1)
    if starts is not None:
        valid = valid & (pos >= starts.view(B, 1, 1, 1))
    scores = torch.where(valid, scores, NEG_INF)
    m = scores.amax(dim=-1)                       # (B, NH, KQ)
    p = torch.where(valid, torch.exp(scores - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhqk,bhkd->bqhd", p, v.float())
    return acc, m.transpose(1, 2), l.transpose(1, 2)


def paged_decode_attention_parts_mq_ref(q, k_pages, v_pages, block_tables,
                                        lengths, starts=None):
    """Plain version of paged_decode_attention_parts_mq."""
    k, v = gather_layer_kv(k_pages, v_pages, block_tables)
    return _parts_from_dense_mq(q, k, v, lengths, starts)


def paged_decode_attention_quant_parts_mq_ref(q, k_pages, v_pages, k_scale,
                                              v_scale, block_tables, lengths,
                                              starts=None):
    """Plain version of paged_decode_attention_quant_parts_mq."""
    k, v = gather_layer_kv(dequant_layer(k_pages, k_scale),
                           dequant_layer(v_pages, v_scale), block_tables)
    return _parts_from_dense_mq(q, k, v, lengths, starts)


def paged_decode_attention_ref(q, k_pages, v_pages, block_tables, lengths,
                               starts=None):
    """Plain normalized attention over the gathered pool (the JAX
    package's paged_decode_attention_xla): the use_kernel=False route of
    the single-step decode."""
    k, v = gather_layer_kv(k_pages, v_pages, block_tables)
    return L.decode_attention(q, k, v, lengths, start=starts)


def paged_decode_attention_quant_ref(q, k_pages, v_pages, k_scale, v_scale,
                                     block_tables, lengths, starts=None):
    """INT8 twin of paged_decode_attention_ref: dequantize the pool first."""
    return paged_decode_attention_ref(
        q, dequant_layer(k_pages, k_scale), dequant_layer(v_pages, v_scale),
        block_tables, lengths, starts)


def paged_decode_attention_grid_ref(q, k_pages, v_pages, block_tables,
                                    lengths, starts=None):
    """Plain version of paged_decode_attention_grid: the plain normalized
    attention computed in f32 (an f32 q promotes the gathered pool) and
    rounded to q.dtype once, as the grid kernel does."""
    return paged_decode_attention_ref(q.float(), k_pages, v_pages,
                                      block_tables, lengths,
                                      starts).to(q.dtype)


def paged_decode_attention_quant_grid_ref(q, k_pages, v_pages, k_scale,
                                          v_scale, block_tables, lengths,
                                          starts=None):
    """Plain version of paged_decode_attention_quant_grid (the pool
    dequantized to f32 first, so K and V are scaled before the dots)."""
    return paged_decode_attention_quant_ref(
        q.float(), k_pages, v_pages, k_scale, v_scale, block_tables,
        lengths, starts).to(q.dtype)


# ---- the CUDA kernels -------------------------------------------------------

def _kernel_fn(kind: str):
    """The C entry point of a kernel: "sq" (single-query parts), "mq"
    (multi-query parts) or "grid" (normalized)."""
    if kind == "mq":
        lib, fn, n_ptr, n_int = ("paged_attention_mq", "flash_decode_parts_mq",
                                 11, 6)   # B, KQ, NH, HS, ps, pps
    elif kind == "grid":
        lib, fn, n_ptr, n_int = ("paged_attention_grid", "paged_decode_grid",
                                 9, 5)    # out only; B, NH, HS, ps, pps
    else:
        lib, fn, n_ptr, n_int = ("paged_attention", "flash_decode_parts",
                                 11, 5)   # B, NH, HS, ps, pps
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return entry(lib, fn, [i32, i32] + [ptr] * n_ptr + [i32] * n_int
                 + [ctypes.c_float, ptr])


def _check_operands(q, k_pages, v_pages, scales, block_tables, lengths,
                    starts, mq):
    """Raise on anything the kernels do not take; returns (B, KQ, NH, HS,
    ps, pps)."""
    dev = q.device
    if q.dim() != (4 if mq else 3) or k_pages.dim() != 4:
        raise ValueError(("q must be (B, KQ, NH, HS)" if mq else
                          "q must be (B, NH, HS)")
                         + " and pages (P, NH, HS, ps)")
    if mq:
        B, KQ, NH, HS = q.shape
    else:
        (B, NH, HS), KQ = q.shape, 1
    P, _, _, ps = k_pages.shape
    pps = block_tables.shape[-1]
    kv_dtypes = ((torch.int8,) if scales is not None
                 else (torch.float32, torch.bfloat16))
    check_operand("q", q, (torch.float32, torch.bfloat16), q.shape, dev)
    check_operand("k_pages", k_pages, kv_dtypes, (P, NH, HS, ps), dev)
    check_operand("v_pages", v_pages, (k_pages.dtype,), (P, NH, HS, ps), dev)
    check_operand("block_tables", block_tables, (torch.int32,), (B, pps), dev)
    check_operand("lengths", lengths, (torch.int32,), (B,), dev)
    check_operand("starts", starts, (torch.int32,), (B,), dev)
    if scales is not None:
        for nm, s in zip(("k_scale", "v_scale"), scales):
            check_operand(nm, s, (torch.float32,), (P, NH, ps), dev)
    return B, KQ, NH, HS, ps, pps


def _call(wrapper, kind, q, k_pages, v_pages, scales, block_tables,
          lengths, starts, outs, dims):
    """Launch kernel ``kind`` on the current stream and count it."""
    ks, vs = scales if scales is not None else (None, None)
    launch(_kernel_fn(kind), q.device, (
        _KIND[q.dtype], _KIND[k_pages.dtype], q.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(),
        ks.data_ptr() if ks is not None else None,
        vs.data_ptr() if vs is not None else None,
        block_tables.data_ptr(), lengths.data_ptr(), starts.data_ptr(),
        *(o.data_ptr() for o in outs), *dims,
        1.0 / math.sqrt(q.shape[-1])), wrapper)
    LAUNCHES[wrapper] += 1


def _launch(wrapper, mq, q, k_pages, v_pages, scales, block_tables,
            lengths, starts):
    """Validate, allocate the outputs and launch a parts kernel: the
    single-query kernel (q (B, NH, HS)) or, with ``mq``, the multi-query
    kernel (q (B, KQ, NH, HS)). Raises on anything the kernel does not
    take."""
    B, KQ, NH, HS, ps, pps = _check_operands(
        q, k_pages, v_pages, scales, block_tables, lengths, starts, mq)
    if HS not in PARTS_HEAD_DIMS:
        raise ValueError(f"head_dim {HS} is not one of the parts kernels' "
                         f"{PARTS_HEAD_DIMS}")
    if ps % PARTS_VEC != 0:
        raise ValueError(f"page_size {ps} is not a multiple of the parts "
                         f"kernels' vector of {PARTS_VEC} tokens")
    align = PARTS_VEC * k_pages.element_size()
    if k_pages.data_ptr() % align or v_pages.data_ptr() % align:
        raise ValueError(f"k_pages/v_pages must be {align}-byte aligned "
                         "(the parts kernels' vector loads)")
    lead = (B, KQ) if mq else (B,)
    dev = q.device
    acc = torch.empty((*lead, NH, HS), dtype=torch.float32, device=dev)
    m = torch.empty((*lead, NH), dtype=torch.float32, device=dev)
    l = torch.empty((*lead, NH), dtype=torch.float32, device=dev)
    if B == 0 or NH == 0 or KQ == 0:
        return acc, m, l
    dims = (B, KQ, NH, HS, ps, pps) if mq else (B, NH, HS, ps, pps)
    _call(wrapper, "mq" if mq else "sq", q, k_pages, v_pages, scales,
          block_tables, lengths, starts, (acc, m, l), dims)
    return acc, m, l


def _launch_grid(wrapper, q, k_pages, v_pages, scales, block_tables,
                 lengths, starts):
    """Validate, allocate the (B, NH, HS) output in q's dtype and launch
    the normalized grid kernel. Raises on anything it does not take."""
    B, _, NH, HS, ps, pps = _check_operands(
        q, k_pages, v_pages, scales, block_tables, lengths, starts, False)
    if HS not in GRID_HEAD_DIMS:
        raise ValueError(f"head_dim {HS} is not one of the grid kernel's "
                         f"{GRID_HEAD_DIMS}")
    out = torch.empty((B, NH, HS), dtype=q.dtype, device=q.device)
    if B == 0 or NH == 0:
        return out
    _call(wrapper, "grid", q, k_pages, v_pages, scales, block_tables,
          lengths, starts, (out,), (B, NH, HS, ps, pps))
    return out


def _route(q):
    """'cpu' → plain version, 'cuda' → kernel; anything else raises."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no paged-attention route for device {q.device}")
    return q.device.type


# ---- public entry points ----------------------------------------------------

def paged_decode_attention_parts(q, k_pages, v_pages, block_tables, lengths,
                                 starts=None):
    """Flash-decode over a float/bf16 paged pool returning UNNORMALIZED
    parts (acc (B,NH,HS) f32, m (B,NH) f32, l (B,NH) f32).

    q: (B, NH, HS) f32/bf16; k_pages/v_pages: (P, NH, HS, ps) f32/bf16;
    block_tables: (B, pages_per_seq) int32; lengths: (B,) int32 valid
    tokens per row; starts: optional (B,) int32 window lower bound."""
    if starts is None:
        starts = torch.zeros_like(lengths)
    if _route(q) == "cpu":
        return paged_decode_attention_parts_ref(q, k_pages, v_pages,
                                                block_tables, lengths, starts)
    return _launch("paged_decode_attention_parts", False, q, k_pages,
                   v_pages, None, block_tables, lengths, starts)


def paged_decode_attention_quant_parts(q, k_pages, v_pages, k_scale, v_scale,
                                       block_tables, lengths, starts=None):
    """INT8-KV flash-decode parts: k_pages/v_pages int8 (P, NH, HS, ps),
    k_scale/v_scale f32 (P, NH, ps), folded in after the dots."""
    if starts is None:
        starts = torch.zeros_like(lengths)
    if _route(q) == "cpu":
        return paged_decode_attention_quant_parts_ref(
            q, k_pages, v_pages, k_scale, v_scale, block_tables, lengths,
            starts)
    return _launch("paged_decode_attention_quant_parts", False, q, k_pages,
                   v_pages, (k_scale, v_scale), block_tables, lengths,
                   starts)


def paged_decode_attention_parts_mq(q, k_pages, v_pages, block_tables,
                                    lengths, starts=None):
    """Multi-query flash-decode over a float/bf16 paged pool: q is
    (B, KQ, NH, HS), KQ query tokens per row that all attend the same
    committed range [starts, lengths) (no causal mask inside the pool),
    returning UNNORMALIZED parts (acc (B,KQ,NH,HS) f32, m/l (B,KQ,NH)
    f32). On the card one walk of the live range serves a tile of 4
    queries; any KQ is taken."""
    if starts is None:
        starts = torch.zeros_like(lengths)
    if _route(q) == "cpu":
        return paged_decode_attention_parts_mq_ref(
            q, k_pages, v_pages, block_tables, lengths, starts)
    return _launch("paged_decode_attention_parts_mq", True, q, k_pages,
                   v_pages, None, block_tables, lengths, starts)


def paged_decode_attention_quant_parts_mq(q, k_pages, v_pages, k_scale,
                                          v_scale, block_tables, lengths,
                                          starts=None):
    """INT8-KV multi-query parts (see paged_decode_attention_parts_mq);
    scales fold in after the dots, as in the single-query kernel."""
    if starts is None:
        starts = torch.zeros_like(lengths)
    if _route(q) == "cpu":
        return paged_decode_attention_quant_parts_mq_ref(
            q, k_pages, v_pages, k_scale, v_scale, block_tables, lengths,
            starts)
    return _launch("paged_decode_attention_quant_parts_mq", True, q,
                   k_pages, v_pages, (k_scale, v_scale), block_tables,
                   lengths, starts)


def paged_decode_attention_grid(q, k_pages, v_pages, block_tables, lengths,
                                starts=None):
    """NORMALIZED single-query attention over a float/bf16 paged pool
    (B, NH, HS) in q.dtype; a fully masked row gives zeros. On the card
    the grid kernel (``csrc/paged_attention_grid.cu``: the parts
    template's normalized instance, or a scalar kernel for page sizes
    that are not a multiple of 4 and unaligned pools) takes any page size
    and head_dim 64; on the CPU the plain version, which like the kernel
    (and the TPU's grid kernel) computes in f32 and rounds the result to
    q.dtype once."""
    if starts is None:
        starts = torch.zeros_like(lengths)
    if _route(q) == "cpu":
        return paged_decode_attention_grid_ref(q, k_pages, v_pages,
                                               block_tables, lengths, starts)
    return _launch_grid("paged_decode_attention_grid", q, k_pages, v_pages,
                        None, block_tables, lengths, starts)


def paged_decode_attention_quant_grid(q, k_pages, v_pages, k_scale, v_scale,
                                      block_tables, lengths, starts=None):
    """INT8-KV normalized attention (see paged_decode_attention_grid):
    k_scale/v_scale f32 (P, NH, ps); on the card the K scale multiplies
    each score after its dot and the V scale each p, where the plain
    version dequantizes the pool first."""
    if starts is None:
        starts = torch.zeros_like(lengths)
    if _route(q) == "cpu":
        return paged_decode_attention_quant_grid_ref(
            q, k_pages, v_pages, k_scale, v_scale, block_tables, lengths,
            starts)
    return _launch_grid("paged_decode_attention_quant_grid", q, k_pages,
                        v_pages, (k_scale, v_scale), block_tables, lengths,
                        starts)


def _normalize(acc, l, dtype):
    l = torch.where(l == 0.0, 1.0, l)
    return (acc / l[..., None]).to(dtype)


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths,
                           starts=None):
    """Normalized flash-decode over a float/bf16 pool: (B, NH, HS) in
    q.dtype; a fully masked row gives zeros. As in the JAX package, a page
    size that is not a multiple of 128 goes through the grid entry, and
    the others divide the single-query parts by l (l == 0 → 1)."""
    if k_pages.shape[3] % 128 != 0:
        return paged_decode_attention_grid(q, k_pages, v_pages, block_tables,
                                           lengths, starts)
    acc, _, l = paged_decode_attention_parts(q, k_pages, v_pages,
                                             block_tables, lengths, starts)
    return _normalize(acc, l, q.dtype)


def paged_decode_attention_quant(q, k_pages, v_pages, k_scale, v_scale,
                                 block_tables, lengths, starts=None):
    """Normalized INT8-KV flash-decode (see paged_decode_attention)."""
    if k_pages.shape[3] % 128 != 0:
        return paged_decode_attention_quant_grid(
            q, k_pages, v_pages, k_scale, v_scale, block_tables, lengths,
            starts)
    acc, _, l = paged_decode_attention_quant_parts(
        q, k_pages, v_pages, k_scale, v_scale, block_tables, lengths, starts)
    return _normalize(acc, l, q.dtype)
