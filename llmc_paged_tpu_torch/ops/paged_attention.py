"""Paged flash-decode attention: the hand-written CUDA kernel and its plain
PyTorch versions (port of llmc_paged_tpu/ops/paged_attention.py, the
single-query parts path).

The kernel (``csrc/paged_attention.cu``) computes the JAX package's PARTS
contract: for each row, single-query attention over the row's live pages
[start//ps, (len-1)//ps] read through the block table, positions outside
[start, len) masked, returning UNNORMALIZED online-softmax parts
(acc (B,NH,HS) f32, m (B,NH) f32, l (B,NH) f32). The decode chunk merges
them with its in-flight tail; the normalized wrappers divide by l.

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
from llmc_paged_tpu_torch.ops import layers as L

NEG_INF = -1e30

# launches of the CUDA kernel, by wrapper (plain ints; reset by callers)
LAUNCHES = {"paged_decode_attention_parts": 0,
            "paged_decode_attention_quant_parts": 0}

_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}  # the .cu enum
_MAX_SMEM = 48 * 1024


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


# ---- the CUDA kernel --------------------------------------------------------

def _kernel_fn():
    from llmc_paged_tpu_torch.ops import _build

    fn = _build.load("paged_attention").flash_decode_parts
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([i32, i32] + [ptr] * 11 + [i32] * 5
                       + [ctypes.c_float, ptr])
        fn.restype = i32
    return fn


def _check(name, t, dtypes, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q on {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} dtype {t.dtype} not in {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(wrapper, q, k_pages, v_pages, scales, block_tables, lengths,
            starts):
    """Validate, allocate the outputs and launch the kernel on the current
    stream. Raises on anything the kernel does not take."""
    dev = q.device
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError("q must be (B, NH, HS) and pages (P, NH, HS, ps)")
    B, NH, HS = q.shape
    P, _, _, ps = k_pages.shape
    pps = block_tables.shape[-1]
    quant = scales is not None
    kv_dtypes = (torch.int8,) if quant else (torch.float32, torch.bfloat16)
    _check("q", q, (torch.float32, torch.bfloat16), (B, NH, HS), dev)
    _check("k_pages", k_pages, kv_dtypes, (P, NH, HS, ps), dev)
    _check("v_pages", v_pages, (k_pages.dtype,), (P, NH, HS, ps), dev)
    _check("block_tables", block_tables, (torch.int32,), (B, pps), dev)
    _check("lengths", lengths, (torch.int32,), (B,), dev)
    _check("starts", starts, (torch.int32,), (B,), dev)
    if quant:
        for nm, s in zip(("k_scale", "v_scale"), scales):
            _check(nm, s, (torch.float32,), (P, NH, ps), dev)
    if 4 * (2 * HS + ps + 4) > _MAX_SMEM:
        raise ValueError(f"page_size {ps} / head_dim {HS} exceed the "
                         "kernel's shared memory")
    acc = torch.empty((B, NH, HS), dtype=torch.float32, device=dev)
    m = torch.empty((B, NH), dtype=torch.float32, device=dev)
    l = torch.empty((B, NH), dtype=torch.float32, device=dev)
    if B == 0 or NH == 0:
        return acc, m, l
    ks, vs = scales if quant else (None, None)
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(_KIND[q.dtype], _KIND[k_pages.dtype], q.data_ptr(),
                k_pages.data_ptr(), v_pages.data_ptr(),
                ks.data_ptr() if quant else None,
                vs.data_ptr() if quant else None,
                block_tables.data_ptr(), lengths.data_ptr(),
                starts.data_ptr(), acc.data_ptr(), m.data_ptr(),
                l.data_ptr(), B, NH, HS, ps, pps,
                1.0 / math.sqrt(HS), stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode_parts launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES[wrapper] += 1
    return acc, m, l


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
    return _launch("paged_decode_attention_parts", q, k_pages, v_pages, None,
                   block_tables, lengths, starts)


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
    return _launch("paged_decode_attention_quant_parts", q, k_pages, v_pages,
                   (k_scale, v_scale), block_tables, lengths, starts)


def _normalize(acc, l, dtype):
    l = torch.where(l == 0.0, 1.0, l)
    return (acc / l[..., None]).to(dtype)


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths,
                           starts=None):
    """Normalized flash-decode over a float/bf16 pool: (B, NH, HS) in
    q.dtype; a fully masked row gives zeros (l == 0 → 1)."""
    acc, _, l = paged_decode_attention_parts(q, k_pages, v_pages,
                                             block_tables, lengths, starts)
    return _normalize(acc, l, q.dtype)


def paged_decode_attention_quant(q, k_pages, v_pages, k_scale, v_scale,
                                 block_tables, lengths, starts=None):
    """Normalized INT8-KV flash-decode (see paged_decode_attention)."""
    acc, _, l = paged_decode_attention_quant_parts(
        q, k_pages, v_pages, k_scale, v_scale, block_tables, lengths, starts)
    return _normalize(acc, l, q.dtype)
