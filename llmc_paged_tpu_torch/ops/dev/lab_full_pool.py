"""LAB ARTIFACT: the stacked-pool ("full-pool") kernel family, port of
llmc_paged_tpu/ops/dev/lab_full_pool.py.

Design record. The JAX package's round-1 layout kept the KV pool as ONE
stacked (L, P, NH, HS, ps) array carried through a ``lax.scan`` over
layers, the layer plane picked inside the Pallas kernel by a
scalar-prefetched index. On the TPU it measured 1.7-6x slower than
per-layer pools, because XLA copied the scan-carried pool on every
in-place update (the JAX module's docstring has the numbers), so the
serving path keeps per-layer pools and this family lives in the lab.

That reason does not carry over: in PyTorch a stacked tensor updates in
place, and a plane is a view. What the lab asks on Hopper is whether the
stacked layout itself costs anything: ``paged_decode_attention_full``
(``csrc/lab_full_pool.cu``) reads the layer index from device memory (the
TPU's scalar prefetch) and computes its plane offset in 64 bits, against
the port's grid kernel run on the view ``k_pool[layer]`` with a host
layer (the per-layer alternative), on the same tensors.

The stacked tensors are taken as they are; they are never wrapped in the
serving ``PagePool`` (its ``__init__`` does ``list(k)``, which would split
a 5-D tensor into per-layer views). Writes drop rows whose page is P (the
drop sentinel), as kv/layouts.py does.

Run: python -m llmc_paged_tpu_torch.ops.dev.lab_full_pool [--device cpu]
     [--iters N]
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from llmc_paged_tpu_torch.kv.layouts import _kept, quantize_pages
from llmc_paged_tpu_torch.ops._build import check_operand, entry, launch
from llmc_paged_tpu_torch.ops.dev.harness import parse_args, sweep
from llmc_paged_tpu_torch.ops.int8 import quantize_rows
from llmc_paged_tpu_torch.ops.paged_attention import (
    _KIND,
    GRID_HEAD_DIMS,
    _route,
    paged_decode_attention_grid,
    paged_decode_attention_grid_ref,
    paged_decode_attention_quant_grid,
    paged_decode_attention_quant_grid_ref,
    paged_decode_attention_quant_ref,
    paged_decode_attention_ref,
)

# launches of the CUDA kernel, by wrapper (plain ints; reset by callers)
LAUNCHES = {"paged_decode_attention_full": 0,
            "paged_decode_attention_quant_full": 0}


def pool_from_numpy(*arrays, device=None):
    """Stacked pool arrays as the JAX package holds them (numpy: (L, P, NH,
    HS, ps) K and V, and for int8 pools the (L, P, NH, ps) f32 scales) →
    contiguous tensors on ``device`` (the card by default), same layout."""
    from llmc_paged_tpu_torch import resolve_device
    dev = resolve_device(device)
    shapes = [np.shape(a) for a in arrays]
    kv = shapes[0] if shapes else ()
    want = [kv, kv] + [kv[:3] + kv[4:]] * (len(shapes) - 2)
    if len(kv) != 5 or len(shapes) not in (2, 4) or shapes != want:
        raise ValueError("want k, v (L, P, NH, HS, ps) [+ k_scale, v_scale "
                         f"(L, P, NH, ps)], got {shapes}")
    # copies: the port writes its pools in place
    return tuple(torch.from_numpy(np.array(a)).to(dev) for a in arrays)


# ---- stacked-pool writes ----------------------------------------------------

def _write_coords(k_pool, layer, page, slot):
    """(kept rows, layer, page, slot) indices of a stacked-pool write:
    rows whose page is P are left out, as kv/layouts.py does."""
    sel, pg = _kept(page, k_pool.shape[1], k_pool.device)
    sl = slot.reshape(-1).to(k_pool.device)[sel].long()
    lay = torch.as_tensor(layer, device=k_pool.device).reshape(-1).long()
    return sel, lay, pg, sl


def write_kv_full(k_pool, v_pool, layer, k_new, v_new, page, slot):
    """Scatter (N, NH, HS) rows into plane ``layer`` (a Python int or a
    one-element int32 tensor) of stacked (L, P, NH, HS, ps) K/V pools at
    (N,) page/slot coordinates; rows whose page is P are dropped. In
    place; returns the pools."""
    sel, lay, pg, sl = _write_coords(k_pool, layer, page, slot)
    NH, HS = k_new.shape[-2:]
    k_pool[lay, pg, :, :, sl] = k_new.reshape(-1, NH, HS)[sel].to(
        k_pool.dtype)
    v_pool[lay, pg, :, :, sl] = v_new.reshape(-1, NH, HS)[sel].to(
        v_pool.dtype)
    return k_pool, v_pool


def write_kv_quant_full(k_pool, v_pool, k_scale, v_scale, layer, k_new,
                        v_new, page, slot):
    """write_kv_full for int8 pools: the rows quantize per (token, head)
    with the port's quantize_rows, values into the int8 (L, P, NH, HS, ps)
    pools and scales into the (L, P, NH, ps) f32 scales. In place."""
    sel, lay, pg, sl = _write_coords(k_pool, layer, page, slot)
    NH, HS = k_new.shape[-2:]
    kq, ks = quantize_rows(k_new.reshape(-1, NH, HS)[sel])
    vq, vs = quantize_rows(v_new.reshape(-1, NH, HS)[sel])
    k_pool[lay, pg, :, :, sl] = kq
    v_pool[lay, pg, :, :, sl] = vq
    k_scale[lay, pg, :, sl] = ks
    v_scale[lay, pg, :, sl] = vs
    return k_pool, v_pool, k_scale, v_scale


# ---- plain versions ---------------------------------------------------------

def _plane(layer, L: int) -> int:
    """The plane index of ``layer`` (int or one-element tensor); raises
    outside [0, L)."""
    i = int(layer)
    if not 0 <= i < L:
        raise ValueError(f"layer {i} outside the pool's {L} planes")
    return i


def _live_tables(block_tables, P):
    """Table entries clamped to [0, P): the plain versions gather the
    whole table, and an entry past a row's live range may hold the
    sentinel P (its positions are masked, so the page read is immaterial;
    JAX's gather clamps the same way)."""
    return block_tables.clamp(0, P - 1)


def paged_decode_attention_full_xla(q, k_pool, v_pool, layer, block_tables,
                                    lengths, starts=None):
    """The JAX package's oracle: slice plane ``layer``, then the plain
    normalized attention over the gathered pool (its dtype semantics: a
    bf16 q over a bf16 pool computes in bf16)."""
    i = _plane(layer, k_pool.shape[0])
    return paged_decode_attention_ref(
        q, k_pool[i], v_pool[i], _live_tables(block_tables, k_pool.shape[1]),
        lengths, starts)


def paged_decode_attention_quant_full_xla(q, k_pool, v_pool, k_scale,
                                          v_scale, layer, block_tables,
                                          lengths, starts=None):
    """INT8 twin of paged_decode_attention_full_xla."""
    i = _plane(layer, k_pool.shape[0])
    return paged_decode_attention_quant_ref(
        q, k_pool[i], v_pool[i], k_scale[i], v_scale[i],
        _live_tables(block_tables, k_pool.shape[1]), lengths, starts)


def paged_decode_attention_full_ref(q, k_pool, v_pool, layer, block_tables,
                                    lengths, starts=None):
    """Plain version of the full-pool kernel: the attention computed in
    f32 and rounded once to q's dtype, i.e. the grid kernel's plain
    version on the plane (the TPU full-pool and grid kernels share their
    arithmetic)."""
    i = _plane(layer, k_pool.shape[0])
    return paged_decode_attention_grid_ref(
        q, k_pool[i], v_pool[i], _live_tables(block_tables, k_pool.shape[1]),
        lengths, starts)


def paged_decode_attention_quant_full_ref(q, k_pool, v_pool, k_scale,
                                          v_scale, layer, block_tables,
                                          lengths, starts=None):
    """Plain version of the int8 full-pool kernel (scales applied before
    the dots, f32, one rounding)."""
    i = _plane(layer, k_pool.shape[0])
    return paged_decode_attention_quant_grid_ref(
        q, k_pool[i], v_pool[i], k_scale[i], v_scale[i],
        _live_tables(block_tables, k_pool.shape[1]), lengths, starts)


# ---- the CUDA kernel --------------------------------------------------------

def _launch_full(wrapper, q, k_pool, v_pool, scales, layer, block_tables,
                 lengths, starts):
    """Validate, allocate the (B, NH, HS) output in q's dtype and launch
    ``csrc/lab_full_pool.cu``. A tensor layer stays on the card (the
    kernel reads it there); a Python int goes by value. Raises on anything
    the kernel does not take."""
    dev = q.device
    if q.dim() != 3 or k_pool.dim() != 5:
        raise ValueError("q must be (B, NH, HS) and the pools (L, P, NH, "
                         "HS, ps)")
    B, NH, HS = q.shape
    L, P, _, _, ps = k_pool.shape
    pps = block_tables.shape[-1]
    if HS not in GRID_HEAD_DIMS:
        raise ValueError(f"head_dim {HS} is not one of the kernel's "
                         f"{GRID_HEAD_DIMS}")
    kv_dtypes = ((torch.int8,) if scales is not None
                 else (torch.float32, torch.bfloat16))
    check_operand("q", q, (torch.float32, torch.bfloat16), q.shape, dev)
    check_operand("k_pool", k_pool, kv_dtypes, (L, P, NH, HS, ps), dev)
    check_operand("v_pool", v_pool, (k_pool.dtype,), k_pool.shape, dev)
    if scales is not None:
        for nm, s in zip(("k_scale", "v_scale"), scales):
            check_operand(nm, s, (torch.float32,), (L, P, NH, ps), dev)
    check_operand("block_tables", block_tables, (torch.int32,), (B, pps), dev)
    check_operand("lengths", lengths, (torch.int32,), (B,), dev)
    check_operand("starts", starts, (torch.int32,), (B,), dev)
    if torch.is_tensor(layer):
        check_operand("layer", layer, (torch.int32,), (1,), dev)
        layer_ptr, layer_host = layer.data_ptr(), 0
    else:
        layer_ptr, layer_host = None, _plane(layer, L)
    out = torch.empty((B, NH, HS), dtype=q.dtype, device=dev)
    if B == 0 or NH == 0:
        return out
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn = entry("lab_full_pool", "paged_decode_full",
               [i32, i32] + [ptr] * 6 + [i32] + [ptr] * 4 + [i32] * 7
               + [ctypes.c_float, ptr])
    ks, vs = scales if scales is not None else (None, None)
    launch(fn, dev, (
        _KIND[q.dtype], _KIND[k_pool.dtype], q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), ks.data_ptr() if ks is not None else None,
        vs.data_ptr() if vs is not None else None, layer_ptr, layer_host,
        block_tables.data_ptr(), lengths.data_ptr(), starts.data_ptr(),
        out.data_ptr(), B, L, P, NH, HS, ps, pps, 1.0 / math.sqrt(HS)),
        wrapper)
    LAUNCHES[wrapper] += 1
    return out


def paged_decode_attention_full(q, k_pool, v_pool, layer, block_tables,
                                lengths, starts=None):
    """Normalized single-query attention over plane ``layer`` of a stacked
    float/bf16 (L, P, NH, HS, ps) pool: (B, NH, HS) in q's dtype, zeros
    for a row with no valid token. ``layer``: a Python int or a (1,)
    int32 tensor on q's device (read by the kernel, never copied to the
    host). A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel (head_dim 64) or raises."""
    if starts is None:
        starts = torch.zeros_like(lengths)
    if _route(q) == "cpu":
        return paged_decode_attention_full_ref(q, k_pool, v_pool, layer,
                                               block_tables, lengths, starts)
    return _launch_full("paged_decode_attention_full", q, k_pool, v_pool,
                        None, layer, block_tables, lengths, starts)


def paged_decode_attention_quant_full(q, k_pool, v_pool, k_scale, v_scale,
                                      layer, block_tables, lengths,
                                      starts=None):
    """INT8 twin of paged_decode_attention_full: int8 (L, P, NH, HS, ps)
    pools with (L, P, NH, ps) f32 scales, applied before the dots."""
    if starts is None:
        starts = torch.zeros_like(lengths)
    if _route(q) == "cpu":
        return paged_decode_attention_quant_full_ref(
            q, k_pool, v_pool, k_scale, v_scale, layer, block_tables,
            lengths, starts)
    return _launch_full("paged_decode_attention_quant_full", q, k_pool,
                        v_pool, (k_scale, v_scale), layer, block_tables,
                        lengths, starts)


# ---- the sweep --------------------------------------------------------------

def make_args(B, NH, HS, L, P, ps, pps, kv, device):
    """q and a stacked pool of L planes; ragged lengths in [1, pps*ps],
    starts 0; table entries distinct pages where the pool has enough
    (else random, pages shared by rows). The layer is L-1 (the largest
    plane offset), as a host int and as a (1,) int32 tensor. "int8"
    quantizes the pool per token and sends q in bf16, as the int8
    headline engine does."""
    g = torch.Generator(device=device).manual_seed(0)
    q = torch.randn(B, NH, HS, generator=g, device=device)
    k = torch.randn(L, P, NH, HS, ps, generator=g, device=device)
    v = torch.randn(L, P, NH, HS, ps, generator=g, device=device)
    if B * pps <= P:
        tables = torch.randperm(P, generator=g, device=device)[: B * pps]
    else:
        tables = torch.randint(0, P, (B * pps,), generator=g, device=device)
    tables = tables.reshape(B, pps).to(torch.int32)
    lengths = torch.randint(1, pps * ps + 1, (B,), generator=g,
                            device=device, dtype=torch.int32)
    starts = torch.zeros_like(lengths)
    layer = L - 1
    layer_t = torch.tensor([layer], dtype=torch.int32, device=device)
    scales = None
    if kv == "int8":
        (k, ks), (v, vs) = quantize_pages(k), quantize_pages(v)
        q, scales = q.bfloat16(), (ks, vs)
    return q, k, v, scales, layer, layer_t, tables, lengths, starts


def _full_ref(q, k, v, scales, layer, layer_t, tables, lengths, starts):
    if scales is None:
        return paged_decode_attention_full_ref(q, k, v, layer, tables,
                                               lengths, starts)
    return paged_decode_attention_quant_full_ref(q, k, v, *scales, layer,
                                                 tables, lengths, starts)


def _grid_on_plane(q, k, v, scales, layer, layer_t, tables, lengths, starts):
    if scales is None:
        return paged_decode_attention_grid(q, k[layer], v[layer], tables,
                                           lengths, starts)
    return paged_decode_attention_quant_grid(
        q, k[layer], v[layer], scales[0][layer], scales[1][layer], tables,
        lengths, starts)


def _full(q, k, v, scales, layer, layer_t, tables, lengths, starts):
    if scales is None:
        return paged_decode_attention_full(q, k, v, layer_t, tables, lengths,
                                           starts)
    return paged_decode_attention_quant_full(q, k, v, *scales, layer_t,
                                             tables, lengths, starts)


# f32 outputs within 1e-5 abs + 1e-5 rel (f32 sums in another order); bf16
# outputs within one bf16 ulp plus 1e-6 (both round an f32 result once)
_TOL = {"rtol": 1e-5, "atol": 1e-5, "bf16_ulp": True}
VERSIONS = {
    "v0_gather_ref (naive)": _full_ref,
    "v1_cuda_grid_on_plane": (_grid_on_plane, _TOL),
    "v2_cuda_full_pool": (_full, _TOL),
}


def kv_bytes(B, NH, HS, L, P, ps, pps, kv):
    """K and V of every table entry of one plane (an upper bound: the
    live tokens of the ragged rows are fewer)."""
    return 2 * B * NH * pps * ps * HS * (1 if kv == "int8" else 4)


CONFIGS = [
    # the GPT-2 124M decode shape over a 12-layer pool, f32 and int8 (bf16
    # q); the CLI's page size (ps 32, 32 pages a row, 128 pages); the 1.5B
    # head count and depth, int8
    (8, 12, 64, 12, 28, 128, 3, "f32"),
    (8, 12, 64, 12, 28, 128, 3, "int8"),
    (8, 12, 64, 12, 128, 32, 32, "f32"),
    (8, 12, 64, 12, 128, 32, 32, "int8"),
    (8, 25, 64, 48, 28, 128, 3, "int8"),
]


def main(argv=None):
    a = parse_args(argv)
    return sweep(VERSIONS, make_args, CONFIGS,
                 ref_name="v0_gather_ref (naive)", bytes_fn=kv_bytes,
                 iters=a.iters, device=a.device)


if __name__ == "__main__":
    main()
