"""L3 device side: the KV page pool as per-layer tensors (port of
llmc_paged_tpu/kv/layouts.py).

One K and one V buffer per layer, each (num_pages, NH, HS, page_size):
page-major and token-minor, the JAX package's layout, kept so that the
kernel, the converters and the cross-package tests compare like with
like. INT8 pools add per-(page, head, token) f32 scales (P, NH, ps).

Writes are addressed by (page, slot) coordinates from the host block
tables; a row whose page is ``num_pages`` (the drop sentinel) is left
out. Torch has no scatter ``mode="drop"``: the sentinel rows are
filtered out before each indexed write (on the CPU the write would raise
and on the card it would land out of bounds). Coordinates built on the
host (as the engine builds them) filter on the host and go up through
pinned memory without blocking (``to_device``): no device sync.
Coordinates built on the device (the speculative commit) hold no
sentinel and pass ``sentinel=False``: nothing is filtered, so the write
costs no sync either.

Pool updates happen IN PLACE (the JAX package donates the pool and gets a
new one back); the functions also return the updated tensors so call
sites read like their JAX counterparts.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from llmc_paged_tpu_torch import resolve_device
from llmc_paged_tpu_torch.config import GPT2Config, PageConfig
from llmc_paged_tpu_torch.ops.int8 import quantize_rows

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}


class PagePool:
    """Per-layer float K/V page buffers: ``k``/``v`` are length-L lists of
    (P, NH, HS, page_size) tensors."""

    quant = False

    def __init__(self, k: List[torch.Tensor], v: List[torch.Tensor]):
        self.k, self.v = list(k), list(v)

    @property
    def num_layers(self) -> int:
        return len(self.k)

    @property
    def num_pages(self) -> int:
        return self.k[0].shape[0]

    @property
    def page_size(self) -> int:
        return self.k[0].shape[3]

    def layer(self, i: int) -> Tuple[torch.Tensor, ...]:
        return (self.k[i], self.v[i])


class QuantPagePool(PagePool):
    """INT8 K/V pages (P, NH, HS, ps) with f32 scales (P, NH, ps) per
    layer."""

    quant = True

    def __init__(self, k, v, k_scale, v_scale):
        super().__init__(k, v)
        self.k_scale, self.v_scale = list(k_scale), list(v_scale)

    def layer(self, i: int) -> Tuple[torch.Tensor, ...]:
        return (self.k[i], self.v[i], self.k_scale[i], self.v_scale[i])


def init_pool(cfg: GPT2Config, page: PageConfig, dtype="float32",
              device=None) -> PagePool:
    """Zeroed pool for ``cfg`` and ``page`` (scales start at 1.0), on
    ``device`` (None: the card, raising without one)."""
    device = resolve_device(device)
    dtype = _DTYPES.get(dtype, dtype)
    L = cfg.num_layers
    shape = (page.num_pages, cfg.num_heads, cfg.head_dim, page.page_size)

    def zeros(dt):
        return [torch.zeros(shape, dtype=dt, device=device) for _ in range(L)]

    if dtype == torch.int8:
        sshape = (page.num_pages, cfg.num_heads, page.page_size)
        return QuantPagePool(
            zeros(torch.int8), zeros(torch.int8),
            [torch.ones(sshape, device=device) for _ in range(L)],
            [torch.ones(sshape, device=device) for _ in range(L)])
    return PagePool(zeros(dtype), zeros(dtype))


def to_device(t, dev) -> torch.Tensor:
    """``t`` on ``dev`` without blocking the host: a CPU tensor bound for
    the card is staged in pinned memory and copied asynchronously (a copy
    from pageable memory waits for the stream to drain)."""
    t = torch.as_tensor(t)
    if t.device.type == "cpu" and torch.device(dev).type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def _kept(pages: torch.Tensor, num_pages: int, device):
    """(row indices, page ids) of the rows whose page is a real page,
    flattened, on ``device`` — the drop-sentinel rows left out."""
    flat = pages.reshape(-1)
    sel = torch.nonzero((flat >= 0) & (flat < num_pages)).squeeze(1)
    return to_device(sel, device), to_device(flat[sel].long(), device)


def token_coords(block_tables: torch.Tensor, positions: torch.Tensor,
                 page_size: int, valid: torch.Tensor,
                 num_pages: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map per-token positions (B, ...) to pool (page, slot) coordinates;
    page == num_pages where invalid or beyond the table (dropped, not
    clipped)."""
    B, pps = block_tables.shape
    page_idx = torch.div(positions, page_size, rounding_mode="floor")
    in_range = (page_idx >= 0) & (page_idx < pps)
    safe_idx = page_idx.clamp(0, pps - 1).reshape(B, -1).long()
    page = torch.gather(block_tables, 1, safe_idx).reshape(positions.shape)
    slot = torch.remainder(positions, page_size)
    page = torch.where(valid & in_range, page,
                       torch.full_like(page, num_pages))
    return page.int(), slot.int()


def prompt_page_ids(page: torch.Tensor, T: int, ps: int,
                    num_pages: int) -> torch.Tensor:
    """Per-PAGE pool ids from prefill's per-token page coordinates: page
    (B, T) → (B, ceil(T/ps)), sentinel where a page-chunk starts beyond T
    or on an invalid token."""
    n = -(-T // ps)
    cols = [page[:, j * ps] if j * ps < T
            else torch.full_like(page[:, 0], num_pages) for j in range(n)]
    return torch.stack(cols, dim=1)


def _page_blocks(k: torch.Tensor, ps: int) -> torch.Tensor:
    """(B, Tp, NH, HS) token rows → (B*(Tp/ps), NH, HS, ps) page blocks."""
    B, Tp, NH, HS = k.shape
    n = Tp // ps
    return (k.reshape(B, n, ps, NH, HS).permute(0, 1, 3, 4, 2)
            .reshape(B * n, NH, HS, ps))


def _scale_blocks(s: torch.Tensor, ps: int) -> torch.Tensor:
    """(B, Tp, NH) per-token scales → (B*(Tp/ps), NH, ps)."""
    B, Tp, NH = s.shape
    n = Tp // ps
    return s.reshape(B, n, ps, NH).permute(0, 1, 3, 2).reshape(B * n, NH, ps)


def write_prompt_pages(k_pool_l, v_pool_l, k, v, page_ids):
    """Whole-page prefill writes: k/v (B, Tp, NH, HS), Tp a multiple of ps;
    page_ids (B, Tp/ps) (sentinel = num_pages). Prompt pages are freshly
    allocated, so whole-page overwrite is safe. In place."""
    ps = k_pool_l.shape[3]
    sel, ids = _kept(page_ids, k_pool_l.shape[0], k_pool_l.device)
    k_pool_l[ids] = _page_blocks(k, ps)[sel].to(k_pool_l.dtype)
    v_pool_l[ids] = _page_blocks(v, ps)[sel].to(v_pool_l.dtype)
    return k_pool_l, v_pool_l


def write_prompt_pages_quant(pool_l, k, v, page_ids):
    """INT8 twin of write_prompt_pages (per-token quantization). In place."""
    k_l, v_l, ks_l, vs_l = pool_l
    ps = k_l.shape[3]
    sel, ids = _kept(page_ids, k_l.shape[0], k_l.device)
    kq, ks = quantize_rows(k)           # (B, Tp, NH) scales
    vq, vs = quantize_rows(v)
    k_l[ids] = _page_blocks(kq, ps)[sel]
    v_l[ids] = _page_blocks(vq, ps)[sel]
    ks_l[ids] = _scale_blocks(ks, ps)[sel]
    vs_l[ids] = _scale_blocks(vs, ps)[sel]
    return pool_l


def _rows(page, slot, num_pages, device, sentinel):
    """(row selection, page ids, slots) of an indexed write. With
    ``sentinel=False`` every coordinate is a real page: all rows are kept
    and nothing is read back from the device."""
    if sentinel:
        sel, pg = _kept(page, num_pages, device)
        return sel, pg, to_device(slot.reshape(-1), device)[sel].long()
    return (slice(None), to_device(page.reshape(-1), device).long(),
            to_device(slot.reshape(-1), device).long())


def write_layer_kv(k_pool_l, v_pool_l, k_new, v_new, page, slot,
                   sentinel=True):
    """Scatter new K/V rows (N, NH, HS) into one layer's pool at (N,)
    page/slot coordinates; sentinel rows are dropped. In place."""
    sel, pg, sl = _rows(page, slot, k_pool_l.shape[0], k_pool_l.device,
                        sentinel)
    k_pool_l[pg, :, :, sl] = k_new.reshape(-1, *k_new.shape[-2:])[sel].to(
        k_pool_l.dtype)
    v_pool_l[pg, :, :, sl] = v_new.reshape(-1, *v_new.shape[-2:])[sel].to(
        v_pool_l.dtype)
    return k_pool_l, v_pool_l


def write_layer_kv_quant(pool_l, k_new, v_new, page, slot, sentinel=True):
    """Quantize-and-scatter twin of write_layer_kv for an INT8 layer
    (k, v, k_scale, v_scale). In place."""
    k_l, v_l, ks_l, vs_l = pool_l
    sel, pg, sl = _rows(page, slot, k_l.shape[0], k_l.device, sentinel)
    NH, HS = k_new.shape[-2:]
    kq, ks = quantize_rows(k_new.reshape(-1, NH, HS)[sel])
    vq, vs = quantize_rows(v_new.reshape(-1, NH, HS)[sel])
    k_l[pg, :, :, sl] = kq
    v_l[pg, :, :, sl] = vq
    ks_l[pg, :, sl] = ks
    vs_l[pg, :, sl] = vs
    return pool_l


def commit_layer_kv(k_pool_l, v_pool_l, tails_k, tails_v, pages, slots,
                    sentinel=True):
    """Chunk commit of (K, B, NH, HS) tail K/V into one layer's float pool
    at (K, B) coordinates, as one direct indexed write (the JAX package's
    one-hot page blend exists only for XLA:TPU layouts; the values that
    land are the same). In place."""
    return write_layer_kv(k_pool_l, v_pool_l, tails_k, tails_v, pages, slots,
                          sentinel)


def commit_layer_kv_quant(pool_l, tails_k, tails_v, pages, slots,
                          sentinel=True):
    """INT8 twin of commit_layer_kv: per-token quantization (the formula
    of write_layer_kv_quant), then indexed writes of values and scales.
    In place."""
    return write_layer_kv_quant(pool_l, tails_k, tails_v, pages, slots,
                                sentinel)


def quantize_pages(k_pages: torch.Tensor):
    """Quantize a float (P, NH, HS, ps) page buffer per TOKEN (reducing
    over HS). Returns (int8 pages, scales (P, NH, ps))."""
    kq, ks = quantize_rows(k_pages.transpose(-1, -2))
    return kq.transpose(-1, -2).contiguous(), ks


def dequant_layer(k_l: torch.Tensor, ks_l: torch.Tensor) -> torch.Tensor:
    """(P, NH, HS, ps) int8 + (P, NH, ps) scales → f32."""
    return k_l.float() * ks_l[:, :, None, :]


def gather_layer_kv(k_pool_l, v_pool_l, block_tables):
    """Block tables → contiguous (B, NH, pages_per_seq*ps, HS) K/V: the
    copy the kernel avoids; used by the plain versions."""
    B, pps = block_tables.shape
    P, NH, HS, ps = k_pool_l.shape
    idx = block_tables.long()
    k = k_pool_l[idx].permute(0, 2, 1, 4, 3).reshape(B, NH, pps * ps, HS)
    v = v_pool_l[idx].permute(0, 2, 1, 4, 3).reshape(B, NH, pps * ps, HS)
    return k, v
