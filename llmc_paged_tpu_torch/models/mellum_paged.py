"""L2+L3: Mellum 2 over the paged KV pool: the engine's three device
entries for this family (``prefill_paged``, ``decode_chunk_paged``,
``decode_step_paged``), its pool and its model pieces.

Two kinds of cache side by side (``MellumPool``):

  * full layers keep every position in pages of the managed pool: the
    block manager's pages and block tables, as GPT-2's layers do;
  * sliding layers attend only the last ``sliding_window`` (W) positions,
    so each holds a fixed ring of R = ceil(W / ps) + 1 pages a row, the
    fewest that hold every position a read can reach (a read of W - 1
    committed tokens spans at most R pages). Row s's logical page j lives
    at ring page s*R + (j mod R); the ring's block table and coordinates
    are derived from the row and its positions, never from the manager.
    A prompt writes only its last R pages (the ones its first decode
    step can still reach: earlier ones would collide in the ring, and a
    scatter with duplicate targets has no defined winner), and a decode
    link commits its tokens over the ring pages whose positions have
    slid out.

Decode attention runs through the shared chain of
``gpt2_paged.decode_chunk_paged`` with this module's ``MODEL``: the
query heads of a K/V head go in as the multi-query parts kernel's query
tile (q (B, 32, 128) as (B, 8, 4, 128)), so a page is read once a tile
and not once a query head; each layer reads its own lower bound
(pos + 1 - W on sliding layers, 0 on full ones) and block table.

The prompt's attention is PyTorch's scaled_dot_product_attention, exact
and bounded in memory: causal over the whole prompt on full layers (and
on sliding layers up to W tokens), and on longer sliding layers in query
blocks of W against their keys [block start - W + 1, block end) under a
band mask. A wave is run in groups of rows of at most
``PREFILL_TOKENS`` padded tokens, each padded only to its own longest
row, and the expert products take the real tokens only.

Routing is counted on the device: ``pool.moe_counts`` (L, E) int64 adds
the rows routed to each expert in every prefill (real tokens) and every
decode step (every row of the step); the engine reads it once a run.
"""

from __future__ import annotations

import sys
import types
from typing import List

import torch
import torch.nn.functional as F

from llmc_paged_tpu_torch import resolve_device
from llmc_paged_tpu_torch.config import MellumConfig, PageConfig
from llmc_paged_tpu_torch.kv.layouts import (
    init_pool as init_page_pool,
    prompt_page_ids,
    to_device,
    write_layer_kv,
    write_layer_kv_quant,
)
from llmc_paged_tpu_torch.models import gpt2_paged, mellum
from llmc_paged_tpu_torch.ops.paged_attention import (
    paged_decode_attention_parts_mq,
    paged_decode_attention_parts_mq_ref,
    paged_decode_attention_quant_parts_mq,
    paged_decode_attention_quant_parts_mq_ref,
)

# padded tokens a group of a prefill wave holds at most
PREFILL_TOKENS = 32768
# the band masks of _band_bias, by (W, G, dtype, device)
_BAND = {}


def ring_pages(window: int, ps: int) -> int:
    """R: ring pages a row of a sliding layer."""
    return -(-window // ps) + 1


class MellumPool:
    """The full layers' pages (``full``: a PagePool of the managed pages,
    one tensor a full layer) and the sliding layers' rings (``ring``: a
    PagePool of max_seqs * R pages, one tensor a sliding layer), with the
    (L, E) routing counter. ``layer(i)`` is layer i's tensors, in
    whichever pool holds them; ``num_pages`` and ``page_size`` are the
    managed pool's (the engine's page coordinates and drop sentinel)."""

    def __init__(self, cfg: MellumConfig, full, ring, R: int,
                 moe_counts: torch.Tensor):
        self.full, self.ring, self.R = full, ring, R
        self.kinds = tuple(cfg.sliding(i) for i in range(cfg.num_layers))
        nf = ns = 0
        self._where = []
        for s in self.kinds:
            self._where.append((ring, ns) if s else (full, nf))
            ns, nf = ns + s, nf + (not s)
        self.moe_counts = moe_counts
        self._tables = {}

    @property
    def quant(self) -> bool:
        return self.full.quant

    @property
    def num_pages(self) -> int:
        return self.full.num_pages

    @property
    def page_size(self) -> int:
        return self.full.page_size

    def sliding(self, i: int) -> bool:
        return self.kinds[i]

    def layer(self, i: int):
        pool, j = self._where[i]
        return pool.layer(j)

    def ring_table(self, B: int, pps: int, device) -> torch.Tensor:
        """(B, pps) int32: row b's logical page j at ring page
        b*R + (j mod R). Made once a shape, on the device, and kept (a
        graph of the chained step reads it)."""
        key = (B, pps, str(device))
        t = self._tables.get(key)
        if t is None:
            b = torch.arange(B, device=device, dtype=torch.int32)[:, None]
            j = torch.arange(pps, device=device, dtype=torch.int32)[None, :]
            t = self._tables[key] = b * self.R + j % self.R
        return t

    def ring_coords(self, rows, positions, valid):
        """Ring (page, slot) of tokens at ``positions`` of ``rows`` (same
        shapes, on the host or the device), the ring's drop sentinel
        where not ``valid``."""
        ps = self.page_size
        pos = positions.clamp(min=0)
        page = rows * self.R + torch.div(pos, ps, rounding_mode="floor") \
            % self.R
        page = torch.where(valid, page, self.ring.num_pages)
        return page.int(), torch.remainder(pos, ps).int()


def init_pool(cfg: MellumConfig, page: PageConfig, dtype="float32",
              device=None, max_seqs: int = None) -> MellumPool:
    """Zeroed pools: the full layers' ``page.num_pages`` pages and the
    sliding layers' rings for ``max_seqs`` rows (default
    page.max_seqs)."""
    device = resolve_device(device)
    R = ring_pages(cfg.sliding_window, page.page_size)
    rows = max_seqs or page.max_seqs
    nfull = sum(1 for i in range(cfg.num_layers) if not cfg.sliding(i))
    shape = types.SimpleNamespace(num_heads=cfg.num_kv_heads,
                                  head_dim=cfg.head_dim)

    def make(n_layers, n_pages):
        c = types.SimpleNamespace(num_layers=n_layers, **vars(shape))
        return init_page_pool(c, PageConfig(
            page_size=page.page_size, num_pages=n_pages), dtype=dtype,
            device=device)

    return MellumPool(cfg, make(nfull, page.num_pages),
                      make(cfg.num_layers - nfull, rows * R), R,
                      torch.zeros((cfg.num_layers, cfg.num_experts),
                                  dtype=torch.int64, device=device))


# ---- the model pieces of the shared chain -----------------------------------

class MellumModel(gpt2_paged.SingleDevice):
    """Mellum's pieces of the chained decode step (the ``chain_*`` of
    ``gpt2_paged.SingleDevice``): K/V heads in the tails, rope at the
    step's positions, a lower bound and a block table a layer kind, the
    grouped query layout, the expert layer; sliding layers commit to
    their ring. The rope frequencies are kept a (config, device), made
    before any graph captures them. To the engine it is the family: the
    paged mode alone, with float weights (bf16 on the card)."""

    graphs = True
    entries = sys.modules[__name__]

    def __init__(self):
        self._rope = {}

    @staticmethod
    def refuse(econf, device, window=None) -> None:
        off = [name for name, on in (
            (f"cache_mode {econf.cache_mode!r}", econf.cache_mode != "paged"),
            ("spec_k", econf.spec_k >= 2),
            ("prefix_cache", econf.page.prefix_cache),
            ("mesh_shape", bool(econf.mesh_shape)),
            (f"param_dtype {econf.param_dtype!r}",
             econf.param_dtype not in ("float32", "bfloat16")),
            ("prefill_param_dtype",
             econf.prefill_param_dtype is not None)) if on]
        if off:
            raise ValueError(
                f"the Mellum family is served in paged mode with float "
                f"weights only: {', '.join(off)} is not supported")
        if (torch.device("cuda" if device is None else device).type == "cuda"
                and econf.param_dtype != "bfloat16"):
            raise ValueError(
                "the Mellum family is served in bfloat16 on the card (its "
                "grouped expert products take bf16), got param_dtype "
                f"{econf.param_dtype!r}")
        if window is not None:
            raise ValueError("run(window=...) is not supported for the "
                             "Mellum family: its sliding layers have their "
                             "own window, its full layers keep every page")

    def new_pool(self, cfg, page, dtype, device, max_seqs: int):
        return init_pool(cfg, page, dtype=dtype, device=device,
                         max_seqs=max_seqs)

    @staticmethod
    def start_run(pool) -> None:
        pool.moe_counts.zero_()

    @staticmethod
    def run_stats(pool, peak_pages: int) -> dict:
        """The ring pages a sliding layer holds, the peak of the managed
        (full-layer) pages, the rows routed to each expert of each layer
        (one read of the device counter)."""
        return {"kv_window_pages": pool.ring.num_pages,
                "kv_full_pages_peak": peak_pages,
                "moe_routed_tokens": pool.moe_counts.cpu().tolist()}

    def kv_heads(self, cfg) -> int:
        return cfg.num_kv_heads

    @staticmethod
    def compute_dtype(params) -> torch.dtype:
        return params["embed"].dtype

    @staticmethod
    def layer_stack(params):
        return mellum.layer_stack(params)

    def rope(self, cfg, device):
        key = (cfg, str(device))
        r = self._rope.get(key)
        if r is None:
            r = self._rope[key] = mellum.rope_tables(cfg, device)
        return r

    def chain_inputs(self, params, toks, pos, window: int, cfg, pool):
        """The embedding at ``toks`` and the step's context: cos and sin
        of each rope group at ``pos``, the sliding layers' lower bound
        pos + 1 - W (0 on full layers), the routing counter."""
        tables = self.rope(cfg, toks.device)
        starts = torch.clamp(pos + 1 - cfg.sliding_window, min=0)
        ctx = types.SimpleNamespace(
            rope={k: mellum.cos_sin(t, pos) for k, t in tables.items()},
            starts=starts, zeros=torch.zeros_like(starts),
            counts=pool.moe_counts)
        return params["embed"][toks.long()].float(), ctx

    @staticmethod
    def chain_read(ctx, tables, pool, i: int):
        """A sliding layer reads its ring from pos + 1 - W, a full layer
        the managed pages from 0."""
        if pool.sliding(i):
            return pool.ring_table(*tables.shape, tables.device), ctx.starts
        return tables, ctx.zeros

    def chain_block(self, x, stack, i: int, cfg, attend, ctx):
        cos, sin = ctx.rope["sliding" if cfg.sliding(i) else "full"]
        return block(x, mellum.layer(stack, i), cfg, cos, sin,
                     lambda q, k, v: grouped_out(attend(
                         grouped_in(q, cfg), k, v), cfg),
                     ctx.counts[i])

    @staticmethod
    def logits(x, params, cfg):
        return mellum.logits(x, params, cfg)

    @staticmethod
    def step_counters(pool):
        """The routing counter: a graph's warm-up steps leave it as it
        was, so it counts the steps served."""
        return (pool.moe_counts,)

    @staticmethod
    def commit_coords(pool, pages, slots, positions0, K: int):
        """Full layers commit at the reserved (pages, slots); sliding ones
        at the ring coordinates of positions0 + k, k < K (rows with
        positions0 < 0 are left out)."""
        pos0 = torch.as_tensor(positions0)
        B = pos0.shape[0]
        ar = torch.arange(K, device=pos0.device)[:, None]
        rows = torch.arange(B, device=pos0.device)[None, :].expand(K, B)
        rp, rs = pool.ring_coords(rows, pos0[None, :] + ar,
                                  (pos0 >= 0)[None, :].expand(K, B))
        return lambda i: (rp, rs) if pool.sliding(i) else (pages, slots)


MODEL = MellumModel()


def grouped_in(q: torch.Tensor, cfg: MellumConfig) -> torch.Tensor:
    """q (..., NH, HD) → (..., G, NKV, HD): query head h = kv * G + g
    (HF's repeat_kv) goes to row g of K/V head kv."""
    lead = q.shape[:-2]
    return q.reshape(*lead, cfg.num_kv_heads, cfg.group,
                     cfg.head_dim).transpose(-3, -2)


def grouped_out(att: torch.Tensor, cfg: MellumConfig) -> torch.Tensor:
    """(..., G, NKV, HD) → (..., NH * HD), query heads in HF's order."""
    lead = att.shape[:-3]
    return att.transpose(-3, -2).reshape(*lead, cfg.num_heads * cfg.head_dim)


def block(x, lp, cfg: MellumConfig, cos, sin, attend, counts=None):
    """One layer over the f32 residual x (..., C): ``attend(q, k, v)``
    takes the rotated heads (q (..., NH, HD), k and v (..., NKV, HD)),
    owns any pool writes and returns (..., NH * HD)."""
    q, k, v = mellum.qkv(x, lp, cfg)
    q, k = mellum.apply_rope(q, cos, sin), mellum.apply_rope(k, cos, sin)
    h = x + F.linear(attend(q, k, v), lp["wo"])
    y = mellum.rms_norm(h, lp["mlp_norm"], cfg.rms_eps, torch.float32)
    return h + mellum.moe(y.reshape(-1, cfg.channels), lp, cfg,
                          counts).view(h.shape)


# ---- the device entries -----------------------------------------------------

def _dev(params) -> torch.device:
    return params["embed"].device


@torch.no_grad()
def decode_chunk_paged(params, first_tokens, positions0, pages, slots,
                       block_tables, pool: MellumPool, cfg: MellumConfig,
                       num_steps: int, window: int, use_kernel: bool = True,
                       model=MODEL, **kw):
    """K = num_steps chained decode steps: ``gpt2_paged.decode_chunk_paged``
    (its arguments and returns) over Mellum's pool with ``MODEL``.
    ``window`` is the engine's and is not read: each layer's is its
    kind's."""
    return gpt2_paged.decode_chunk_paged(
        params, first_tokens, positions0, pages, slots, block_tables, pool,
        cfg, num_steps, window, use_kernel=use_kernel, model=model, **kw)


def _normalized_parts(q, pool_l, tables, lengths, starts, use_kernel, quant):
    """Normalized attention of grouped queries (B, G, NKV, HD) over the
    pool's [starts, lengths) through the multi-query parts (l == 0 → 1)."""
    if use_kernel:
        fn = (paged_decode_attention_quant_parts_mq if quant
              else paged_decode_attention_parts_mq)
    else:
        fn = (paged_decode_attention_quant_parts_mq_ref if quant
              else paged_decode_attention_parts_mq_ref)
    acc, _, l = fn(q.contiguous(), *pool_l, tables, lengths, starts)
    return (acc / torch.where(l == 0.0, 1.0, l)[..., None]).to(q.dtype)


@torch.no_grad()
def decode_step_paged(params, tokens, positions, page, slot, block_tables,
                      lengths, pool: MellumPool, cfg: MellumConfig,
                      use_kernel: bool = True, starts=None, model=MODEL):
    """One decode step that writes the new token's K/V into the pool (the
    full layers at page/slot, the sliding layers into their ring) and
    then attends through the multi-query parts, normalized.

    tokens (B,); positions (B,) their positions; page/slot (B,) the full
    layers' coordinates (page == num_pages drops the row); block_tables
    (B, pps); lengths (B,) valid tokens a row including the new one
    (inactive rows 0). ``starts`` is the engine's window and is not read:
    each layer's lower bound is its kind's. Returns (logits (B, V),
    pool)."""
    del starts
    dev = _dev(params)
    quant = pool.quant
    pos_h, len_h = torch.as_tensor(positions), torch.as_tensor(lengths)
    B = pos_h.shape[0]
    rp, rs = pool.ring_coords(torch.arange(B, device=pos_h.device), pos_h,
                              len_h > 0)
    tokens, positions, block_tables, lengths = (
        to_device(t, dev) for t in (tokens, positions, block_tables,
                                    lengths))
    ring_tbl = pool.ring_table(*block_tables.shape, dev)
    lower = (torch.clamp(lengths - cfg.sliding_window, min=0),
             torch.zeros_like(lengths))
    tables = model.rope(cfg, dev)
    rope = {k: mellum.cos_sin(t, positions) for k, t in tables.items()}
    stack = mellum.layer_stack(params)
    x = params["embed"][tokens.long()].float()
    for i in range(cfg.num_layers):
        sl_ = cfg.sliding(i)

        def attend(q, k, v, i=i, sl_=sl_):
            pg, st = (rp, rs) if sl_ else (page, slot)
            if quant:
                pool_l = write_layer_kv_quant(pool.layer(i), k, v, pg, st)
            else:
                pool_l = write_layer_kv(*pool.layer(i), k, v, pg, st)
            return grouped_out(_normalized_parts(
                grouped_in(q, cfg), pool_l, ring_tbl if sl_ else block_tables,
                lengths, lower[0 if sl_ else 1], use_kernel, quant), cfg)

        cos, sin = rope["sliding" if sl_ else "full"]
        x = block(x, mellum.layer(stack, i), cfg, cos, sin, attend,
                  pool.moe_counts[i])
    return mellum.logits(x, params, cfg), pool


def _band_bias(window: int, G: int, dtype, device) -> torch.Tensor:
    """(W * G, 2 * W) additive mask of a query block of W tokens whose G
    query heads of a K/V head are folded into its rows (row r is token
    r // G): 0 where the token's key, counted from block start - W + 1,
    lies in [token, token + W - 1], -inf elsewhere. Its rows are 2 * W
    wide so that every slice of it keeps the memory-efficient kernel's
    alignment (a bool mask would be converted, and padded, a call)."""
    key = (window, G, dtype, str(device))
    if key not in _BAND:
        qq = torch.arange(window * G, device=device)[:, None] // G
        kk = torch.arange(2 * window, device=device)[None, :]
        band = (kk >= qq) & (kk <= qq + window - 1)
        _BAND[key] = torch.zeros(band.shape, dtype=dtype, device=device) \
            .masked_fill_(~band, float("-inf"))
    return _BAND[key]


def prompt_attention(q, k, v, window: int, sliding: bool):
    """Causal attention over a prompt, q (b, T, NH, HD), k/v (b, T, NKV,
    HD) → (b, T, NH, HD): exact and bounded in memory (module
    docstring). On the card the fused backends only: flash for the
    causal calls (it takes grouped K/V), memory-efficient under the band
    mask, with the G query heads of a K/V head folded into its query rows
    (q copied once into (b, NKV, T, G, HD)), so that K and V are read as
    they are."""
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    b, T, NH, HD = q.shape
    NKV = k.shape[2]
    G = NH // NKV
    cuda = qh.device.type == "cuda"

    def sdpa(backends, *a, **kw):
        if not cuda:
            return F.scaled_dot_product_attention(*a, **kw)
        from torch.nn.attention import sdpa_kernel
        with sdpa_kernel(backends):
            return F.scaled_dot_product_attention(*a, **kw)

    from torch.nn.attention import SDPBackend
    # not cuDNN's: it builds an execution plan for every new shape, and a
    # wave's groups each bring one (a tenth of a second of host apiece)
    causal = [SDPBackend.FLASH_ATTENTION]
    if not sliding or T <= window:
        return sdpa(causal, qh, kh, vh, is_causal=True,
                    enable_gqa=True).transpose(1, 2)
    W = window
    qf = q.view(b, T, NKV, G, HD).transpose(1, 2).contiguous()
    out = torch.empty_like(qf)                     # (b, NKV, T, G, HD)
    out[:, :, :W] = sdpa(causal, qh[:, :, :W], kh[:, :, :W], vh[:, :, :W],
                         is_causal=True, enable_gqa=True) \
        .unflatten(1, (NKV, G)).transpose(2, 3)
    bias = _band_bias(W, G, q.dtype, q.device)
    banded = [SDPBackend.EFFICIENT_ATTENTION]
    for s in range(W, T, W):
        e = min(s + W, T)
        m = e - s
        out[:, :, s:e] = sdpa(
            banded, qf[:, :, s:e].reshape(b, NKV, m * G, HD),
            kh[:, :, s - W + 1:e], vh[:, :, s - W + 1:e],
            attn_mask=bias[:m * G, :m + W - 1]).unflatten(2, (m, G))
    return out.transpose(1, 2).reshape(b, T, NH, HD)


def prefill_groups(lengths: List[int],
                   budget: int = PREFILL_TOKENS) -> List[List[int]]:
    """The rows of a wave (their real lengths; 0 = a padding row, left
    out) in groups of at most ``budget`` padded tokens, the longest rows
    first, each group padded to its own longest row."""
    order = sorted((i for i, n in enumerate(lengths) if n > 0),
                   key=lambda i: -lengths[i])
    groups: List[List[int]] = []
    for i in order:
        g = groups[-1] if groups else None
        if g is not None and (len(g) + 1) * lengths[g[0]] <= budget:
            g.append(i)
        else:
            groups.append([i])
    return groups


def _ring_prompt_ids(pool: MellumPool, rows, lengths, T: int):
    """(b, ceil(T/ps)) ring page ids of each row's prompt pages: the last
    R pages of the row's prompt, the drop sentinel elsewhere."""
    ps, R = pool.page_size, pool.R
    j = torch.arange(-(-T // ps))[None, :]
    last = ((lengths - 1) // ps)[:, None]
    keep = (j <= last) & (j > last - R)
    ids = rows[:, None] * R + j % R
    return torch.where(keep, ids, pool.ring.num_pages)


@torch.no_grad()
def prefill_paged(params, tokens, page, slot, pool: MellumPool,
                  cfg: MellumConfig, last_pos=None, use_kernel: bool = True,
                  model=MODEL, rows=None):
    """Prompt forward of a wave that writes the prompts' K/V: every page
    of the full layers (the managed pool) and the last R pages of the
    sliding layers (their rings).

    tokens (B, T) right-padded prompts; page (B, T) the full layers' pool
    page a token (num_pages on padding: the row's real length is its
    count of real pages); PRECONDITION, as in GPT-2's: prompts start at
    position 0 of fresh pages, and ``slot`` is not read. ``rows`` (B,):
    each row's engine slot, the ring's row (default 0..B-1). ``last_pos``
    (B,): logits at each row's position last_pos[b] → (B, V); None →
    (B, T, V). Padding rows give zero logits. Returns (logits, pool).
    ``use_kernel`` is taken for the signature's sake: the prompt's
    attention is scaled_dot_product_attention on every device."""
    del slot, use_kernel
    dev = _dev(params)
    page = torch.as_tensor(page).cpu()
    B, T = page.shape
    lengths = (page < pool.num_pages).sum(dim=1)
    rows = (torch.arange(B) if rows is None
            else torch.as_tensor(rows).cpu().long())
    V = cfg.vocab_size
    out = torch.zeros((B, V) if last_pos is not None else (B, T, V),
                      device=dev)
    stack = mellum.layer_stack(params)
    tables = model.rope(cfg, dev)
    ps = pool.page_size
    for g in prefill_groups(lengths.tolist()):
        gi = torch.tensor(g)
        n = lengths[gi]
        Tg = int(n.max())
        b = len(g)
        x = params["embed"][to_device(torch.as_tensor(tokens)[gi, :Tg],
                                      dev).long()].float()
        pos = torch.arange(Tg, device=dev)
        rope = {k: mellum.cos_sin(t, pos) for k, t in tables.items()}
        valid = torch.arange(Tg)[None, :] < n[:, None]
        real = to_device(torch.nonzero(valid.reshape(-1)).squeeze(1), dev)
        full_ids = prompt_page_ids(page[gi, :Tg], Tg, ps, pool.num_pages)
        ring_ids = _ring_prompt_ids(pool, rows[gi], n, Tg)
        for i in range(cfg.num_layers):
            lp = mellum.layer(stack, i)
            sl_ = cfg.sliding(i)
            cos, sin = rope["sliding" if sl_ else "full"]
            q, k, v = mellum.qkv(x, lp, cfg)
            q, k = mellum.apply_rope(q, cos, sin), \
                mellum.apply_rope(k, cos, sin)
            gpt2_paged._write_prompt(pool.layer(i), k, v,
                                     ring_ids if sl_ else full_ids)
            att = prompt_attention(q, k, v, cfg.sliding_window, sl_)
            x = x + F.linear(att.reshape(b, Tg, -1), lp["wo"])
            y = mellum.rms_norm(x, lp["mlp_norm"], cfg.rms_eps,
                                torch.float32)
            xf = x.view(-1, cfg.channels)
            xf[real] = xf[real] + mellum.moe(
                y.reshape(-1, cfg.channels)[real], lp, cfg,
                pool.moe_counts[i])
        gd = to_device(gi, dev)
        if last_pos is not None:
            lp_ = to_device(torch.as_tensor(last_pos).cpu()[gi], dev).long()
            out[gd] = mellum.logits(
                x[torch.arange(b, device=dev), lp_], params, cfg)
        else:
            out[gd, :Tg] = mellum.logits(x, params, cfg)
    return out, pool
