"""L2+L3: GPT-2 forward over the paged KV pool (port of the serving paths
of llmc_paged_tpu/models/gpt2_paged.py).

  * prefill_paged: one padded batched prompt forward that writes whole
    pages into the pool and, with ``last_pos``, projects logits only at
    each row's last prompt position;
  * decode_chunk_paged: K greedy steps in one call. The pool is READ-ONLY
    during the chunk; each step's K/V goes into per-layer (K, B, NH, HS)
    tails, attention merges the pool prefix (the paged parts kernel) with
    the tail, and each layer's tail is committed once after the K steps;
  * decode_step_paged: one step that writes the new token's K/V into the
    pool, then attends through the normalized paged wrapper.

The layer and step loops are Python loops run eagerly. Pool updates are
in place. Index tensors may be passed on the CPU or on the pool's
device: block tables, lengths and tokens move to the device; pool
coordinates (page/slot) are filtered where they lie, so coordinates
built on the host cost no device sync.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from llmc_paged_tpu_torch.config import GPT2Config
from llmc_paged_tpu_torch.kv.layouts import (
    PagePool,
    QuantPagePool,
    commit_layer_kv,
    commit_layer_kv_quant,
    prompt_page_ids,
    write_layer_kv,
    write_layer_kv_quant,
    write_prompt_pages,
    write_prompt_pages_quant,
)
from llmc_paged_tpu_torch.models import gpt2
from llmc_paged_tpu_torch.ops import layers as L
from llmc_paged_tpu_torch.ops.paged_attention import (
    NEG_INF,
    paged_decode_attention,
    paged_decode_attention_parts,
    paged_decode_attention_parts_ref,
    paged_decode_attention_quant,
    paged_decode_attention_quant_parts,
    paged_decode_attention_quant_parts_ref,
    paged_decode_attention_quant_ref,
    paged_decode_attention_ref,
)


def _dev(params) -> torch.device:
    return params["wpe"].device


@torch.no_grad()
def decode_step_paged(params, tokens, positions, page, slot, block_tables,
                      lengths, pool: PagePool, cfg: GPT2Config,
                      use_kernel: bool = True, starts=None):
    """One batched decode step over the paged pool.

    tokens (B,) new ids; positions (B,) their wpe positions; page/slot
    (B,) pool coordinates for the new K/V (page == num_pages drops the
    row); block_tables (B, pages_per_seq); lengths (B,) valid tokens per
    row INCLUDING the new one (inactive rows 0); starts (B,) optional
    window lower bounds. Returns (logits (B, V), pool)."""
    dev = _dev(params)
    tokens, positions = tokens.to(dev), positions.to(dev)
    block_tables, lengths = block_tables.to(dev), lengths.to(dev)
    starts = (torch.zeros_like(lengths) if starts is None
              else starts.to(dev))
    B = tokens.shape[0]
    x = gpt2._embed(params, tokens, positions)
    quant = isinstance(pool, QuantPagePool)
    stack = gpt2._layer_stack(params)

    for i in range(cfg.num_layers):
        def attend(q, k, v, i=i):
            if quant:
                pool_l = write_layer_kv_quant(pool.layer(i), k, v, page, slot)
                fn = (paged_decode_attention_quant if use_kernel
                      else paged_decode_attention_quant_ref)
            else:
                pool_l = write_layer_kv(*pool.layer(i), k, v, page, slot)
                fn = (paged_decode_attention if use_kernel
                      else paged_decode_attention_ref)
            att = fn(q.contiguous(), *pool_l, block_tables, lengths, starts)
            return att.reshape(B, cfg.channels)

        x = gpt2._block(x, gpt2._layer(stack, i), cfg, attend)
    return gpt2._logits(x, params, cfg), pool


def _merge_parts(acc_p, m_p, l_p, acc_t, m_t, l_t, out_dtype):
    """Combine two unnormalized online-softmax parts — the pool prefix and
    the in-flight tail — into normalized attention. l == 0 (both sources
    fully masked: inactive rows) divides by 1 so the result stays
    finite."""
    m = torch.maximum(m_p, m_t)
    a_p = torch.exp(m_p - m)
    a_t = torch.exp(m_t - m)
    l = l_p * a_p + l_t * a_t
    l = torch.where(l == 0.0, 1.0, l)
    att = (acc_p * a_p[..., None] + acc_t * a_t[..., None]) / l[..., None]
    return att.to(out_dtype)


def _chunk_attention(q, pool_l, tail_k, tail_v, block_tables, lengths_pool,
                     starts, pos0, j: int, use_kernel: bool, quant: bool):
    """Decode-chunk attention: the read-only pool prefix (paged parts)
    merged with the in-flight tail (rows [0, j] valid).

    q (B, NH, HS); tail_k/tail_v (K, B, NH, HS); lengths_pool = pos0
    (completed tokens); starts = window lower bounds for the current
    position. Returns (B, NH, HS) in q.dtype."""
    B, NH, HS = q.shape
    K = tail_k.shape[0]
    if use_kernel:
        parts = (paged_decode_attention_quant_parts if quant
                 else paged_decode_attention_parts)
    else:
        parts = (paged_decode_attention_quant_parts_ref if quant
                 else paged_decode_attention_parts_ref)
    acc_p, m_p, l_p = parts(q, *pool_l, block_tables, lengths_pool, starts)

    qf = q.float()
    scale = float(torch.rsqrt(torch.tensor(float(HS))))
    scores = torch.einsum("bhd,kbhd->bhk", qf, tail_k.float()) * scale
    t_idx = torch.arange(K, device=q.device, dtype=torch.int32)
    pos_t = pos0[:, None] + t_idx[None, :]            # (B, K) absolute pos
    mask = ((t_idx <= j)[None, :] & (pos_t >= starts[:, None]))[:, None, :]
    scores = torch.where(mask, scores, NEG_INF)
    m_t = scores.amax(dim=-1)                         # (B, NH)
    p = torch.where(mask, torch.exp(scores - m_t[..., None]), 0.0)
    l_t = p.sum(dim=-1)
    acc_t = torch.einsum("bhk,kbhd->bhd", p, tail_v.float())
    return _merge_parts(acc_p, m_p, l_p, acc_t, m_t, l_t, q.dtype)


@torch.no_grad()
def decode_chunk_paged(params, first_tokens, positions0, pages, slots,
                       block_tables, pool: PagePool, cfg: GPT2Config,
                       num_steps: int, window: int, use_kernel: bool = True):
    """K = num_steps greedy decode steps in one call.

    first_tokens (B,) the token fed at sub-step 0 (may be a device tensor
    from a previous call: tokens feed back without a host round trip);
    positions0 (B,) its position (< 0: row inactive for the whole chunk);
    pages/slots (K, B) pool coordinates reserved ahead for each sub-step;
    block_tables the final tables including the reserved pages. Returns
    (tokens (K, B) int32 on the device — each sub-step's argmax — and the
    pool). Greedy only (device sampling, logprobs and penalties are later
    slices of the port)."""
    dev = _dev(params)
    toks = first_tokens.to(dev)
    positions0 = positions0.to(dev)
    block_tables = block_tables.to(dev)
    active = positions0 >= 0
    safe_pos0 = torch.where(active, positions0, 0).int()
    B = toks.shape[0]
    NH, HS, C = cfg.num_heads, cfg.head_dim, cfg.channels
    quant = isinstance(pool, QuantPagePool)
    stack = gpt2._layer_stack(params)
    cdtype = params["wpe"].dtype            # the serving compute dtype
    tks = [torch.zeros((num_steps, B, NH, HS), dtype=cdtype, device=dev)
           for _ in range(cfg.num_layers)]
    tvs = [torch.zeros_like(t) for t in tks]
    lengths_pool = safe_pos0                # pool reads: completed prefix

    out = []
    for j in range(num_steps):
        pos = safe_pos0 + j
        wpe_pos = torch.clamp(pos, max=window - 1)
        starts = torch.clamp(pos + 1 - window, min=0)
        x = gpt2._embed(params, toks, wpe_pos)
        for i in range(cfg.num_layers):
            def attend(q, k, v, i=i, j=j):
                tks[i][j] = k
                tvs[i][j] = v
                att = _chunk_attention(q.contiguous(), pool.layer(i), tks[i],
                                       tvs[i], block_tables, lengths_pool,
                                       starts, safe_pos0, j, use_kernel,
                                       quant)
                return att.reshape(B, C)

            x = gpt2._block(x, gpt2._layer(stack, i), cfg, attend)
        toks = torch.argmax(gpt2._logits(x, params, cfg), dim=-1).int()
        out.append(toks)

    # commit the chunk's K/V, one indexed write per layer (int8 pools
    # quantize here, once)
    for i in range(cfg.num_layers):
        if quant:
            commit_layer_kv_quant(pool.layer(i), tks[i], tvs[i], pages, slots)
        else:
            commit_layer_kv(*pool.layer(i), tks[i], tvs[i], pages, slots)
    return torch.stack(out), pool


@torch.no_grad()
def prefill_paged(params, tokens, page, slot, pool: PagePool,
                  cfg: GPT2Config, last_pos=None):
    """Prompt forward that writes all T tokens' K/V into the pool.

    tokens (B, T) right-padded prompts; page (B, T) pool page per token
    (num_pages on padding → dropped). PRECONDITION: prompts start at
    position 0 of freshly allocated pages, so token t's slot is
    t % page_size; ``slot`` is accepted for signature symmetry only.
    Attention is dense causal over the in-flight K/V. ``last_pos`` (B,):
    project logits only at each row's position last_pos[b] → (B, V);
    None → (B, T, V). Returns (logits, pool)."""
    del slot
    dev = _dev(params)
    tokens = tokens.to(dev)
    B, T = tokens.shape
    x = gpt2._embed(params, tokens, torch.arange(T, device=dev)[None])
    quant = isinstance(pool, QuantPagePool)
    stack = gpt2._layer_stack(params)
    ps = pool.page_size
    Tp = -(-T // ps) * ps
    page_ids = prompt_page_ids(page, T, ps, pool.num_pages)

    def pad_t(a):
        return a if Tp == T else F.pad(a, (0, 0, 0, 0, 0, Tp - T))

    for i in range(cfg.num_layers):
        def attend(q, k, v, i=i):                       # (B, T, NH, HS)
            if quant:
                write_prompt_pages_quant(pool.layer(i), pad_t(k), pad_t(v),
                                         page_ids)
            else:
                write_prompt_pages(*pool.layer(i), pad_t(k), pad_t(v),
                                   page_ids)
            qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
            att = L.prefill_attention(qh, kh, vh)
            return att.transpose(1, 2).reshape(B, T, cfg.channels)

        x = gpt2._block(x, gpt2._layer(stack, i), cfg, attend)

    if last_pos is not None:
        x = x[torch.arange(B, device=dev), last_pos.to(dev).long()]
    return gpt2._logits(x, params, cfg), pool
