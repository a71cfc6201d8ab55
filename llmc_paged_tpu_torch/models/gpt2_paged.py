"""L2+L3: GPT-2 forward over the paged KV pool (port of the serving paths
of llmc_paged_tpu/models/gpt2_paged.py).

  * prefill_paged: one padded batched prompt forward that writes whole
    pages into the pool and, with ``last_pos``, projects logits only at
    each row's last prompt position;
  * decode_chunk_paged: K decode steps in one call, greedy or sampled on
    the device (temperature/top-k, per-row overrides, penalties over a
    (B, V) count plane, raw-softmax logprobs). The pool is READ-ONLY
    during the chunk; each step's K/V goes into per-layer (K, B, NH, HS)
    tails, attention merges the pool prefix (the paged parts kernel) with
    the tail, and each layer's tail is committed once after the K steps;
  * decode_step_paged: one step that writes the new token's K/V into the
    pool, then attends through the normalized paged wrapper;
  * decode_chunk_spec: S greedy speculative verify steps in one call,
    each scoring the carried token plus spec_k - 1 n-gram drafts in one
    forward; the pool is read through the multi-query parts kernel;
  * prefill_suffix_paged: the prefill of a prompt suffix whose prefix
    pages are already in the pool (prefix caching), attending them
    through the multi-query parts kernel.

The layer and step loops are Python loops run eagerly. Pool updates are
in place. Index tensors may be passed on the CPU or on the pool's
device: block tables, lengths and tokens go up through pinned memory
without blocking (kv.layouts.to_device); pool coordinates (page/slot)
are filtered where they lie, so coordinates built on the host cost no
device sync either.
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
    to_device,
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
    paged_decode_attention_parts_mq,
    paged_decode_attention_parts_mq_ref,
    paged_decode_attention_parts_ref,
    paged_decode_attention_quant,
    paged_decode_attention_quant_parts,
    paged_decode_attention_quant_parts_mq,
    paged_decode_attention_quant_parts_mq_ref,
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
    tokens, positions, block_tables, lengths = (
        to_device(t, dev) for t in (tokens, positions, block_tables,
                                    lengths))
    starts = (torch.zeros_like(lengths) if starts is None
              else to_device(starts, dev))
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


def _pick(logits, counts, rng, top_k, temperature, k_arr, greedy_rows,
          freq_pen, pres_pen):
    """A chunk sub-step's token choice (the JAX chunk's ``pick``): the
    penalty subtraction, then greedy argmax (``rng`` None) or a draw from
    the temperature/top-k transform of the f32 logits. The draw is the
    Gumbel-max trick, argmax(lg - log(-log(u))) with u from ``rng`` on
    the logits' device (the distribution of jax.random.categorical, not
    its bits); it reads nothing back, so a link stays free of host
    synchronization; ``rng`` advances with each draw, in the place of
    the JAX chunk's per-step fold_in."""
    if counts is not None:
        logits = (logits.float() - freq_pen[:, None] * counts
                  - pres_pen[:, None] * (counts > 0))
    if rng is None:
        return torch.argmax(logits, dim=-1).int()
    temp = (temperature[:, None] if torch.is_tensor(temperature)
            and temperature.dim() == 1 else temperature)
    lg = logits.float() / temp
    if top_k is not None and 0 < top_k < lg.shape[-1]:
        vals = torch.topk(lg, top_k, dim=-1).values           # (B, top_k)
        if k_arr is None:
            lg = torch.where(lg < vals[:, -1:], -torch.inf, lg)
        else:
            # per-row k (0 = no filter), clamped to the static cap
            kc = torch.clamp(k_arr, 1, top_k).long()
            kth = torch.gather(vals, 1, kc[:, None] - 1)
            lg = torch.where((k_arr > 0)[:, None] & (lg < kth),
                             -torch.inf, lg)
    u = torch.rand(lg.shape, generator=rng, device=lg.device)
    u = u.clamp(torch.finfo(torch.float32).tiny, 1.0 - 2.0 ** -24)
    samp = torch.argmax(lg - torch.log(-torch.log(u)), dim=-1).int()
    if greedy_rows is not None:
        samp = torch.where(greedy_rows,
                           torch.argmax(logits, dim=-1).int(), samp)
    return samp


@torch.no_grad()
def decode_chunk_paged(params, first_tokens, positions0, pages, slots,
                       block_tables, pool: PagePool, cfg: GPT2Config,
                       num_steps: int, window: int, use_kernel: bool = True,
                       rng=None, top_k=None, temperature=1.0, k_arr=None,
                       greedy_rows=None, want_logprobs: bool = False,
                       pen_counts=None, freq_pen=None, pres_pen=None):
    """K = num_steps decode steps in one call.

    first_tokens (B,) the token fed at sub-step 0 (may be a device tensor
    from a previous call: tokens feed back without a host round trip);
    positions0 (B,) its position (< 0: row inactive for the whole chunk);
    pages/slots (K, B) pool coordinates reserved ahead for each sub-step;
    block_tables the final tables including the reserved pages. Host
    inputs go up through pinned memory without blocking, so a call makes
    no synchronizing CUDA call.

    Token choice: greedy argmax when ``rng`` is None; otherwise a draw
    on the device from ``rng`` (a torch.Generator on the pool's device)
    under the temperature/top-k transform, in f32 (top-k masks
    ``lg < kth``, so ties at the k-th value stay in). Per-request
    sampling: ``temperature`` may be a (B,) tensor; ``k_arr`` (B,) gives
    each row's top-k (0 = no filter) with the static ``top_k`` as the cap
    rows clamp to; ``greedy_rows`` (B,) bool takes those rows' argmax.
    Penalties: ``pen_counts`` (B, V) int32 token counts over the full
    context, updated on the device with each pick; the pick is taken
    from logits - freq_pen*counts - pres_pen*(counts > 0), greedy or
    sampled. ``want_logprobs`` adds each chosen token's logprob under
    the RAW softmax (f32 logsumexp).

    Returns (out[, counts][, logps], pool), the JAX convention: out
    (K, B) int32 on the device; counts (B, V) the updated plane when
    ``pen_counts`` is given; logps (K, B) f32 when ``want_logprobs``."""
    if rng is not None and isinstance(temperature, (int, float)) \
            and temperature == 0:
        # a temperature of 0 would divide the logits by zero and draw
        # arbitrary tokens with no error; the engine maps it to greedy
        raise ValueError("temperature=0 with device sampling: use greedy "
                         "(rng=None) instead")
    dev = _dev(params)
    toks = to_device(first_tokens, dev).int()
    positions0 = to_device(positions0, dev)
    block_tables = to_device(block_tables, dev)
    if not isinstance(temperature, (int, float)):        # (B,) per row
        temperature = to_device(temperature, dev).float()
    k_arr = None if k_arr is None else to_device(k_arr, dev)
    greedy_rows = (None if greedy_rows is None
                   else to_device(greedy_rows, dev))
    counts = None
    if pen_counts is not None:
        counts = to_device(pen_counts, dev).int()
        freq_pen = to_device(freq_pen, dev).float()
        pres_pen = to_device(pres_pen, dev).float()
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

    out, logps = [], []
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
        logits = gpt2._logits(x, params, cfg)
        toks = _pick(logits, counts, rng, top_k, temperature, k_arr,
                     greedy_rows, freq_pen, pres_pen)
        if counts is not None:
            counts.scatter_add_(1, toks.long()[:, None],
                                torch.ones_like(toks)[:, None])
        if want_logprobs:
            lf = logits.float()
            logps.append(torch.gather(lf, 1, toks.long()[:, None])[:, 0]
                         - torch.logsumexp(lf, dim=-1))
        out.append(toks)

    # commit the chunk's K/V, one indexed write per layer (int8 pools
    # quantize here, once)
    for i in range(cfg.num_layers):
        if quant:
            commit_layer_kv_quant(pool.layer(i), tks[i], tvs[i], pages, slots)
        else:
            commit_layer_kv(*pool.layer(i), tks[i], tvs[i], pages, slots)
    ret = (torch.stack(out),)
    if counts is not None:
        ret += (counts,)
    if want_logprobs:
        ret += (torch.stack(logps),)
    return ret + (pool,)


def _ngram_draft(hist: torch.Tensor, hl: torch.Tensor, n: int,
                 d: int) -> torch.Tensor:
    """Device-side prompt-lookup drafting: for each row, find the MOST
    RECENT position whose n-gram equals the row's last n tokens and
    propose the d tokens that followed it. Returns (B, d) int32 with -1
    where no draft exists (no match, or the continuation runs past the
    known tokens); -1 never equals an argmax, so a bogus draft is simply
    rejected by verification.

    hist (B, H): all known tokens per row (prompt + generated); hl (B,):
    how many are valid."""
    B, H = hist.shape
    dev = hist.device
    hl = hl.long()
    idx = hl[:, None] - n + torch.arange(n, device=dev)[None, :]
    tail = torch.gather(hist, 1, idx.clamp(0, H - 1))
    Wn = H - n + 1
    win = torch.stack([hist[:, i:i + Wn] for i in range(n)], dim=-1)
    j_idx = torch.arange(Wn, device=dev)[None, :]
    # j == hl-n is the trivial self-match (continuation = the empty
    # future); the match must end at least one token earlier
    ok = (j_idx + n <= hl[:, None] - 1) & (hl[:, None] >= n + 1)
    match = (win == tail[:, None, :]).all(dim=-1) & ok
    best = torch.where(match, j_idx, -1).amax(dim=1)              # (B,)
    didx = best[:, None] + n + torch.arange(d, device=dev)[None, :]
    drafts = torch.gather(hist, 1, didx.clamp(0, H - 1))
    valid = (best >= 0)[:, None] & (didx < hl[:, None])
    return torch.where(valid, drafts, -1).int()


def _spec_tail_attention(q, pool_l, tail_k, tail_v, block_tables, pos0,
                         t_off, use_kernel: bool, quant: bool):
    """Verify-step attention: KQ in-flight queries against the read-only
    pool prefix [0, pos0) (multi-query parts, ONE page walk for all KQ)
    plus the in-flight tail, merged via online-softmax parts like
    _chunk_attention.

    q (B, KQ, NH, HS); tail_k/tail_v (TK, B, NH, HS) where rows
    [0, t_off[b]) hold accepted tokens and rows [t_off[b], t_off[b]+KQ)
    the current block (query j attends tail rows r <= t_off[b]+j: causal
    within the block, total over the accepted prefix). Rows past that
    are stale rejected writes, masked. Returns (B, KQ, NH, HS) in
    q.dtype."""
    B, KQ, NH, HS = q.shape
    TK = tail_k.shape[0]
    if use_kernel:
        parts = (paged_decode_attention_quant_parts_mq if quant
                 else paged_decode_attention_parts_mq)
    else:
        parts = (paged_decode_attention_quant_parts_mq_ref if quant
                 else paged_decode_attention_parts_mq_ref)
    acc_p, m_p, l_p = parts(q, *pool_l, block_tables, pos0,
                            torch.zeros_like(pos0))

    qf = q.float()
    scale = float(torch.rsqrt(torch.tensor(float(HS))))
    scores = torch.einsum("bqhd,kbhd->bqhk", qf, tail_k.float()) * scale
    r_idx = torch.arange(TK, device=q.device)
    limit = t_off[:, None] + torch.arange(KQ, device=q.device)[None, :]
    mask = (r_idx[None, None, :] <= limit[..., None])[:, :, None, :]
    scores = torch.where(mask, scores, NEG_INF)
    m_t = scores.amax(dim=-1)                             # (B, KQ, NH)
    p = torch.where(mask, torch.exp(scores - m_t[..., None]), 0.0)
    l_t = p.sum(dim=-1)
    acc_t = torch.einsum("bqhk,kbhd->bqhd", p, tail_v.float())
    return _merge_parts(acc_p, m_p, l_p, acc_t, m_t, l_t, q.dtype)


@torch.no_grad()
def decode_chunk_spec(params, first_tokens, positions0, hist,
                      pool: PagePool, block_tables, cfg: GPT2Config,
                      num_steps: int, spec_k: int, ngram: int = 3,
                      use_kernel: bool = True, *, active):
    """SPECULATIVE decode chunk: num_steps greedy verify steps, each
    consuming spec_k tokens (the carried token plus spec_k - 1 drafts from
    prompt lookup, _ngram_draft) in ONE forward. Greedy acceptance keeps
    the longest prefix where draft i equals the argmax at position i-1,
    so every emitted token equals plain greedy decode; a step yields 1 to
    spec_k tokens.

    first_tokens (B,): input token for step 0 (the last known token);
    positions0 (B,): its position = committed pool length (< 0: row
    inactive for the whole chunk); hist (B, H): all known tokens per row,
    row b valid through positions0[b] + 1 (H must fit positions0 + 1 +
    num_steps*spec_k); block_tables must already cover pages for
    num_steps*spec_k new tokens per row: the host reserves the maximum
    and rolls back with BlockManager.truncate_to. The inputs may be
    device carries of a previous call.

    ``active``: the host's (B,) bool view of positions0 >= 0 (positions0
    may be a device carry, and reading it would cost a device→host
    copy). The commit writes each active row's whole tail of
    num_steps*spec_k rows
    at its reserved coordinates, computed on the device: the rows past
    the accepted count land beyond the row's new length, where they are
    never read and are overwritten later (the truncate_to contract).
    Only inactive rows, known to the host, are left out, so the commit
    needs no device→host copy.

    Returns (out (S, spec_k, B) int32 — step s's argmax tokens, of which
    counts (S, B) leading entries are real; hist (B, H) updated;
    last_tok (B,), new_positions (B,) — device carries for chaining;
    pool, updated in place). Greedy only."""
    S, K = num_steps, spec_k
    if K < 2:
        raise ValueError("spec_k < 2 is plain greedy decode — use "
                         "decode_chunk_paged")
    dev = _dev(params)
    active_rows = torch.nonzero(torch.as_tensor(active)).squeeze(1)
    positions0 = to_device(positions0, dev)
    cur = to_device(first_tokens, dev).int()
    hist = to_device(hist, dev).int()
    block_tables = to_device(block_tables, dev)
    B = cur.shape[0]
    NH, HS, C = cfg.num_heads, cfg.head_dim, cfg.channels
    TK = S * K
    H = hist.shape[1]
    act = positions0 >= 0
    pos0 = torch.where(act, positions0, 0).int()
    quant = isinstance(pool, QuantPagePool)
    stack = gpt2._layer_stack(params)
    cdtype = params["wpe"].dtype
    tks = [torch.zeros((TK, B, NH, HS), dtype=cdtype, device=dev)
           for _ in range(cfg.num_layers)]
    tvs = [torch.zeros_like(t) for t in tks]
    barange = torch.arange(B, device=dev)
    karange = torch.arange(K, device=dev, dtype=torch.int32)
    hl = torch.where(act, pos0 + 1, 0).int()
    t_off = torch.zeros(B, dtype=torch.int32, device=dev)

    outs, counts = [], []
    for _ in range(S):
        drafts = _ngram_draft(hist, hl, ngram, K - 1)          # (B, K-1)
        inputs = torch.cat([cur[:, None], drafts], dim=1)
        q_pos = (pos0 + t_off)[:, None] + karange[None, :]    # (B, K)
        wpe_pos = torch.clamp(q_pos, max=cfg.max_seq_len - 1)
        x = gpt2._embed(params, torch.clamp(inputs, min=0), wpe_pos)
        ridx = (t_off[:, None] + karange[None, :]).T.long()  # (K, B)
        for i in range(cfg.num_layers):
            def attend(q, k, v, i=i):                       # (B, K, NH, HS)
                tks[i][ridx, barange[None, :]] = k.transpose(0, 1).to(cdtype)
                tvs[i][ridx, barange[None, :]] = v.transpose(0, 1).to(cdtype)
                att = _spec_tail_attention(q.contiguous(), pool.layer(i),
                                           tks[i], tvs[i], block_tables,
                                           pos0, t_off, use_kernel, quant)
                return att.reshape(B, K, C)

            x = gpt2._block(x, gpt2._layer(stack, i), cfg, attend)
        o = torch.argmax(gpt2._logits(x, params, cfg), dim=-1).int()

        lead = torch.cumprod((o[:, :-1] == drafts).int(), dim=1)
        a = torch.where(act, 1 + lead.sum(dim=1), 0).int()      # (B,)
        # append all K outputs at hl (entries past hl+a are overwritten
        # by the next step before a masked read sees them); inactive rows
        # and overflow go to a trash column (scatter mode="drop")
        hidx = torch.where(act[:, None], hl[:, None] + karange[None, :], H)
        ext = torch.cat([hist, hist.new_zeros((B, 1))], dim=1)
        ext.scatter_(1, hidx.clamp(max=H).long(), o)
        hist = ext[:, :H]
        nxt = torch.gather(o, 1, (a - 1).clamp(min=0)[:, None].long())[:, 0]
        cur = torch.where(act, nxt, cur)
        hl = hl + a
        t_off = t_off + a
        outs.append(o.T)
        counts.append(a)

    # commit each active row's whole tail at its reserved coordinates
    if len(active_rows):
        rows = to_device(active_rows, dev)
        tpos = pos0[rows][:, None] + torch.arange(TK, device=dev)[None, :]
        pidx = torch.div(tpos, pool.page_size, rounding_mode="floor")
        pg = torch.gather(block_tables[rows], 1, pidx.long()).T
        sl = torch.remainder(tpos, pool.page_size).T          # (TK, nA)
        for i in range(cfg.num_layers):
            tk, tv = tks[i][:, rows], tvs[i][:, rows]
            if quant:
                commit_layer_kv_quant(pool.layer(i), tk, tv, pg, sl,
                                      sentinel=False)
            else:
                commit_layer_kv(*pool.layer(i), tk, tv, pg, sl,
                                sentinel=False)
    new_positions = torch.where(act, pos0 + t_off, positions0).int()
    return (torch.stack(outs), torch.stack(counts), hist, cur,
            new_positions, pool)


@torch.no_grad()
def prefill_paged(params, tokens, page, slot, pool: PagePool,
                  cfg: GPT2Config, last_pos=None, use_kernel: bool = True):
    """Prompt forward that writes all T tokens' K/V into the pool.

    tokens (B, T) right-padded prompts; page (B, T) pool page per token
    (num_pages on padding → dropped). PRECONDITION: prompts start at
    position 0 of freshly allocated pages, so token t's slot is
    t % page_size; ``slot`` is accepted for signature symmetry only.
    Attention is causal over the in-flight K/V: the flash kernel for
    long bf16 waves, dense otherwise or with ``use_kernel=False``
    (``ops/layers.prefill_attention``). ``last_pos`` (B,):
    project logits only at each row's position last_pos[b] → (B, V);
    None → (B, T, V). Returns (logits, pool)."""
    del slot
    dev = _dev(params)
    tokens = to_device(tokens, dev)
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
            att = L.prefill_attention(qh, kh, vh, use_kernel)
            return att.transpose(1, 2).reshape(B, T, cfg.channels)

        x = gpt2._block(x, gpt2._layer(stack, i), cfg, attend)

    if last_pos is not None:
        x = x[torch.arange(B, device=dev), to_device(last_pos, dev).long()]
    return gpt2._logits(x, params, cfg), pool


@torch.no_grad()
def prefill_suffix_paged(params, tokens, page, slot, pool: PagePool,
                         block_tables, pool_len, cfg: GPT2Config, last_pos,
                         use_kernel: bool = True):
    """Prefill of a prompt SUFFIX whose prefix is already resident in the
    pool (prefix caching, PageConfig.prefix_cache): suffix token j of row
    b sits at absolute position pool_len[b] + j and attends the cached
    prefix THROUGH THE BLOCK TABLE (multi-query parts: one page walk
    scores a tile of suffix queries, the speculative-verify read path)
    plus the suffix itself causally, merged online-softmax. Any suffix
    length goes through the kernel on the card.

    PRECONDITIONS: pool_len[b] % page_size == 0 (only full pages are
    shared) and the suffix starts on a freshly allocated page, so the
    page-granular writes of prefill_paged apply with suffix-local token
    indices. Rows with pool_len == 0 degenerate to plain prefill.
    ``slot`` is accepted for signature symmetry only.

    tokens (B, Tsuf) right-padded suffixes; page (B, Tsuf) per-token pool
    pages (drop sentinel on padding); block_tables (B, pages_per_seq);
    pool_len (B,) cached prefix lengths; last_pos (B,) suffix-local index
    of each row's last prompt token. Returns ((B, V) logits at last_pos,
    pool)."""
    del slot
    dev = _dev(params)
    tokens = to_device(tokens, dev)
    block_tables = to_device(block_tables, dev)
    pool_len = to_device(pool_len, dev).int()
    B, T = tokens.shape
    pos = pool_len[:, None] + torch.arange(T, device=dev)[None, :]
    x = gpt2._embed(params, tokens,
                    torch.clamp(pos, max=cfg.max_seq_len - 1))
    quant = isinstance(pool, QuantPagePool)
    stack = gpt2._layer_stack(params)
    ps = pool.page_size
    Tp = -(-T // ps) * ps
    page_ids = prompt_page_ids(page, T, ps, pool.num_pages)
    t_off = torch.zeros(B, dtype=torch.int32, device=dev)

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
            att = _spec_tail_attention(q.contiguous(), pool.layer(i),
                                       k.transpose(0, 1), v.transpose(0, 1),
                                       block_tables, pool_len, t_off,
                                       use_kernel, quant)
            return att.reshape(B, T, cfg.channels)

        x = gpt2._block(x, gpt2._layer(stack, i), cfg, attend)

    x = x[torch.arange(B, device=dev), to_device(last_pos, dev).long()]
    return gpt2._logits(x, params, cfg), pool
