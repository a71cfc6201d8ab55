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

Every function runs on one device, or on one rank's shard under tensor
parallelism: ``model`` carries the pieces that differ (the embedding,
the block around its attention middle, the logits, the heads a rank
holds, the prompt attention and the suffix kernel gate). ``SINGLE`` is
the one-device model and the default; ``parallel/sharding.py::TPModel``
the head-sharded one.

The layer and step loops are Python loops run eagerly, except a greedy
decode chain on one card, whose step replays as a CUDA graph
(``graph_eligible``, models/decode_graphs.py). Pool updates are in
place. Index tensors may be passed on the CPU or on the pool's
device: block tables, lengths and tokens go up through pinned memory
without blocking (kv.layouts.to_device); pool coordinates (page/slot)
are filtered where they lie, so coordinates built on the host cost no
device sync either.
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from llmc_paged_tpu_torch.config import GPT2Config
from llmc_paged_tpu_torch.kv.layouts import (
    PagePool,
    QuantPagePool,
    commit_layer_kv,
    commit_layer_kv_quant,
    init_pool,
    prompt_page_ids,
    to_device,
    write_layer_kv,
    write_layer_kv_quant,
    write_prompt_pages,
    write_prompt_pages_quant,
)
from llmc_paged_tpu_torch.models import gpt2
from llmc_paged_tpu_torch.models.decode_graphs import DecodeGraphs
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
from llmc_paged_tpu_torch.utils.spans import span


def _dev(params) -> torch.device:
    return next(iter(params.values())).device


class SingleDevice:
    """The model pieces of a forward on one device (the whole model):
    ``attend(q, k, v)`` returns the heads (..., NH, HS) and ``block``
    joins them into the (..., C) that attproj takes.

    The chained decode step (``_chain_step``) reads a model through the
    ``chain_*`` pieces below; GPT-2's are these, and another family's
    model object gives its own (models/mellum_paged.py). ``graphs``: its
    chain step may replay as a CUDA graph (``graph_eligible``). The
    engine knows the family only through this object: the module of its
    device entries (``entries``, where each call is looked up), its pool
    of ``max_seqs`` rows, its refusals and its counters of a run."""

    graphs = True
    entries = sys.modules[__name__]

    @staticmethod
    def refuse(econf, device, window=None) -> None:
        """Raise ValueError, naming the family and the option, for what
        it does not serve: an engine option (``econf`` on ``device``,
        None being the card) or ``run(window=...)``. GPT-2 serves all."""

    def new_pool(self, cfg, page, dtype, device, max_seqs: int):
        return init_pool(cfg, page, dtype=dtype, device=device)

    @staticmethod
    def start_run(pool) -> None:
        """Reset the family's device counters (GPT-2 has none)."""

    @staticmethod
    def run_stats(pool, peak_pages: int) -> dict:
        return {}

    @staticmethod
    def heads(cfg: GPT2Config) -> int:
        return cfg.num_heads

    def kv_heads(self, cfg) -> int:
        """The heads a token's K/V holds (the chain's tails)."""
        return self.heads(cfg)

    @staticmethod
    def compute_dtype(params) -> torch.dtype:
        return params["wpe"].dtype

    @staticmethod
    def layer_stack(params):
        return gpt2._layer_stack(params)

    def chain_inputs(self, params, toks, pos, window: int, cfg, pool):
        """(x, ctx) of a chained step at positions ``pos``: the embedding
        (wpe clamped to the window's last row) and what its layers read,
        here the window's lower bounds, one for every layer."""
        wpe_pos = torch.clamp(pos, max=window - 1)
        starts = torch.clamp(pos + 1 - window, min=0)
        return self.embed(params, toks, wpe_pos), starts

    @staticmethod
    def chain_read(ctx, tables, pool, i: int):
        """(block table, lower bounds) layer ``i`` reads the pool with."""
        return tables, ctx

    def chain_block(self, x, stack, i: int, cfg, attend, ctx):
        return self.block(x, gpt2._layer(stack, i), cfg, attend)

    @staticmethod
    def commit_coords(pool, pages, slots, positions0, K: int):
        """Layer i -> the (pages, slots) a link's tails commit to."""
        return lambda i: (pages, slots)

    @staticmethod
    def step_counters(pool):
        """The device counters a chained step adds to (none here)."""
        return ()

    @staticmethod
    def embed(params, tokens, wpe_pos):
        return gpt2._embed(params, tokens, wpe_pos)

    @staticmethod
    def block(x, lp, cfg: GPT2Config, attend):
        return gpt2._block(x, lp, cfg, lambda q, k, v: attend(q, k, v)
                           .reshape(*q.shape[:-2], cfg.channels))

    @staticmethod
    def logits(x, params, cfg: GPT2Config):
        return gpt2._logits(x, params, cfg)

    @staticmethod
    def prompt_attention(q, k, v, use_kernel: bool):
        """Causal attention over the in-flight prompt: the flash kernel
        for long bf16 waves (``ops/layers.prefill_attention``)."""
        return L.prefill_attention(q, k, v, use_kernel)

    @staticmethod
    def suffix_kernel(T: int) -> bool:
        """Whether a suffix prefill of T tokens reads the pool through the
        multi-query kernel: any T on one device."""
        return True


SINGLE = SingleDevice()


def _write_prompt(pool_l, k, v, page_ids) -> None:
    """Whole-page prompt writes of (B, T, NH, HS) K/V into one layer, T
    padded to whole pages (int8 pools quantize here)."""
    pad = -k.shape[1] % pool_l[0].shape[3]
    if pad:
        k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (k, v))
    if len(pool_l) == 4:
        write_prompt_pages_quant(pool_l, k, v, page_ids)
    else:
        write_prompt_pages(*pool_l, k, v, page_ids)


@torch.no_grad()
def decode_step_paged(params, tokens, positions, page, slot, block_tables,
                      lengths, pool: PagePool, cfg: GPT2Config,
                      use_kernel: bool = True, starts=None, model=SINGLE):
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
    x = model.embed(params, tokens, positions)
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
            return fn(q.contiguous(), *pool_l, block_tables, lengths, starts)

        x = model.block(x, gpt2._layer(stack, i), cfg, attend)
    return model.logits(x, params, cfg), pool


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
                     starts, pos0, j, use_kernel: bool, quant: bool):
    """Decode-chunk attention: the read-only pool prefix (paged parts)
    merged with the in-flight tail (rows [0, j] valid).

    q (B, NH, HS), or grouped-query (B, G, NKV, HS): the G queries of a
    K/V head, read through the multi-query parts kernel with the group
    as its query tile, so a page is walked once a group; tail_k/tail_v
    (K, B, NKV, HS); lengths_pool = pos0 (completed tokens); starts =
    window lower bounds for the current position; j the step index, a
    0-d device tensor. Returns q's shape in q.dtype."""
    grouped = q.dim() == 4
    HS = q.shape[-1]
    K = tail_k.shape[0]
    if grouped:
        parts = ((paged_decode_attention_quant_parts_mq if quant
                  else paged_decode_attention_parts_mq) if use_kernel
                 else (paged_decode_attention_quant_parts_mq_ref if quant
                       else paged_decode_attention_parts_mq_ref))
    elif use_kernel:
        parts = (paged_decode_attention_quant_parts if quant
                 else paged_decode_attention_parts)
    else:
        parts = (paged_decode_attention_quant_parts_ref if quant
                 else paged_decode_attention_parts_ref)
    acc_p, m_p, l_p = parts(q, *pool_l, block_tables, lengths_pool, starts)

    qf = q.float()
    scale = float(torch.rsqrt(torch.tensor(float(HS))))
    scores = torch.einsum("bghd,kbhd->bghk" if grouped else "bhd,kbhd->bhk",
                          qf, tail_k.float()) * scale
    t_idx = torch.arange(K, device=q.device, dtype=torch.int32)
    pos_t = pos0[:, None] + t_idx[None, :]            # (B, K) absolute pos
    mask = ((t_idx <= j)[None, :] & (pos_t >= starts[:, None]))[:, None, :]
    if grouped:
        mask = mask[:, None]
    scores = torch.where(mask, scores, NEG_INF)
    m_t = scores.amax(dim=-1)                         # (B, NH)
    p = torch.where(mask, torch.exp(scores - m_t[..., None]), 0.0)
    l_t = p.sum(dim=-1)
    acc_t = torch.einsum("bghk,kbhd->bghd" if grouped else "bhk,kbhd->bhd",
                         p, tail_v.float())
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


class _ChainState:
    """The device tensors a chained decode step reads and writes: the
    token it feeds (``toks`` (B,)), the committed lengths (``pos0`` (B,)),
    the block tables, the step index ``j`` (0-d int64: the row of the
    tails and of the outputs the step writes), the in-flight K/V
    ``tails`` (2, L, steps, B, NH, HS) and the picks (``out`` (steps, B)
    int32) with their logprobs (``logps`` (steps, B) f32, or None).

    The tails hold K/V rounded to the serving compute dtype and stored
    in f32, the dtype the tail attention reads them in: a step converts
    its own row once instead of every row of the tail in every layer,
    and the commit rounds the tails back (exactly) once a link."""

    def __init__(self, toks, pos0, tables, steps: int, layers: int,
                 heads: int, head_dim: int, logprobs: bool):
        dev, B = toks.device, toks.shape[0]
        self.toks, self.pos0, self.tables, self.steps = (toks, pos0, tables,
                                                         steps)
        self.j = torch.zeros((), dtype=torch.int64, device=dev)
        self.tails = torch.zeros((2, layers, steps, B, heads, head_dim),
                                 dtype=torch.float32, device=dev)
        self.out = torch.zeros((steps, B), dtype=torch.int32, device=dev)
        self.logps = (torch.zeros((steps, B), dtype=torch.float32,
                                  device=dev) if logprobs else None)

    def load(self, toks, pos0, tables, steps: int) -> None:
        """A link's inputs into the buffers (device to device), the step
        index at 0 and the first ``steps`` rows of the tails zeroed."""
        self.toks.copy_(toks)
        self.pos0.copy_(pos0)
        self.tables.copy_(tables)
        self.j.zero_()
        self.tails[:, :, :steps].zero_()


def _chain_step(params, stack, st: _ChainState, K: int, pool, cfg,
                window: int, use_kernel: bool, quant: bool, model, pick,
                cdtype, logprobs: bool):
    """One step of a K-step chain over ``st``: feeds st.toks at position
    pos0 + j, writes row j of the tails and of the outputs (and, with
    ``logprobs``, of st.logps), feeds the pick back into st.toks and
    advances j. It reads and writes device tensors only, so the graph
    path captures it once and replays it K times; the eager path calls it
    K times."""
    jj = st.j.view(1)
    pos = st.pos0 + st.j
    x, ctx = model.chain_inputs(params, st.toks, pos, window, cfg, pool)
    for i in range(cfg.num_layers):
        tk, tv = st.tails[0, i, :K], st.tails[1, i, :K]

        def attend(q, k, v, i=i, tk=tk, tv=tv):
            tk.index_copy_(0, jj, k[None].to(cdtype).float())
            tv.index_copy_(0, jj, v[None].to(cdtype).float())
            tables, starts = model.chain_read(ctx, st.tables, pool, i)
            return _chunk_attention(
                q.contiguous(), pool.layer(i), tk, tv, tables, st.pos0,
                starts, st.pos0, st.j, use_kernel, quant)

        x = model.chain_block(x, stack, i, cfg, attend, ctx)
    logits = model.logits(x, params, cfg)
    toks = pick(logits)
    st.out[:K].index_copy_(0, jj, toks[None])
    if logprobs:
        lf = logits.float()
        lp = (torch.gather(lf, 1, toks.long()[:, None])[:, 0]
              - torch.logsumexp(lf, dim=-1))
        st.logps[:K].index_copy_(0, jj, lp[None])
    st.toks.copy_(toks)
    st.j.add_(1)


def graph_eligible(device, use_kernel: bool, rng, pen_counts, model) -> bool:
    """Whether a decode_chunk_paged call replays a CUDA graph of its step:
    on the card, through the kernels, greedy (a sampled chain's
    torch.Generator is not registered with a graph), with no penalty
    plane, on a one-device model (``graphs``; a tensor-parallel step
    holds collectives). Every other call runs the step eagerly."""
    return (torch.device(device).type == "cuda" and use_kernel
            and rng is None and pen_counts is None
            and getattr(model, "graphs", False))


@torch.no_grad()
def decode_chunk_paged(params, first_tokens, positions0, pages, slots,
                       block_tables, pool: PagePool, cfg: GPT2Config,
                       num_steps: int, window: int, use_kernel: bool = True,
                       rng=None, top_k=None, temperature=1.0, k_arr=None,
                       greedy_rows=None, want_logprobs: bool = False,
                       pen_counts=None, freq_pen=None, pres_pen=None,
                       model=SINGLE, graphs: DecodeGraphs | None = None):
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

    ``graphs``: a DecodeGraphs cache. Where ``graph_eligible`` holds, the
    step (``_chain_step``) is captured once as a CUDA graph and replayed
    num_steps times over the cache's static buffers; the same kernels run
    in the same order on the same data, so tokens, logprobs and the pool
    equal the eager path's bit for bit.

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
    coords = model.commit_coords(pool, pages, slots, positions0, num_steps)
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
    B, K = toks.shape[0], num_steps
    NH, HS = model.kv_heads(cfg), cfg.head_dim
    quant = pool.quant
    stack = model.layer_stack(params)
    cdtype = model.compute_dtype(params)    # the serving compute dtype

    def pick(logits):
        picked = _pick(logits, counts, rng, top_k, temperature, k_arr,
                       greedy_rows, freq_pen, pres_pen)
        if counts is not None:
            counts.scatter_add_(1, picked.long()[:, None],
                                torch.ones_like(picked)[:, None])
        return picked

    if graphs is not None and graph_eligible(dev, use_kernel, rng,
                                             pen_counts, model):
        graphs.bind(params, pool, cfg)
        st = graphs.buffers(
            tuple(block_tables.shape), K,
            lambda n: _ChainState(
                torch.zeros_like(toks), torch.zeros_like(safe_pos0),
                torch.zeros_like(block_tables), n, cfg.num_layers, NH, HS,
                logprobs=True))
        g = graphs.graph(
            (*block_tables.shape, window, want_logprobs), K,
            lambda k: _chain_step(params, stack, st, k, pool, cfg, window,
                                  use_kernel, quant, model, pick, cdtype,
                                  want_logprobs),
            st.j.zero_, dev, keep=model.step_counters(pool))
        st.load(toks, safe_pos0, block_tables, K)
        graphs.replay(g, K)
        out = st.out[:K].clone()
        logps = st.logps[:K].clone() if want_logprobs else None
    else:
        # the step writes its picks into st.toks: a token tensor of the
        # caller (a previous link's output row) is copied first
        st = _ChainState(toks.clone(), safe_pos0, block_tables, K,
                         cfg.num_layers, NH, HS, want_logprobs)
        for _ in range(K):
            # the host time to enqueue one chained decode step
            with span("model.step"):
                _chain_step(params, stack, st, K, pool, cfg, window,
                            use_kernel, quant, model, pick, cdtype,
                            want_logprobs)
        out, logps = st.out, st.logps

    # commit the chunk's K/V, one indexed write per layer (int8 pools
    # quantize here, once), in the compute dtype the tails were rounded to
    for i in range(cfg.num_layers):
        tk, tv = (t.to(cdtype) for t in (st.tails[0, i, :K],
                                          st.tails[1, i, :K]))
        pg, sl = coords(i)
        if quant:
            commit_layer_kv_quant(pool.layer(i), tk, tv, pg, sl)
        else:
            commit_layer_kv(*pool.layer(i), tk, tv, pg, sl)
    ret = (out,)
    if counts is not None:
        ret += (counts,)
    if want_logprobs:
        ret += (logps,)
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
                      use_kernel: bool = True, *, active, model=SINGLE):
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
    NH, HS = model.heads(cfg), cfg.head_dim
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
        x = model.embed(params, torch.clamp(inputs, min=0), wpe_pos)
        ridx = (t_off[:, None] + karange[None, :]).T.long()  # (K, B)
        for i in range(cfg.num_layers):
            def attend(q, k, v, i=i):                       # (B, K, NH, HS)
                tks[i][ridx, barange[None, :]] = k.transpose(0, 1).to(cdtype)
                tvs[i][ridx, barange[None, :]] = v.transpose(0, 1).to(cdtype)
                return _spec_tail_attention(q.contiguous(), pool.layer(i),
                                            tks[i], tvs[i], block_tables,
                                            pos0, t_off, use_kernel, quant)

            x = model.block(x, gpt2._layer(stack, i), cfg, attend)
        o = torch.argmax(model.logits(x, params, cfg), dim=-1).int()

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
                  cfg: GPT2Config, last_pos=None, use_kernel: bool = True,
                  model=SINGLE, rows=None):
    """Prompt forward that writes all T tokens' K/V into the pool.

    tokens (B, T) right-padded prompts; page (B, T) pool page per token
    (num_pages on padding → dropped). PRECONDITION: prompts start at
    position 0 of freshly allocated pages, so token t's slot is
    t % page_size; ``slot`` and ``rows`` (each row's engine slot, which
    another family's pool reads) are accepted for signature symmetry only.
    Attention is causal over the in-flight K/V (``model.prompt_attention``;
    on one device the flash kernel for long bf16 waves, dense otherwise
    or with ``use_kernel=False``). ``last_pos`` (B,):
    project logits only at each row's position last_pos[b] → (B, V);
    None → (B, T, V). Returns (logits, pool)."""
    del slot, rows
    dev = _dev(params)
    tokens = to_device(tokens, dev)
    B, T = tokens.shape
    x = model.embed(params, tokens, torch.arange(T, device=dev)[None])
    stack = gpt2._layer_stack(params)
    page_ids = prompt_page_ids(page, T, pool.page_size, pool.num_pages)

    for i in range(cfg.num_layers):
        def attend(q, k, v, i=i):                       # (B, T, NH, HS)
            _write_prompt(pool.layer(i), k, v, page_ids)
            qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
            att = model.prompt_attention(qh, kh, vh, use_kernel)
            return att.transpose(1, 2)

        x = model.block(x, gpt2._layer(stack, i), cfg, attend)

    if last_pos is not None:
        x = x[torch.arange(B, device=dev), to_device(last_pos, dev).long()]
    return model.logits(x, params, cfg), pool


@torch.no_grad()
def prefill_suffix_paged(params, tokens, page, slot, pool: PagePool,
                         block_tables, pool_len, cfg: GPT2Config, last_pos,
                         use_kernel: bool = True, model=SINGLE):
    """Prefill of a prompt SUFFIX whose prefix is already resident in the
    pool (prefix caching, PageConfig.prefix_cache): suffix token j of row
    b sits at absolute position pool_len[b] + j and attends the cached
    prefix THROUGH THE BLOCK TABLE (multi-query parts: one page walk
    scores a tile of suffix queries, the speculative-verify read path)
    plus the suffix itself causally, merged online-softmax. On one device
    any suffix length goes through the kernel on the card
    (``model.suffix_kernel``).

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
    x = model.embed(params, tokens,
                    torch.clamp(pos, max=cfg.max_seq_len - 1))
    quant = isinstance(pool, QuantPagePool)
    stack = gpt2._layer_stack(params)
    page_ids = prompt_page_ids(page, T, pool.page_size, pool.num_pages)
    t_off = torch.zeros(B, dtype=torch.int32, device=dev)
    use_k = use_kernel and model.suffix_kernel(T)

    for i in range(cfg.num_layers):
        def attend(q, k, v, i=i):                       # (B, T, NH, HS)
            _write_prompt(pool.layer(i), k, v, page_ids)
            return _spec_tail_attention(q.contiguous(), pool.layer(i),
                                        k.transpose(0, 1), v.transpose(0, 1),
                                        block_tables, pool_len, t_off,
                                        use_k, quant)

        x = model.block(x, gpt2._layer(stack, i), cfg, attend)

    x = x[torch.arange(B, device=dev), to_device(last_pos, dev).long()]
    return model.logits(x, params, cfg), pool
