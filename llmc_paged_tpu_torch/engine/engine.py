"""L4: the inference engine (port of llmc_paged_tpu/engine/engine.py): the
reference's three decode paths as one engine (infer.c / cached_infer.c /
paged_infer.c mains), plus continuous batching on the paged path.

``generate`` dispatches on EngineConfig.cache_mode: "none" recomputes the
full forward over the trailing window each step, "dense" decodes over a
contiguous KV cache, "paged" runs one request through ``run``.

Sampling is on the host by default, as in the reference
(train_gpt2.cu:1238-1239): the xorshift parity ``Sampler`` (greedy, top-k,
temperature, and per-request overrides), one RNG stream consumed per
stochastic row in row order. Greedy rows pick on the device and ship 4
bytes; top-k ships a (N, k') prefix of each row; the plain parity sampler
ships the softmax. With EngineConfig.device_sampling, decode chunks draw
on the device from a torch.Generator seeded with EngineConfig.seed (not
bit-parity with the xorshift stream), so a sampled batch chains as a
greedy one does. Requests may ask for raw-softmax logprobs of their
tokens (and of their prompt) and for frequency/presence penalties over
their full context.

Continuous batching over the paged pool:
  * admission waves, each cut by its rows' lengths into a few padded
    prefill calls (``_subwaves``: rows sorted by 16-token bucket, each
    call padded to its own longest row's bucket and holding exactly its
    rows, a cut made where it saves more than PREFILL_CALL_SLOTS padded
    token slots; logits only at each row's last prompt position), all
    queued before any copy to the host, their outputs put back in
    admission order on the device; greedy first tokens are picked on the
    device and fetched after the first decode link is queued, sampled
    ones are drawn at admission;
  * sliding-window page reclamation;
  * chains of K-step decode chunks (a batch whose rows are all
    effectively greedy, or any batch under device sampling): pages
    reserved K tokens ahead, a free-page guard so no eviction happens
    mid-chain, tokens (and a penalty count plane) fed back on the device
    between links, and ONE device→host copy per chain (tokens and
    logprobs together);
  * a single-token step when no chain can run (every step of a batch
    with a host-sampled row: the host stream cannot feed back on the
    device), with LRU preemption and requeue of the victims;
  * stop tokens;
  * speculative decode (EngineConfig.spec_k >= 2): chains of verify
    chunks, each step scoring the carried token plus n-gram drafts; the
    host reserves S*spec_k tokens a row a link and rolls back with
    truncate_to once the chain materializes;
  * prefix caching (PageConfig.prefix_cache): a persistent
    PrefixCachingBlockManager shares full prompt pages by content; an
    admitted row adopts its longest cached prefix and only its suffix is
    prefilled (prefill_suffix_paged).

Block managers: kv.native.make_block_manager builds the C++ twin
(csrc/block_manager.cpp) when it builds, else the Python one;
``native_manager`` True/False forces one (True raises when the library
cannot be built).

Serving: ``run(feed=..., on_tokens=...)`` is the long-lived loop of
engine/server.ServingEngine (arrivals join at the next admission wave,
streaming flushes, cancellation, a live stats snapshot).

Host↔device traffic per link: a few int32 metadata arrays go up through
pinned memory without blocking (first tokens, positions, page/slot
coordinates, block tables; a speculative link uploads only its block
tables and its active-row mask); tokens (and logprobs, or a speculative
chain's acceptance counts) come down once per chain. A greedy chain on
one card replays each step as a CUDA graph (models/decode_graphs.py):
the engine's ``DecodeGraphs`` captures every chain length it can ask for
at the first such chain, and ``stats["decode_graph_steps"]`` counts the
steps that replayed.

Model families: ``InferenceEngine._load`` alone reads the config's type
and chooses the engine's model object (``self._model``:
``gpt2_paged.SINGLE``, ``sharding.TPModel``, or ``mellum_paged.MODEL``
with a full-layer pool beside the sliding layers' window rings), which
answers the rest: its device entries' module, pool, refusals and run
counters. Mellum serves the paged mode alone, with float weights; other
options and ``run(window=...)`` raise a ValueError naming the family.
A run is a ``_Run``, whose ``deliver`` hands every token to its request.

Tensor parallelism (EngineConfig.mesh_shape, ``{"model": m}`` or
``{"data": d, "model": m}``; parallel/sharding.py): the engine runs in
each rank of a torch.distributed group of d·m ranks, on the rank's card
(``cuda:LOCAL_RANK`` by default). The paged path runs on this rank's
shard of the weights (NH/m heads, Vp/m vocab rows) and its own pool of
NH/m heads, through the same model functions with the TP model pieces
(``sharding.TPModel``); the scheduler and block managers stay host-side
and run the same schedule on every rank, so every rank returns the
same tokens. As in the JAX package, logprobs, prompt logprobs,
penalties and per-request sampling overrides are refused under TP; the
"none" and "dense" modes run on the whole model on each rank.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from llmc_paged_tpu_torch import resolve_device
from llmc_paged_tpu_torch.config import (
    EngineConfig,
    GPT2Config,
    MellumConfig,
    PageConfig,
)
from llmc_paged_tpu_torch.engine.scheduler import Request, Scheduler, State
from llmc_paged_tpu_torch.kv import native
from llmc_paged_tpu_torch.kv.layouts import to_device, token_coords
from llmc_paged_tpu_torch.models import gpt2, gpt2_paged, mellum, mellum_paged
from llmc_paged_tpu_torch.models.decode_graphs import DecodeGraphs
from llmc_paged_tpu_torch.ops.int8 import quantize_params
from llmc_paged_tpu_torch.parallel import sharding
from llmc_paged_tpu_torch.sampler import (
    Sampler,
    reconstruct_topk_row,
    sample_mult,
    topk_probs,
)
from llmc_paged_tpu_torch.utils import spans
from llmc_paged_tpu_torch.utils.spans import span

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _bucket(n: int, step: int = 16) -> int:
    """Pad prefill lengths to buckets (bounded shape variety)."""
    return max(step, ((n + step - 1) // step) * step)


# the padded token slots one more prefill call is worth: a wave is cut
# into another call only where that saves more slots than this
PREFILL_CALL_SLOTS = 2048


def _subwaves(lengths: Sequence[int]) -> List[List[int]]:
    """An admission wave's rows (their prefill lengths) cut into prefill
    calls, each padded to its own longest row's 16-token bucket and
    holding exactly its rows. The rows, sorted by bucket, are cut between
    buckets where that minimises Σ rows·bucket + PREFILL_CALL_SLOTS per
    call (dynamic programming over the distinct buckets). Returns the
    calls' row indices, each call in row order, the longest call first;
    a wave of one bucket is one call."""
    buckets = sorted({_bucket(n) for n in lengths})
    count = collections.Counter(_bucket(n) for n in lengths)
    rows = [0]                  # rows[j]: the rows of the first j buckets
    for b in buckets:
        rows.append(rows[-1] + count[b])
    # best[j]: the least cost of the first j buckets' rows; cut[j]: where
    # the last call of that best starts (the first, so the widest, of ties)
    best, cut = [0], [0]
    for j in range(1, len(buckets) + 1):
        costs = [best[i] + (rows[j] - rows[i]) * buckets[j - 1]
                 + PREFILL_CALL_SLOTS for i in range(j)]
        best.append(min(costs))
        cut.append(costs.index(best[j]))
    calls, j = [], len(buckets)
    while j:
        members = set(buckets[cut[j]:j])
        calls.append([r for r, n in enumerate(lengths)
                      if _bucket(n) in members])
        j = cut[j]
    return calls


def _host(t: torch.Tensor) -> np.ndarray:
    """Device logits or probabilities → f32 numpy on the host."""
    return t.float().cpu().numpy()


def _sample_rows(sampler: Sampler, logits, n: int) -> List[int]:
    """Sample the first n rows of (N, V) device logits with one batched
    device reduction and transfer; the greedy/top-k/parity dispatch lives
    here only. Greedy ships 4 bytes a row, top-k each row's prefix, a
    temperature alone the rows, the parity sampler their softmax."""
    if sampler.greedy:
        picks = torch.argmax(logits, dim=-1).cpu().numpy()
        return [int(picks[i]) for i in range(n)]
    if sampler.transforms_logits and sampler.top_k:
        return _sample_rows_topk(sampler, logits, n)
    if sampler.transforms_logits:
        rows = _host(logits)
        return [sampler.sample_logits(rows[i]) for i in range(n)]
    probs = _host(torch.softmax(logits, dim=-1))
    return [sampler.sample(probs[i]) for i in range(n)]


def _sample_rows_topk(sampler: Sampler, logits, n: int) -> List[int]:
    """Top-k host sampling from a device-computed top-k prefix: ships
    2·(N, k') instead of (N, V) values while the sampled tokens stay
    BIT-EXACT against the full-row path (reconstruct_topk_row feeds the
    identical fp32 transform). A row whose shipped boundary ties the k-th
    value (an unshipped entry could equal it, and the transform keeps
    ties) downloads its full row instead."""
    V = logits.shape[-1]
    kship = min(max(2 * sampler.top_k, sampler.top_k + 16), V)
    if kship >= V:
        rows = _host(logits)
        return [sampler.sample_logits(rows[i]) for i in range(n)]
    vals_d, idx_d = torch.topk(logits, kship, dim=-1)
    vals, idx = _host(vals_d), idx_d.cpu().numpy()
    out = []
    for i in range(n):
        kth = vals[i, sampler.top_k - 1]
        if vals[i, -1] >= kth:      # boundary tie may extend past the ship
            row = _host(logits[i])
        else:
            row = reconstruct_topk_row(vals[i], idx[i], V)
        out.append(sampler.sample_logits(row))
    return out


def _effective(sampler: Sampler, req: Request) -> Tuple[bool,
                                                        Optional[int],
                                                        float]:
    """A request's sampling overrides resolved against the engine sampler:
    (greedy, top_k, temperature). temperature 0 means greedy (the Sampler
    idiom); invalid values were rejected by validate_request."""
    g = sampler.greedy if req.greedy is None else req.greedy
    tk = sampler.top_k if req.top_k is None else req.top_k
    tmp = sampler.temperature if req.temperature is None else req.temperature
    if tmp == 0:
        g, tmp = True, 1.0
    return g, tk, tmp


def _has_overrides(req: Request) -> bool:
    return (req.greedy is not None or req.top_k is not None
            or req.temperature is not None)


def _has_penalties(req: Request) -> bool:
    return bool(req.frequency_penalty or req.presence_penalty)


def _penalized_row(row: np.ndarray, req: Request) -> np.ndarray:
    """Host twin of the device chunk's penalty subtraction: counts over
    the FULL context (prompt + generated so far)."""
    V = row.shape[-1]
    cnt = np.zeros(V, np.float32)
    np.add.at(cnt, np.clip(np.asarray(req.tokens), 0, V - 1), 1.0)
    return (row.astype(np.float32) - req.frequency_penalty * cnt
            - req.presence_penalty * (cnt > 0))


def _fetch(ints: torch.Tensor, floats: Optional[torch.Tensor]):
    """ONE device→host copy of an int32 tensor and an optional f32 tensor
    of the same shape (the floats travel as their int32 bit patterns).
    Returns (ints, floats|None) as numpy arrays."""
    if floats is None:
        return ints.cpu().numpy(), None
    both = torch.stack([ints.int(), floats.float().view(torch.int32)])
    both = both.cpu().numpy()
    return both[0], both[1].view(np.float32)


def _sample_rows_per_request(sampler: Sampler, logits,
                             reqs: List[Request]) -> List[int]:
    """Per-row transforms for mixed batches (some request overrides
    greedy/top_k/temperature, or sets penalties): each stochastic row
    draws from the SHARED engine RNG stream in row order; greedy rows
    consume nothing. Ships full rows. Draws bypass Sampler.sample (its
    greedy flag would turn an explicit non-greedy override into argmax),
    and transform-free rows use the same device softmax as _sample_rows,
    so a row WITHOUT overrides samples bit-identically to a uniform
    batch. A penalized row picks from its penalized logits."""
    eff = [_effective(sampler, r) for r in reqs]
    rows = _host(logits)
    plain = any(not g and tk is None and tmp == 1.0
                and not _has_penalties(r)
                for (g, tk, tmp), r in zip(eff, reqs))
    probs = _host(torch.softmax(logits, dim=-1)) if plain else None
    out = []
    for i, (g, tk, tmp) in enumerate(eff):
        req = reqs[i]
        row = (rows[i] if not _has_penalties(req)
               else _penalized_row(rows[i], req))
        if g:
            out.append(int(np.argmax(row)))
        elif tk is None and tmp == 1.0 and not _has_penalties(req):
            out.append(sample_mult(probs[i], sampler.rng.random_f32()))
        else:
            out.append(sample_mult(topk_probs(row, tk, tmp),
                                   sampler.rng.random_f32()))
    return out


def _row_logprob(row: np.ndarray, tok: int) -> float:
    """Chosen token's logprob under the raw softmax of one (V,) logits
    row: the host twin of the device chunk's logsumexp gather."""
    row = np.asarray(row, np.float32)
    m = float(row.max())
    return float(row[tok] - m
                 - np.log(np.exp(row - m, dtype=np.float32)
                          .sum(dtype=np.float32)))


def _prefill_plp_extract(full, xs, valid, last):
    """From full-T prefill logits (B, T, V): the last-position logits
    (B, V) for the first pick, and each next token's RAW-softmax logprob
    (B, T-1): tok_lp[b, t] scores xs[b, t+1] given xs[b, :t+1]."""
    dev = full.device
    xs, valid, last = (to_device(a, dev) for a in (xs, valid, last))
    lg = full[:, :-1].float()
    tok_lp = (torch.gather(lg, 2, xs[:, 1:, None].long())[..., 0]
              - torch.logsumexp(lg, dim=-1))
    tok_lp = torch.where(valid[:, 1:], tok_lp, 0.0)
    last_logits = full[torch.arange(full.shape[0], device=dev),
                       last.long()]
    return last_logits, tok_lp


def _in_admission_order(parts):
    """A wave's prefill calls' outputs, ``parts`` = [(rows, (b, V) logits,
    (b, Tb-1) prompt logprobs | None)] with ``rows`` the calls' wave row
    indices, as ONE (rows, V) logits tensor and, where a call took prompt
    logprobs, ONE (rows, W) tensor of them (W the widest such call's; zeros
    past a row's own, and in a call without them), both in admission
    order on the device."""
    if len(parts) == 1:
        return parts[0][1], parts[0][2]
    order = [i for rows, _, _ in parts for i in rows]
    inv = to_device(torch.from_numpy(np.argsort(order)), parts[0][1].device)
    logits = torch.cat([lg for _, lg, _ in parts])[inv]
    if all(lp is None for _, _, lp in parts):
        return logits, None
    width = max(lp.shape[1] for _, _, lp in parts if lp is not None)
    plp = torch.cat([
        torch.nn.functional.pad(lp, (0, width - lp.shape[1]))
        if lp is not None
        else lg.new_zeros((len(rows), width), dtype=torch.float32)
        for rows, lg, lp in parts])[inv]
    return logits, plp


def _validate_indices(page_cfg: PageConfig, tables: np.ndarray,
                      pgs: Optional[np.ndarray] = None,
                      sls: Optional[np.ndarray] = None,
                      lengths: Optional[np.ndarray] = None) -> None:
    """Host-side bounds check of every device index
    (EngineConfig.debug_checks); page == num_pages is the drop sentinel."""
    if not (tables.min() >= 0 and tables.max() < page_cfg.num_pages):
        raise ValueError("block table entry out of range")
    if pgs is not None and not (pgs.min() >= 0
                                and pgs.max() <= page_cfg.num_pages):
        raise ValueError("page coordinate out of range")
    if sls is not None and not (sls.min() >= 0
                                and sls.max() < page_cfg.page_size):
        raise ValueError("slot out of range")
    if lengths is not None and not (
            lengths.min() >= 0 and lengths.max() <= page_cfg.max_context):
        raise ValueError("length exceeds table")


def _chain_lengths(decode_chunk: int) -> Tuple[int, ...]:
    """Every length a plain chain link can take: decode_chunk, a quarter
    of it (a short remaining context or page-blocked admission) and a
    sixteenth (both)."""
    dc = max(1, decode_chunk)
    return tuple(sorted({k for k in (dc, dc // 4, dc // 16) if k > 1}))


def _chain_length(decode_chunk: int, cap: int, blocked: bool) -> int:
    """A plain chain's link length of ``_chain_lengths(decode_chunk)``:
    the longer that ``cap`` (the fullest row's context left) fits of
    decode_chunk and a quarter, a quarter and a sixteenth when admission
    is page-blocked; 1 (a single-token step) when neither fits."""
    tiers = _chain_lengths(decode_chunk)[::-1][int(blocked):][:2]
    return next((k for k in tiers if k <= cap), 1)


def _check_window(window: Optional[int], cfg: GPT2Config) -> int:
    """Reject windows the position embedding cannot serve."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    window = window or cfg.max_seq_len
    if window > cfg.max_seq_len:
        raise ValueError(f"window {window} > max_seq_len {cfg.max_seq_len} "
                         "(position-embedding rows)")
    return window


class InferenceEngine:
    """GPT-2 serving on one device: the card unless ``device`` says
    otherwise (``device=None`` raises when no GPU is present; under
    tensor parallelism it is ``cuda:LOCAL_RANK``).
    ``use_kernel=False`` selects the plain PyTorch attention instead of the
    CUDA kernels (the yardstick route). ``native_manager``: None takes
    the native C++ block manager when it builds, else the Python one;
    True or False forces one (True raises ImportError without it)."""

    def __init__(self, params, cfg: GPT2Config,
                 econf: Optional[EngineConfig] = None, device=None,
                 use_kernel: bool = True,
                 native_manager: Optional[bool] = None):
        self.cfg = cfg
        self.econf = econf or EngineConfig()
        self.use_kernel = use_kernel
        self.native_manager = native_manager
        self.stats: Dict[str, object] = {}
        # live snapshot for long-lived serving runs (self.stats is written
        # only when run() returns): rebuilt as a whole dict at every
        # scheduler iteration, so readers on other threads never see a
        # partial update; host bookkeeping only
        self.live_stats: Dict[str, float] = {}
        # the pool is kept across run() calls: stale contents are never
        # read (tables and lengths only cover tokens of the current run)
        self._pool_cache = None
        # prefix caching: the manager persists across run() calls together
        # with the pool whose pages it describes
        self._prefix_mgr = None
        # CUDA graphs of the greedy chained step, over the pool above
        self._decode_graphs = DecodeGraphs(
            _chain_lengths(self.econf.decode_chunk))
        self._load(params, device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _load(self, params, device) -> None:
        """The model family: the config's type and the mesh choose the
        model object (its refusals checked before the config's own); its
        weights go to the device (``params``, the whole model; its bf16
        prefill copy; the weights the decode and prompt calls take)."""
        cfg, econf = self.cfg, self.econf
        model = (mellum_paged.MODEL if isinstance(cfg, MellumConfig)
                 else gpt2_paged.SINGLE)
        model.refuse(econf, device)
        self._check_config()
        if device is None and econf.mesh_shape:
            device = f"cuda:{sharding.local_rank()}"
        self.device = resolve_device(device)
        self.mesh = None
        self._model = model
        self.params = self._prefill_params = None
        if model is mellum_paged.MODEL:
            # bf16 or f32 weights, taken as they are
            self.params = self._decode_params = self._prompt_params = \
                mellum.prepare_params(params, cfg, _DTYPES[econf.param_dtype],
                                      self.device)
            return
        quantized = str(params["wte"].dtype).endswith("int8")
        if econf.prefill_param_dtype is not None:
            if econf.prefill_param_dtype != "bfloat16":
                raise ValueError("prefill_param_dtype: only 'bfloat16' is "
                                 f"supported, got "
                                 f"{econf.prefill_param_dtype!r}")
            if econf.param_dtype != "int8" or quantized:
                raise ValueError(
                    "prefill_param_dtype requires param_dtype='int8' with "
                    "FLOAT input params (it splits prefill/decode dtypes)")
        # the whole model on the device: the paged path's weights on one
        # device, and under tensor parallelism only for the "none" and
        # "dense" modes, which run it on each rank
        if not econf.mesh_shape or econf.cache_mode != "paged":
            self._whole_model(params, quantized)
        # the paged path's weights and model pieces: the whole model, or
        # under tensor parallelism this rank's shard, prepared from the
        # caller's FLOAT params in the TP layout (and quantized there) on
        # the host, so that only the shard reaches the rank's device
        self._decode_params = self.params
        self._prompt_params = self._prefill_params or self.params
        if econf.mesh_shape:
            self.mesh = sharding.make_mesh(
                model=int(econf.mesh_shape.get("model", 1)),
                data=int(econf.mesh_shape.get("data", 1)))
            self._model = sharding.TPModel(cfg, self.mesh)
            self._decode_params = self._prompt_params = \
                sharding.prepare_tp_params(
                    params, cfg, self.mesh, param_dtype=econf.param_dtype,
                    activation_dtype=econf.activation_dtype,
                    device=self.device)
            if econf.prefill_param_dtype is not None:
                self._prompt_params = sharding.prepare_tp_params(
                    params, cfg, self.mesh, param_dtype="bfloat16",
                    device=self.device)

    def _whole_model(self, params, quantized: bool) -> None:
        """``self.params`` (and the bf16 prefill copy) on the device."""
        econf = self.econf
        # int8 keeps the non-quantized leaves at activation_dtype
        dtype = _DTYPES[econf.activation_dtype if econf.param_dtype == "int8"
                        else econf.param_dtype]
        self.params = gpt2.to_device(params, self.cfg, dtype, self.device)
        # the bf16 prefill copy is taken from the float params BEFORE
        # quantization; layernorm parameters stay fp32
        if econf.prefill_param_dtype is not None:
            self._prefill_params = {
                k: (v.to(torch.bfloat16)
                    if k not in gpt2.LN_KEYS and v.dtype == torch.float32
                    else v)
                for k, v in self.params.items()}
        # int8 weights are quantized from the weights AFTER the cast to the
        # activation dtype
        if econf.param_dtype == "int8" and not quantized:
            self.params = quantize_params(self.params)

    def _check_config(self) -> None:
        econf, page = self.econf, self.econf.page
        if econf.cache_mode not in ("none", "dense", "paged"):
            raise ValueError(f"cache_mode {econf.cache_mode!r}")
        if econf.spec_k >= 2 and not econf.greedy:
            raise ValueError(
                "spec_k requires greedy serving: speculative verification "
                "accepts argmax matches; rejection sampling for the "
                "stochastic samplers is not implemented")
        if econf.mesh_shape:
            if set(econf.mesh_shape) - {"data", "model"}:
                raise ValueError(f"mesh_shape {econf.mesh_shape}: the axes "
                                 "are 'data' and 'model'")
            sharding.require_group(
                f"mesh_shape={econf.mesh_shape}",
                int(econf.mesh_shape.get("model", 1))
                * int(econf.mesh_shape.get("data", 1)))
        if econf.param_dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(f"param_dtype {econf.param_dtype!r}")
        if econf.activation_dtype not in _DTYPES:
            raise ValueError(f"activation_dtype {econf.activation_dtype!r}")
        if page.kv_dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(f"kv_dtype {page.kv_dtype!r}")

    def _default_sampler(self) -> Sampler:
        """The EngineConfig-derived sampler (one construction point)."""
        return Sampler(self.econf.seed, self.econf.greedy,
                       top_k=self.econf.top_k,
                       temperature=self.econf.temperature)

    # -- mode "none": full recompute with sliding window (infer.c) ----------

    def generate_nocache(self, prompt: Sequence[int], max_new_tokens: int,
                         window: Optional[int] = None,
                         sampler: Optional[Sampler] = None) -> List[int]:
        """infer.c semantics: re-run the full forward over the last
        ``window`` tokens each step (phase-2 slide, infer.c:104-127). The
        JAX package pads the context to a 16-token bucket against
        recompiles; eager PyTorch has none, so the context is not padded
        (causal attention makes the last position's logits the same)."""
        window = _check_window(window, self.cfg)
        sampler = sampler or self._default_sampler()
        stops = self.econf.stop_tokens
        toks = list(prompt)
        for _ in range(max_new_tokens):
            ctx = torch.tensor([toks[-window:]], dtype=torch.int32)
            logits = gpt2.forward(self.params, ctx, self.cfg)
            toks.append(_sample_rows(sampler, logits[0, -1:], 1)[0])
            if stops and toks[-1] in stops:
                break
        return toks

    # -- mode "dense": contiguous KV cache (cached_infer.c) -----------------

    def generate_dense(self, prompt: Sequence[int], max_new_tokens: int,
                       window: Optional[int] = None,
                       sampler: Optional[Sampler] = None) -> List[int]:
        """cached_infer.c semantics: prefill once, then one-token steps.
        When ``window`` is set and the sequence outgrows it, attention is
        masked to the trailing window and the position embedding clamps to
        window-1 (the cache-pointer bump of cached_infer.c:606: every
        post-window token is computed as the last position of its
        window). The cache holds the serving compute dtype."""
        cfg = self.cfg
        window = _check_window(window, cfg)
        if max_new_tokens <= 0:
            return list(prompt)
        # a prompt longer than the window attends only to its trailing
        # `window` tokens (mode-"none" parity); cache positions are
        # relative to the dropped base
        base = max(0, len(prompt) - window)
        total = len(prompt) - base + max_new_tokens
        sampler = sampler or self._default_sampler()
        stops = self.econf.stop_tokens
        cache = gpt2.init_cache(cfg, 1, total, dtype=self.params["wpe"].dtype,
                                device=self.device)
        toks = list(prompt)
        logits, cache = gpt2.prefill(
            self.params, torch.tensor([toks[base:]], dtype=torch.int32),
            cache, cfg, use_kernel=self.use_kernel)
        toks.append(_sample_rows(sampler, logits[0, -1:], 1)[0])
        for _ in range(max_new_tokens - 1):
            if stops and toks[-1] in stops:
                break
            pos = len(toks) - 1 - base
            logits, cache = gpt2.decode_step(
                self.params, torch.tensor([toks[-1]], dtype=torch.int32),
                torch.tensor([pos]), cache, cfg,
                wpe_pos=torch.tensor([min(pos, window - 1)]),
                starts=torch.tensor([max(0, pos + 1 - window)]))
            toks.append(_sample_rows(sampler, logits, 1)[0])
        return toks

    # -- mode "paged": block-table KV + continuous batching ------------------

    def generate_paged(self, prompt: Sequence[int], max_new_tokens: int,
                       window: Optional[int] = None,
                       sampler: Optional[Sampler] = None) -> List[int]:
        """Single-sequence paged decode (paged_infer.c main semantics,
        including its sliding-window `offset` when ``window`` is set)."""
        reqs = [Request(rid=0, prompt=list(prompt),
                        max_new_tokens=max_new_tokens)]
        out = self.run(reqs, window=window, sampler=sampler)
        return out[0].tokens

    def generate(self, prompt: Sequence[int], max_new_tokens: int,
                 window: Optional[int] = None,
                 sampler: Optional[Sampler] = None) -> List[int]:
        """prompt + generated tokens through EngineConfig.cache_mode."""
        fn = {"none": self.generate_nocache,
              "dense": self.generate_dense,
              "paged": self.generate_paged}[self.econf.cache_mode]
        return fn(prompt, max_new_tokens, window=window, sampler=sampler)

    def validate_request(self, req: Request,
                         window: Optional[int] = None) -> None:
        """Raise ValueError if ``req`` could never be scheduled, asks for
        invalid sampling values, or asks for an option this engine's
        configuration cannot serve (the JAX package's gates and
        messages). run() applies this to every request; a serving front
        calls it at submission so a bad request fails its own future."""
        econf = self.econf
        page = econf.page
        window = _check_window(window, self.cfg)
        if not req.prompt:
            raise ValueError(f"request {req.rid} has an empty prompt")
        if req.temperature is not None and not (
                0 <= req.temperature < float("inf")):
            # the `not (x >= 0)` form also rejects NaN
            raise ValueError(f"request {req.rid}: temperature must be "
                             f"finite and >= 0, got {req.temperature}")
        if req.top_k is not None and req.top_k < 1:
            raise ValueError(f"request {req.rid}: top_k must be >= 1, "
                             f"got {req.top_k}")
        if req.logprobs or req.prompt_logprobs:
            name = "logprobs" if req.logprobs else "prompt_logprobs"
            if not econf.serve_logprobs:
                raise ValueError(
                    f"request {req.rid}: logprobs are disabled on this "
                    "engine (EngineConfig.serve_logprobs / CLI "
                    "--no-logprobs)")
            if self.mesh is not None:
                raise ValueError(f"request {req.rid}: {name} under tensor "
                                 "parallelism are not supported yet")
            if req.logprobs and econf.spec_k >= 2:
                raise ValueError(
                    f"request {req.rid}: logprobs under speculative "
                    "decoding are not supported (acceptance-variable "
                    "verify steps)")
            if econf.cache_mode != "paged":
                raise ValueError(
                    f"request {req.rid}: {name} require paged serving")
        if req.prompt_logprobs:
            if page.prefix_cache:
                raise ValueError(
                    f"request {req.rid}: prompt_logprobs with prefix "
                    "caching are not supported (adopted prefix pages "
                    "skip their prefill, so those positions' logits "
                    "never exist)")
            if len(req.prompt) > window:
                raise ValueError(
                    f"request {req.rid}: prompt_logprobs need the whole "
                    f"prompt attended — prompt {len(req.prompt)} > "
                    f"window {window}")
        if _has_penalties(req):
            for name in ("frequency_penalty", "presence_penalty"):
                v = getattr(req, name)
                if not (float("-inf") < v < float("inf")):
                    raise ValueError(f"request {req.rid}: {name} must be "
                                     f"finite, got {v}")
            if self.mesh is not None:
                raise ValueError(
                    f"request {req.rid}: penalties under tensor "
                    "parallelism are not supported yet")
            if econf.spec_k >= 2:
                raise ValueError(
                    f"request {req.rid}: penalties under speculative "
                    "decoding are not supported (the penalized pick is "
                    "not the verified raw argmax)")
        if _has_overrides(req) and self.mesh is not None:
            raise ValueError(
                f"request {req.rid}: per-request sampling overrides "
                "under tensor parallelism are not supported yet")
        if (_has_overrides(req) and econf.spec_k >= 2
                and not _effective(self._default_sampler(), req)[0]):
            raise ValueError(
                f"request {req.rid}: spec_k requires greedy decoding; a "
                "non-greedy per-request override cannot be speculatively "
                "verified")
        if req.max_new_tokens <= 0:
            return
        # prompts longer than the window keep their trailing `window`
        # tokens, so capacity is window-relative
        need = min(len(req.prompt), window) + req.max_new_tokens
        if need > page.max_context:
            raise ValueError(f"request {req.rid} needs {need} cached tokens"
                             f" > max_context {page.max_context}")
        # slid-out pages are reclaimed, so a window-W sequence holds at
        # most ceil(W/ps)+1 live pages
        phys = min(need, window + page.page_size)
        if -(-phys // page.page_size) > page.num_pages:
            raise ValueError(
                f"request {req.rid} needs {-(-phys // page.page_size)}"
                f" pages > pool size {page.num_pages} — it can never"
                " be scheduled")
        # spec_k / prefix_cache require that the window never activates:
        # sliding would make page content position-dependent and change
        # what verify queries attend mid-stream
        if (econf.spec_k >= 2 or page.prefix_cache) and need > window:
            mode = "spec_k" if econf.spec_k >= 2 else "prefix_cache"
            raise ValueError(
                f"{mode} with sliding-window serving is not supported: "
                f"request {req.rid} outgrows the window ({window})")

    def _paged_state(self):
        page = self.econf.page
        max_seqs = max(page.max_seqs, self.econf.max_batch)
        if page.prefix_cache:
            # the prefix-caching manager PERSISTS across runs: cached pages
            # outlive their owners. Its metadata is only valid over the
            # same pool buffers, so a lost pool cache restarts it.
            mgr = self._prefix_mgr
            if mgr is None or self._pool_cache is None:
                mgr = native.make_block_manager(
                    page.num_pages, page.page_size, max_seqs,
                    native=self.native_manager, prefix=True)
                self._prefix_mgr = mgr
            else:
                # sequences a previous run left behind: their full hashed
                # pages demote to the cache (the across-run reuse)
                for pid in range(mgr.max_seqs):
                    mgr.free_prompt(pid)
        else:
            mgr = native.make_block_manager(page.num_pages, page.page_size,
                                            max_seqs,
                                            native=self.native_manager)
        pool = self._pool_cache
        self._pool_cache = None
        if pool is None:
            # graphs over a lost pool would hold it beside the new one
            self._decode_graphs.reset()
            pool = self._model.new_pool(self.cfg, page, page.kv_dtype,
                                        self.device, max_seqs)
        return mgr, pool

    def run(self, requests: List[Request], window: Optional[int] = None,
            sampler=None, feed=None, on_finish=None,
            on_tokens=None) -> List[Request]:
        """Continuous batching over the paged pool. Returns the finished
        requests (the same objects, with .generated/.ttft/.preemptions
        filled). ``sampler`` is the host sampler (default: the
        EngineConfig's).

        ``feed``: optional ``feed(block) -> (list[Request], still_open)``
        polled every scheduler iteration and between chain links:
        requests arriving while others run join the batch at the next
        admission wave (engine/server.ServingEngine is the threaded
        front). With ``block=True`` (engine idle) it may wait briefly for
        work. The loop exits when the feed reports closed and all work
        drained. With a feed, finished requests are not retained (the
        return value is empty); they are delivered through ``on_finish``,
        which is called with each request the moment it finishes.

        ``on_tokens``: optional ``on_tokens(req, new_tokens)`` called at
        every materialization with the tokens appended since its last
        call (streaming). While a request with ``req.stream`` runs,
        chains cap at EngineConfig.stream_links links a materialization.
        A request whose ``cancelled`` flag is set (from any thread) is
        retired at the next iteration top or chain materialization.

        The run's host time is recorded in spans (utils/spans.py), on a
        recorder of its own: ``stats["spans"]`` holds each span's count,
        seconds and self seconds, and the ``t_*_s`` buckets are read from
        them. While a profiler records, each span is also a
        ``record_function`` range of the trace."""
        with spans.recording() as rec:
            return _Run(self, rec, requests, window, sampler, feed,
                        on_finish, on_tokens).serve()

    def warmup(self, window: Optional[int] = None) -> Dict[str, float]:
        """Run the JAX package's throwaway requests through every path
        this engine's configuration can reach (the smallest prefill
        bucket and the decode chain or single-token step, then the
        logprobs and prompt-logprobs variants when serve_logprobs, but
        not under tensor parallelism, which refuses them), so
        that the first tenant of a server pays none of the first-use
        costs: on the card, the CUDA kernels build (all four serving
        sources at once, the long-prompt prefill's flash kernel
        included, "build"), the caching allocator warms and a greedy
        chain captures its CUDA graphs (models/decode_graphs.py).
        Returns {stage: seconds}."""
        if self.econf.cache_mode != "paged":
            return {}
        timings: Dict[str, float] = {}
        if self.device.type == "cuda" and self.use_kernel:
            from llmc_paged_tpu_torch.ops import _build
            t0 = time.monotonic()
            _build.build_all(("paged_attention", "paged_attention_mq",
                              "paged_attention_grid", "flash_attention"))
            timings["build"] = round(time.monotonic() - t0, 3)
        prompt = list(range(1, 9))      # bucket 16, any ids work
        new = max(2, min(self.econf.decode_chunk + 2,
                         self.econf.page.max_context - len(prompt)))
        stages = [("default", {})]      # prefill bucket + chunk/step path
        if self.econf.serve_logprobs and self.mesh is None:
            if self.econf.spec_k < 2:
                stages.append(("logprobs", {"logprobs": True}))
            if not self.econf.page.prefix_cache:
                stages.append(("prompt_logprobs", {"prompt_logprobs": True}))
        for tag, kw in stages:
            t0 = time.monotonic()
            # stop_tokens=[] overrides an engine default: a junk pick on a
            # stop id would finish the request at prefill and the decode
            # path would never run
            self.run([Request(rid=-1, prompt=list(prompt),
                              max_new_tokens=new, stop_tokens=[], **kw)],
                     window=window)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            timings[tag] = round(time.monotonic() - t0, 3)
        return timings


class _Run:
    """One ``InferenceEngine.run``: its scheduler, block manager, pool and
    counters, and its loop (``serve``). Device entries are looked up on
    the model object's ``entries`` module at every call, as ``_fetch`` is
    in this module, so a caller may wrap them after the engine is built."""

    def __init__(self, eng: InferenceEngine, rec, requests, window,
                 sampler, feed, on_finish, on_tokens):
        cfg, econf = eng.cfg, eng.econf
        eng._model.refuse(econf, eng.device, window)
        self.window = _check_window(window, cfg)
        self.sampler = sampler or eng._default_sampler()
        if econf.spec_k >= 2 and not self.sampler.greedy:
            raise ValueError(
                "spec_k requires greedy serving: speculative verification "
                "accepts argmax matches; rejection sampling for the "
                "stochastic samplers is not implemented")
        self.eng, self.rec, self.cfg, self.econf = eng, rec, cfg, econf
        self.page = page = econf.page
        self.feed, self.on_finish, self.on_tokens = feed, on_finish, on_tokens
        self.sched = Scheduler(econf.max_batch)
        # a long-lived serving loop must not grow with request count:
        # finished requests are dropped after delivery; batch runs keep
        # them (run() returns them)
        self.retain_finished = feed is None
        self.n_finished = 0
        self.ttfts: "collections.deque" = collections.deque(maxlen=1024)
        self.dev = eng.device
        for r in requests:
            self.submit(r)
        # the pool is taken only after every request validated: a
        # ValueError above keeps the pool cache
        self.mgr, self.pool = eng._paged_state()
        eng._model.start_run(self.pool)     # counters read at the run's end
        self.B, self.pps = econf.max_batch, page.pages_per_seq
        self.t_start = time.monotonic()
        self.graph_steps0 = eng._decode_graphs.steps
        self.decode_tokens = 0
        self.decode_steps = 0   # device decode steps (each = L kernel calls)
        self.verify_steps = 0   # of which speculative verify steps
        self.single_steps = 0   # of which single-token steps
        self.suffix_prefills = 0    # prefix-cache suffix prefill calls
        self.prefill_calls = 0  # prefill calls, all kinds (a wave makes 1+)
        self.peak_pages = 0
        self.iteration = 0
        # per-slot count of prompt tokens dropped at admission (prompt
        # longer than the window); cache positions are relative to it
        self.bases: Dict[int, int] = {}
        # per-slot count of prompt tokens served from ADOPTED cached pages:
        # the suffix prefill starts at this position (0 without caching)
        self.cached: Dict[int, int] = {}
        # prompt tokens served from adopted pages (their prefill was
        # skipped), those pages, and the pages the run registered
        self.prefix_stats = {"prefix_hit_tokens": 0, "prefix_hit_pages": 0,
                             "prefix_pages_registered": 0}
        self.spec_stats = {"steps": 0, "accepted": 0}
        # device sampling draws from one generator on the engine's device,
        # seeded per run; an all-greedy chain passes rng=None and keeps the
        # greedy stream
        self.sample_gen = (torch.Generator(device=self.dev)
                           .manual_seed(econf.seed)
                           if econf.device_sampling else None)
        self.feed_open = feed is not None
        # once admission has run, anything still waiting is blocked on
        # slots or pages: chains run anyway but stay short
        self.queue_blocked = False
        # a streaming consumer, or a stop (seen only at materialization),
        # caps chains at this many links (0: no cap)
        self.stream_cap = 0
        # (device picks, device logprobs|None, group): greedy first tokens
        # picked on the device, fetched after the first link
        self.deferred = None
        self.progressed = False

    # ---- the loop -----------------------------------------------------------

    def serve(self) -> List[Request]:
        sched, econf = self.sched, self.econf
        # one span a pass of the loop, closed at the next pass's top: a
        # range opens only if a profiler records when its pass starts
        pass_span = None
        while True:
            if pass_span is not None:
                pass_span.close()
            pass_span = span("engine.iteration").open()
            if self.feed_open:
                # requests that arrived join this iteration's admission
                # wave; an idle engine lets the feed block briefly
                self.poll_feed(block=not sched.has_work)
            self.sweep_cancelled()
            self.update_live_stats()
            if not sched.has_work:
                if self.feed_open:
                    continue
                break
            self.iteration += 1
            if econf.log_every and self.iteration % econf.log_every == 0:
                self.log()
            self.progressed = False
            self.deferred = None
            group = self.admit()
            if group:
                self.prefill_wave(group)
            self.reclaim()
            self.decode()
            if not self.progressed and not sched.running:
                raise RuntimeError(
                    "scheduler stalled: pool too small for any waiting "
                    "request (need a larger page pool or shorter prompts)")
        pass_span.close()
        return self.end()

    def log(self) -> None:
        dt = time.monotonic() - self.t_start
        print(f'{{"iter": {self.iteration}, '
              f'"running": {len(self.sched.running)}, '
              f'"waiting": {len(self.sched.waiting)}, '
              f'"finished": {self.n_finished}, '
              f'"pages_free": {self.mgr.num_free()}, '
              f'"decode_tokens": {self.decode_tokens}, '
              f'"tok_per_s": {self.decode_tokens / dt if dt else 0:.1f}}}',
              flush=True)

    def end(self) -> List[Request]:
        """Keep the pool for the next run and write the engine's stats."""
        eng, rec = self.eng, self.rec
        eng._pool_cache = self.pool
        self.update_live_stats()
        dt = time.monotonic() - self.t_start
        eng.stats = {
            "wall_s": dt,
            "decode_tokens": self.decode_tokens,
            "decode_steps": self.decode_steps,
            "decode_tok_per_s": self.decode_tokens / dt if dt > 0 else 0.0,
            "peak_pages_used": self.peak_pages,
            "preemptions": self.sched.preempt_count,
            # the last 1024 finishes: exact for batch runs, a recent
            # window for long-lived serving
            "p50_ttft_s": (float(np.median(self.ttfts)) if self.ttfts
                           else 0.0),
            # host buckets, each second counted once: the dispatch
            # buckets are the self times of their spans (a blocking fetch,
            # delivery, the caller's callbacks and the chained steps'
            # model.step spans are out of them), materialize the total of
            # every blocking device-to-host fetch
            "t_prefill_dispatch_s": round(rec.self_seconds("engine.prefill"),
                                          4),
            "t_chain_dispatch_s": round(rec.self_seconds("engine.link"), 4),
            "t_step_dispatch_s": round(rec.self_seconds("engine.step"), 4),
            "t_materialize_s": round(rec.seconds("engine.fetch"), 4),
            "spans": rec.as_dict(),
            "verify_steps": self.verify_steps,
            "single_steps": self.single_steps,
            # of the decode steps, the chained steps replayed as a graph
            "decode_graph_steps": eng._decode_graphs.steps - self.graph_steps0,
            "suffix_prefills": self.suffix_prefills,
            # against spans["engine.prefill"]["n"] (the waves): calls a wave
            "prefill_calls": self.prefill_calls,
        }
        eng.stats.update(eng._model.run_stats(self.pool, self.peak_pages))
        if self.econf.spec_k >= 2:
            # spec_steps counts S per row per link; spec_tok_per_step is
            # committed tokens per verify step (overshoot included): the
            # raw acceptance of the drafting, in [1, spec_k]
            steps = self.spec_stats["steps"]
            eng.stats["spec_steps"] = steps
            eng.stats["spec_tok_per_step"] = round(
                self.spec_stats["accepted"] / steps, 3) if steps else 0.0
        if self.page.prefix_cache:
            # and the cache's occupancy after the run
            eng.stats.update(self.prefix_stats,
                             prefix_cached_pages=self.mgr.num_cached())
        return self.sched.finished

    # ---- requests in and out ------------------------------------------------

    def submit(self, r: Request) -> None:
        if not r.cancelled:     # else cancelled before it ever reached us
            self.eng.validate_request(r, self.window)
        if r.cancelled or r.max_new_tokens <= 0:
            self.retire_unscheduled(r)
        else:
            self.sched.submit(r)

    def poll_feed(self, block: bool = False) -> None:
        """Serving: arrivals join the waiting queue (between chain links a
        host queue check; nothing touches the device)."""
        with spans.caller("engine.callback"):
            new_reqs, self.feed_open = self.feed(block)
        for r in new_reqs:
            self.submit(r)
        self.queue_blocked = self.queue_blocked or bool(self.sched.waiting)

    def record_finished(self, r: Request) -> None:
        """Bookkeeping of every finish path; drops the request from
        sched.finished under serving (it was appended just before)."""
        self.n_finished += 1
        if r.t_done is None:
            r.t_done = time.monotonic()
        if r.ttft is not None:
            self.ttfts.append(r.ttft)
        if not self.retain_finished:
            self.sched.finished.pop()

    def retire_unscheduled(self, r: Request) -> None:
        r.state = State.DONE
        self.sched.finished.append(r)
        self.record_finished(r)
        if self.on_finish is not None:
            with span("engine.callback"):
                self.on_finish(r)

    def finish_slot(self, slot: int) -> None:
        """Retire a running row: its pages free, its request finishes."""
        self.mgr.free_prompt(slot)
        req = self.sched.finish(slot)
        self.record_finished(req)
        # the live snapshot counts this finish before the callbacks
        # resolve the request's future
        self.update_live_stats()
        self.notify_tokens(req)
        if self.on_finish is not None:
            with span("engine.callback"):
                self.on_finish(req)

    def sweep_cancelled(self) -> None:
        """Retire requests cancelled since the last iteration. No
        chain is in flight at the iteration top, so a running row's
        pages free wholesale here as a finished row's do (the device
        runs in order). A cancel landing mid-chain is seen at that
        chain's materialization."""
        sched = self.sched
        for req in [r for r in sched.waiting if r.cancelled]:
            sched.waiting.remove(req)
            self.retire_unscheduled(req)
        for slot, req in list(sched.running.items()):
            if req.cancelled:
                self.finish_slot(slot)

    def update_live_stats(self) -> None:
        """Whole-dict swap, so readers on other threads (ServingEngine
        .stats(), HTTP GET /stats) never see a partial update.
        Counters only: a serving loop runs this every iteration."""
        dt = time.monotonic() - self.t_start
        self.eng.live_stats = {
            "running": len(self.sched.running),
            "waiting": len(self.sched.waiting),
            "finished_total": self.n_finished,
            "decode_tokens": self.decode_tokens,
            "decode_tok_per_s": self.decode_tokens / dt if dt > 0 else 0.0,
            "pages_free": self.mgr.num_free(),
            "peak_pages_used": self.peak_pages,
            "preemptions": self.sched.preempt_count,
            "uptime_s": dt,
        }

    def apply_stop(self, req: Request) -> int:
        """Scan newly materialized tokens for a stop id; on a hit keep
        the stop token, discard the overshoot past it (and its
        logprobs) and mark the request stopped. Returns the discarded
        count. Runs before notify_tokens, so streams never see
        post-stop tokens."""
        stops = (req.stop_tokens if req.stop_tokens is not None
                 else self.econf.stop_tokens)
        if not stops or req.stopped:
            return 0
        gen = req.generated
        for k in range(getattr(req, "_stop_scanned", 0), len(gen)):
            if gen[k] in stops:
                discarded = len(gen) - (k + 1)
                del gen[k + 1:]
                del req.logprob_values[k + 1:]
                req.stopped = True
                return discarded
        req._stop_scanned = len(gen)
        return 0

    def notify_tokens(self, req: Request) -> None:
        """Flush the tokens appended since the last flush (a watermark
        on the request, so it survives preemption)."""
        if self.on_tokens is None or req.cancelled:
            return
        n = len(req.generated)
        sent = getattr(req, "_stream_sent", 0)
        if n > sent:
            with span("engine.callback"):
                self.on_tokens(req, req.generated[sent:n])
            req._stream_sent = n

    def deliver(self, rows, first: bool = False) -> None:
        """Hand each row of ``rows`` (slot, request, tokens, logprobs |
        None) its tokens and, where it asks, their logprobs, apply its
        stop, stream what it keeps, then retire each row that is done.
        ``first``: the prefill's first tokens, marked as such; others
        count as decode tokens, those a stop keeps."""
        done = []
        for slot, req, toks, lps in rows:
            n = len(req.generated)
            req.generated.extend(toks)
            if req.logprobs and lps is not None:
                req.logprob_values.extend(lps)
            if first:
                req.mark_first_token()
            self.apply_stop(req)
            if not first:
                self.decode_tokens += len(req.generated) - n
            self.notify_tokens(req)
            if req.done:
                done.append(slot)
        for slot in done:
            self.finish_slot(slot)

    def host_pick(self, logits, reqs: List[Request]):
        """A token for each row of (N, V) device logits, drawn on the host
        from the shared stream in row order (per-request transforms where
        a row overrides the sampler or is penalized), and each row's
        [logprob] where its request asks (None elsewhere)."""
        if any(_has_overrides(r) or _has_penalties(r) for r in reqs):
            toks = _sample_rows_per_request(self.sampler, logits, reqs)
        else:
            toks = _sample_rows(self.sampler, logits, len(reqs))
        rows = _host(logits) if any(r.logprobs for r in reqs) else None
        return toks, [[_row_logprob(rows[i], t)] if r.logprobs else None
                      for i, (r, t) in enumerate(zip(reqs, toks))]

    # ---- admission and the prefill wave -------------------------------------

    def requeue_evicted(self, evicted: List[int],
                        skip_slot: int = -1) -> List[int]:
        preempted = []
        for victim in set(evicted):
            if victim != skip_slot and victim in self.sched.running:
                self.mgr.free_prompt(victim)
                self.sched.preempt(victim)
                preempted.append(victim)
        return preempted

    def admit(self) -> List[Tuple[int, Request]]:
        """Waiting requests into free slots while the pool has pages (a
        request first adopts its longest cached prefix). Returns the
        wave's (slot, request) rows in admission order."""
        sched, mgr, ps = self.sched, self.mgr, self.page.page_size
        admitted: List[Tuple[int, Request]] = []
        with span("engine.admit"):
            for slot in sched.free_slots():
                req = sched.pop_next_waiting()
                if req is None:
                    break
                base = max(0, len(req.tokens) - self.window)
                self.bases[slot] = base
                csl = 0
                if self.page.prefix_cache:
                    # adopt the longest cached page chain matching the
                    # known tokens (prompt + any generated before a
                    # preemption), capped so at least one token is prefilled
                    hit = mgr.match_prefix(req.tokens)
                    hit = hit[: (len(req.tokens) - 1) // ps]
                    if hit:
                        mgr.adopt(slot, hit)
                        csl = len(hit) * ps
                        self.prefix_stats["prefix_hit_pages"] += len(hit)
                        self.prefix_stats["prefix_hit_tokens"] += csl
                self.cached[slot] = csl
                segs, evicted = mgr.append_tokens(
                    slot, len(req.tokens) - base - csl)
                # a victim may be an earlier admission of this same wave:
                # drop it from the wave or its prefill would write K/V
                # through a cleared block table
                for victim in self.requeue_evicted(evicted, skip_slot=slot):
                    admitted = [(s, r) for s, r in admitted if s != victim]
                if not segs:
                    mgr.free_prompt(slot)
                    sched.waiting.insert(0, req)  # retry once pool drains
                    break
                self.progressed = True
                sched.admit(req, slot)
                admitted.append((slot, req))
        return admitted

    def call_inputs(self, group, rows, lens):
        """One prefill call's host inputs (rows, xs, valid, tables, last,
        offs, page ids, slots): the wave rows ``rows`` (of lengths
        ``lens``) right-padded to their longest's bucket Tb, counted as
        Tb padded slots a row."""
        page = self.page
        Tb = _bucket(max(lens[i] for i in rows))
        b = len(rows)
        xs = np.zeros((b, Tb), np.int32)
        valid = np.zeros((b, Tb), bool)
        tables_g = np.zeros((b, self.pps), np.int32)
        last = np.zeros(b, np.int64)
        offs = np.zeros(b, np.int32)
        for k, i in enumerate(rows):
            slot, req = group[i]
            n = lens[i]
            xs[k, :n] = req.tokens[self.bases[slot] + self.cached[slot]:]
            valid[k, :n] = True
            tables_g[k] = self.mgr.block_table_array(slot, self.pps)
            last[k] = n - 1
            offs[k] = self.cached[slot]          # page-aligned by adopt
            req.prefill_slots += Tb
        pos = offs[:, None] + np.arange(Tb, dtype=np.int32)[None, :]
        pg, sl = token_coords(torch.from_numpy(tables_g),
                              torch.from_numpy(pos), page.page_size,
                              torch.from_numpy(valid), page.num_pages)
        return rows, xs, valid, tables_g, last, offs, pg, sl

    def prefill_wave(self, group) -> None:
        """Every call's host inputs, then every call queued, then the
        outputs in admission order, prompt logprobs fetched once, and the
        wave's first tokens."""
        with span("engine.prefill"):
            t_wave = time.monotonic()
            lens = [len(req.tokens) - self.bases[slot] - self.cached[slot]
                    for slot, req in group]
            for (slot, req), n in zip(group, lens):
                if req.t_admit is None:
                    req.t_admit = t_wave
                req.prefill_tokens += n
            plp_rows = [(i, req) for i, (slot, req) in enumerate(group)
                        if req.prompt_logprobs
                        and not req.prompt_logprob_values
                        and not req.generated]
            plp_idx = {i for i, _ in plp_rows}
            calls = [self.call_inputs(group, rows, lens)
                     for rows in _subwaves(lens)]
            lg, plp_d = _in_admission_order(
                [self.prefill_call(group, call, plp_idx) for call in calls])
            if plp_d is not None:
                with span("engine.fetch"):
                    plp = plp_d.cpu().numpy()
                for i, req in plp_rows:
                    req.prompt_logprob_values = [
                        float(v) for v in plp[i, : len(req.prompt) - 1]]
            if self.page.prefix_cache:
                # publish this wave's full prompt pages only now, after
                # the call that writes their K/V is queued (a same-wave
                # evictee never prefills); the device runs in order,
                # so a later adopter's reads see these writes
                for slot, req in group:
                    self.prefix_stats["prefix_pages_registered"] += \
                        self.mgr.register_prompt(slot, req.tokens)
            self.first_tokens(lg, group)

    def prefill_call(self, group, call, plp_idx):
        """Queue one prefill call of the wave. Returns (rows, (b, V)
        logits, (b, Tb-1) prompt logprobs | None)."""
        eng = self.eng
        rows, xs, valid, tables_g, last, offs, pg, sl = call
        self.prefill_calls += 1
        if offs.any():
            # a row rides adopted pages: the suffix prefill attends the
            # cached prefix through the block table (rows with offs 0
            # degenerate to plain prefill)
            logits, self.pool = eng._model.entries.prefill_suffix_paged(
                eng._prompt_params, torch.from_numpy(xs), pg, sl, self.pool,
                torch.from_numpy(tables_g), torch.from_numpy(offs), self.cfg,
                last_pos=torch.from_numpy(last), use_kernel=eng.use_kernel,
                model=eng._model)                           # (b, V)
            self.suffix_prefills += 1
            return rows, logits, None
        # scoring rows take the full (b, T, V) logits, the next-token
        # logprobs are taken on the device and fetched once for the wave;
        # a family with window rings finds each row's by its slot
        full = bool(plp_idx.intersection(rows))
        logits, self.pool = eng._model.entries.prefill_paged(
            eng._prompt_params, torch.from_numpy(xs), pg, sl, self.pool,
            self.cfg, last_pos=None if full else torch.from_numpy(last),
            use_kernel=eng.use_kernel, model=eng._model,
            rows=torch.tensor([group[i][0] for i in rows]))
        if not full:
            return rows, logits, None                      # (b, V)
        return (rows, *_prefill_plp_extract(logits, xs, valid, last))

    def first_tokens(self, lg, group) -> None:
        """The wave's first tokens: a greedy wave picks on the device and
        fetches after the first link is queued, overlapping decode; a
        sampled or penalized row draws now from the host stream."""
        reqs = [r for _, r in group]
        if all(_effective(self.sampler, r)[0] for r in reqs) \
                and not any(_has_penalties(r) for r in reqs):
            picks_d = torch.argmax(lg, dim=-1).int()
            lps_d = None
            if any(r.logprobs for r in reqs):
                lgf = lg.float()
                lps_d = (torch.gather(lgf, 1, picks_d.long()[:, None])[:, 0]
                         - torch.logsumexp(lgf, dim=-1))
            self.deferred = (picks_d, lps_d, list(group))
            return
        with span("engine.fetch"):
            toks, lps = self.host_pick(lg, reqs)
        with span("engine.deliver"):
            self.deliver(((slot, req, [t], lp) for (slot, req), t, lp
                          in zip(group, toks, lps)), first=True)

    def flush_deferred(self) -> None:
        """Materialize the deferred prefill picks (and logprobs, in the
        same copy), before any path reads req.tokens[-1] on the host."""
        if self.deferred is None:
            return
        picks_d, lps_d, group = self.deferred
        with span("engine.fetch"):
            picks, lps = _fetch(picks_d, lps_d)
        with span("engine.deliver"):
            self.deliver(((slot, req, picks[i:i + 1].tolist(),
                           None if lps is None else lps[i:i + 1].tolist())
                          for i, (slot, req) in enumerate(group)), first=True)
        self.progressed = True
        self.deferred = None

    def defer_counts(self) -> Dict[int, int]:
        """One not-yet-appended token a slot with a deferred pick."""
        return {s: 1 for s, _ in self.deferred[2]} if self.deferred else {}

    def reclaim(self) -> None:
        """Sliding-window page reclamation, and the pool's peak."""
        page = self.page
        if self.window < page.max_context:
            for slot, req in self.sched.running.items():
                start = len(req.tokens) - self.bases.get(slot, 0) - self.window
                if start >= page.page_size:
                    self.mgr.release_below(slot, start)
        self.peak_pages = max(self.peak_pages,
                              page.num_pages - self.mgr.num_free())

    # ---- decode -------------------------------------------------------------

    def decode(self) -> None:
        """A speculative chain where it runs; else a plain chain where
        every row is greedy or sampling is on the device (the host stream
        cannot feed back on the device); else a single-token step."""
        sched, econf, page = self.sched, self.econf, self.page
        running = sched.running
        all_greedy = all(_effective(self.sampler, r)[0]
                         for r in running.values())
        row_overrides = any(_has_overrides(r) for r in running.values())
        self.queue_blocked = bool(sched.waiting)
        self.stream_cap = econf.stream_links if any(
            (r.stream and self.on_tokens is not None)
            or (r.stop_tokens if r.stop_tokens is not None
                else econf.stop_tokens) for r in running.values()) else 0
        if econf.spec_k >= 2 and running and self.spec_chain():
            return
        if (all_greedy or econf.device_sampling) and running:
            # capacity-bound only: rows that reach max_new mid-chunk are
            # truncated on the host
            dct = self.defer_counts()
            cap = min(page.max_context
                      - (len(r.tokens) - self.bases.get(s, 0)
                         + dct.get(s, 0))
                      for s, r in running.items())
            chunk = _chain_length(econf.decode_chunk, cap,
                                  self.queue_blocked
                                  and bool(sched.free_slots()))
            if chunk > 1 and self.plain_chain(chunk, all_greedy,
                                              row_overrides):
                return
        # no chain could run: a single-token step
        self.flush_deferred()
        if running:
            self.single_step()

    def link_plan(self, rows: List[int], length: int) -> List[int]:
        """Of ``rows`` (slots with budget left), those with headroom for a
        link of ``length`` tokens a row; none where the free pages cannot
        take the link (the free-page guard: no eviction mid-chain)."""
        ps, max_context = self.page.page_size, self.page.max_context
        need_pages, plan = 0, []
        for slot in rows:
            ln = self.mgr.seq_len(slot)
            if ln + length > max_context:
                continue
            tail = (ps - ln % ps) % ps
            need_pages += max(0, -(-(length - tail) // ps))
            plan.append(slot)
        return plan if plan and need_pages <= self.mgr.num_free() else []

    def link_queued(self, link_span, links: int) -> bool:
        """After a link is queued: the pool's peak, the feed polled, the
        live snapshot, the span closed. Whether the chain breaks here: at
        the stream cap, or for a row cancelled from another thread (the
        materialization retires it now, not at the chain's end)."""
        self.peak_pages = max(self.peak_pages,
                              self.page.num_pages - self.mgr.num_free())
        if self.feed_open:
            self.poll_feed()
        self.update_live_stats()
        link_span.close()
        return (bool(self.stream_cap) and links >= self.stream_cap
                or any(r.cancelled for r in self.sched.running.values()))

    def spec_chain(self) -> bool:
        """A chain of speculative links: each device step VERIFIES spec_k
        tokens (carried token + device n-gram drafts) and yields 1..spec_k
        of them, so the host reserves S*spec_k tokens a row a link and
        rolls back with truncate_to once the chain materializes. Whether
        the pass is done: not when no link could run (pool pressure, no
        headroom) or a row without headroom still needs tokens, which the
        plain chain (fewer pages a link) or a single step then serve."""
        econf, page, sched, mgr = self.econf, self.page, self.sched, self.mgr
        eng, B, pps, dev = self.eng, self.B, self.pps, self.dev
        self.flush_deferred()   # the spec chain reads req.tokens
        S = max(1, econf.decode_chunk)
        TK = S * econf.spec_k
        pending: List = []      # (out dev, counts dev, plan)
        hist_d = first_d = pos0_d = None
        pre_len: Dict[int, int] = {}
        gen_before = {s: len(r.generated) for s, r in sched.running.items()}
        while True:
            link_span = span("engine.link").open()
            # >= 1 token is accepted a step: a row whose budget the links
            # so far cover has finished in them
            plan = self.link_plan(
                [s for s, r in sched.running.items()
                 if r.max_new_tokens - gen_before[s] > len(pending) * S], TK)
            if not plan:
                link_span.close()
                break
            tables = np.zeros((B, pps), np.int32)
            for slot in plan:
                pre_len.setdefault(slot, mgr.seq_len(slot))
                segs, evicted = mgr.append_tokens(slot, TK)
                if evicted:
                    raise RuntimeError(
                        "free-page guard failed: eviction inside a "
                        f"speculative chain (victims {evicted})")
                tables[slot] = mgr.block_table_array(slot, pps)
            if econf.debug_checks:
                _validate_indices(page, tables)
            keep = np.zeros(B, bool)
            keep[plan] = True
            if hist_d is None:
                hist = np.zeros((B, page.max_context + 1), np.int32)
                first = np.zeros(B, np.int32)
                pos0 = np.full(B, -1, np.int32)
                for slot in plan:
                    req = sched.running[slot]
                    hist[slot, : len(req.tokens)] = req.tokens
                    first[slot] = req.tokens[-1]
                    pos0[slot] = len(req.tokens) - 1
                hist_d, first_d, pos0_d = (
                    to_device(torch.from_numpy(a), dev)
                    for a in (hist, first, pos0))
            else:
                # deactivate rows that left the plan; a row never
                # re-enters mid-chain
                pos0_d = torch.where(
                    to_device(torch.from_numpy(keep), dev), pos0_d, -1)
            out_d, counts_d, hist_d, first_d, pos0_d, self.pool = \
                eng._model.entries.decode_chunk_spec(
                    eng._decode_params, first_d, pos0_d, hist_d, self.pool,
                    torch.from_numpy(tables), self.cfg, num_steps=S,
                    spec_k=econf.spec_k, ngram=econf.spec_ngram,
                    use_kernel=eng.use_kernel, active=keep, model=eng._model)
            self.decode_steps += S
            self.verify_steps += S
            pending.append((out_d, counts_d, list(plan)))
            if self.link_queued(link_span, len(pending)):
                break
            # acceptance is data-dependent: a row MAY have finished once
            # links*S*spec_k covers its remaining budget
            may_free = any(sched.running[s].max_new_tokens - gen_before[s]
                           <= len(pending) * TK for s in plan)
            if self.queue_blocked or (
                    (self.feed_open or self.on_finish is not None)
                    and may_free):
                # under queue pressure a row may finish at ANY link:
                # materialize so its slot and pages free; when serving,
                # deliver a finished row now
                break
        if not pending:
            return False
        self.progressed = True
        self.spec_deliver(pending, pre_len, S)
        # a row still needing tokens but WITHOUT headroom for a full
        # reservation can never join a spec plan: it would starve
        return not any(r.max_new_tokens > len(r.generated)
                       and mgr.seq_len(s) + TK > page.max_context
                       for s, r in sched.running.items())

    def spec_deliver(self, pending, pre_len, S: int) -> None:
        """One device→host copy of every link's tokens and acceptance
        counts; each row's reservation rolled back to its accepted tokens,
        which are cut to its budget and delivered."""
        B, Ksp = self.B, self.econf.spec_k
        n_out = S * Ksp * B
        with span("engine.fetch"):
            flat = torch.stack([
                torch.cat([o.reshape(-1), c.reshape(-1)])
                for o, c, _ in pending]).cpu().numpy()
        all_out = flat[:, :n_out].reshape(-1, S, Ksp, B)
        all_cnt = flat[:, n_out:].reshape(-1, S, B)
        rows = []
        with span("engine.deliver"):
            for slot, pre in pre_len.items():
                req = self.sched.running[slot]
                links = [li for li, (*_, plan) in enumerate(pending)
                         if slot in plan]
                toks = [int(t) for li in links for s_i in range(S)
                        for t in all_out[li, s_i, :all_cnt[li, s_i, slot],
                                         slot]]
                self.spec_stats["steps"] += S * len(links)
                self.spec_stats["accepted"] += len(toks)
                self.mgr.truncate_to(slot, pre + len(toks))
                rows.append((slot, req,
                             toks[: req.max_new_tokens - len(req.generated)],
                             None))
            self.deliver(rows)

    def chain_sampling(self, all_greedy: bool, row_overrides: bool) -> dict:
        """The chain's sampling: all-greedy keeps the argmax (no rng); a
        uniform sampled batch passes the sampler's scalars; only
        per-request overrides build (B,) arrays, uploaded once a chain."""
        if self.sample_gen is None or all_greedy:
            return {}
        if not row_overrides:
            return dict(rng=self.sample_gen, top_k=self.sampler.top_k,
                        temperature=self.sampler.temperature)
        B, V, dev = self.B, self.cfg.vocab_size, self.dev
        tarr = np.ones(B, np.float32)
        karr = np.zeros(B, np.int32)
        garr = np.zeros(B, bool)
        kmax = 0
        for slot, r in self.sched.running.items():
            g, tk, tmp = _effective(self.sampler, r)
            garr[slot] = g
            tarr[slot] = tmp if not g else 1.0
            if not g and tk and tk < V:
                # tk >= V means no filter (the host topk_probs bound),
                # not a clamp to V-1
                karr[slot] = tk
                kmax = max(kmax, tk)
        # a power-of-two cap, below V so the filter stays on
        kcap = min(1 << (kmax - 1).bit_length(), V - 1) if kmax else None
        karr = np.minimum(karr, kcap or 0)
        return dict(
            rng=self.sample_gen, top_k=kcap,
            temperature=to_device(torch.from_numpy(tarr), dev),
            k_arr=(to_device(torch.from_numpy(karr), dev) if kcap else None),
            greedy_rows=to_device(torch.from_numpy(garr), dev))

    def chain_penalties(self) -> dict:
        """Penalties thread a (B, V) count plane through the chain: built
        on the host from each row's full context at chain start,
        uploaded once, updated on the device with each pick."""
        running = self.sched.running
        if not any(_has_penalties(r) for r in running.values()):
            return {}
        B, V, dev = self.B, self.cfg.vocab_size, self.dev
        fparr = np.zeros(B, np.float32)
        pparr = np.zeros(B, np.float32)
        cnt0 = np.zeros((B, V), np.int32)
        for slot, r in running.items():
            fparr[slot] = r.frequency_penalty
            pparr[slot] = r.presence_penalty
            np.add.at(cnt0[slot], np.clip(np.asarray(r.tokens), 0, V - 1), 1)
        return dict(pen_counts=to_device(torch.from_numpy(cnt0), dev),
                    freq_pen=to_device(torch.from_numpy(fparr), dev),
                    pres_pen=to_device(torch.from_numpy(pparr), dev))

    def plain_chain(self, chunk: int, all_greedy: bool,
                    row_overrides: bool) -> bool:
        """A chain of ``chunk``-step links, tokens fed back on the device,
        pages reserved ahead under the free-page guard, token values
        fetched ONCE after the chain. Returns whether a link ran."""
        sched, page, mgr = self.sched, self.page, self.mgr
        samp_kw = self.chain_sampling(all_greedy, row_overrides)
        pen_kw = self.chain_penalties()
        want_lp = any(r.logprobs for r in sched.running.values())
        pending: List = []      # (toks (chunk, B), logps | None, stepped)
        pend_counts: Dict[int, int] = {}
        first_dev = None
        while True:
            link_span = span("engine.link").open()
            dct = self.defer_counts()
            rows = [s for s, r in sched.running.items()
                    if r.max_new_tokens - len(r.generated) - dct.get(s, 0)
                    - pend_counts.get(s, 0) > 0]
            if self.window < page.max_context:
                # mid-chain reclamation: safe to reallocate at once, the
                # device stream is in order
                for slot in rows:
                    start = mgr.seq_len(slot) - self.window
                    if start >= page.page_size:
                        mgr.release_below(slot, start)
            plan = self.link_plan(rows, chunk)
            if not plan:
                link_span.close()
                break
            toks_out, lp_out, stepped, will_free = self.plain_link(
                plan, chunk, dct, pend_counts, first_dev, want_lp, samp_kw,
                pen_kw)
            first_dev = toks_out[-1]
            pending.append((toks_out, lp_out, stepped))
            # the first link is queued: fetch the deferred picks
            self.flush_deferred()
            if self.link_queued(link_span, len(pending)):
                break
            if (self.feed_open or self.on_finish is not None) and will_free:
                break   # deliver the finishing row now
            if self.queue_blocked and \
                    (will_free or self.window < page.max_context
                     or sched.free_slots()):
                # under queue pressure, materialize as soon as a row can
                # finish (or pages/slots may free) so the waiting queue
                # gets its admission retry
                break
        if not pending:
            return False
        self.progressed = True
        self.chain_deliver(pending, want_lp)
        return True

    def plain_link(self, plan, chunk, dct, pend_counts, first_dev, want_lp,
                   samp_kw, pen_kw):
        """Reserve ``chunk`` tokens a row of ``plan`` and queue the link:
        (tokens (chunk, B), logprobs | None, [(slot, tokens kept)],
        whether a row can finish in it)."""
        eng, page, sched, mgr = self.eng, self.page, self.sched, self.mgr
        B, pps = self.B, self.pps
        first = np.zeros(B, np.int32)
        pos0 = np.full(B, -1, np.int32)   # -1 → inactive row
        pgs = np.full((chunk, B), page.num_pages, np.int32)
        sls = np.zeros((chunk, B), np.int32)
        tables = np.zeros((B, pps), np.int32)
        stepped: List[Tuple[int, int]] = []
        will_free = False
        for slot in plan:
            req = sched.running[slot]
            pend_ct = pend_counts.get(slot, 0)
            segs, evicted = mgr.append_tokens(slot, chunk)
            if evicted:
                # an eviction here would write K/V through a cleared block
                # table into another sequence
                raise RuntimeError(
                    "free-page guard failed: eviction inside a "
                    f"chunk chain (victims {evicted})")
            coords = [(s.page, s.offset + i) for s in segs
                      for i in range(s.count)]
            if len(coords) != chunk:
                raise RuntimeError("chunk reservation short")
            first[slot] = req.tokens[-1]  # used by link 0 only
            pos0[slot] = (len(req.tokens) - 1 + pend_ct + dct.get(slot, 0)
                          - self.bases.get(slot, 0))
            for j, (pj, sj) in enumerate(coords):
                pgs[j, slot], sls[j, slot] = pj, sj
            tables[slot] = mgr.block_table_array(slot, pps)
            remaining = (req.max_new_tokens - len(req.generated)
                         - pend_ct - dct.get(slot, 0))
            keep = min(chunk, remaining)
            stepped.append((slot, keep))
            pend_counts[slot] = pend_ct + keep
            if remaining <= chunk:
                will_free = True
        if self.econf.debug_checks:
            _validate_indices(page, tables, pgs, sls)
        if first_dev is None:
            first_dev = to_device(torch.from_numpy(first), self.dev)
            if self.deferred is not None:
                dslots = to_device(torch.tensor(
                    [s for s, _ in self.deferred[2]]), self.dev)
                first_dev[dslots] = self.deferred[0]
        res = eng._model.entries.decode_chunk_paged(
            eng._decode_params, first_dev, torch.from_numpy(pos0),
            torch.from_numpy(pgs), torch.from_numpy(sls),
            torch.from_numpy(tables), self.pool, self.cfg,
            num_steps=chunk, window=self.window, use_kernel=eng.use_kernel,
            want_logprobs=want_lp, model=eng._model,
            graphs=eng._decode_graphs, **samp_kw, **pen_kw)
        # (out[, counts][, logps], pool): the penalty plane carries on
        self.pool = res[-1]
        if pen_kw:
            pen_kw["pen_counts"] = res[1]
        self.decode_steps += chunk
        return res[0], res[-2] if want_lp else None, stepped, will_free

    def chain_deliver(self, pending, want_lp: bool) -> None:
        """One device→host copy of the chain's tokens and logprobs, then
        each stepped row's kept tokens delivered."""
        self.flush_deferred()
        with span("engine.fetch"):
            all_picks, all_lps = _fetch(
                torch.stack([t for t, _, _ in pending]),
                torch.stack([p for _, p, _ in pending]) if want_lp else None)
        with span("engine.deliver"):
            # the steps each link kept of each row (row, link, step); the
            # kept tokens (and logprobs) in one list, a row's at [lo, hi)
            keep = np.zeros((self.B, len(pending), 1), np.int64)
            for li, (_, _, stepped) in enumerate(pending):
                for slot, k in stepped:
                    keep[slot, li, 0] = k
            kept = np.arange(all_picks.shape[1]) < keep
            n = kept.sum(axis=(1, 2))
            lo, hi = (np.cumsum(n) - n).tolist(), np.cumsum(n).tolist()
            toks = all_picks.transpose(2, 0, 1)[kept].tolist()
            lps = (all_lps.transpose(2, 0, 1)[kept].tolist() if want_lp
                   else None)
            # in running order; none for a row stopped at its first token
            self.deliver(
                (slot, req, [] if req.stopped else toks[lo[slot]:hi[slot]],
                 None if lps is None else lps[lo[slot]:hi[slot]])
                for slot, req in self.sched.running.items()
                if hi[slot] > lo[slot])

    def single_step(self) -> None:
        """One token for every running row, drawn on the host, its page
        appended with LRU preemption and requeue of the victims."""
        eng, page, sched, mgr = self.eng, self.page, self.sched, self.mgr
        B, pps, window = self.B, self.pps, self.window
        toks = np.zeros(B, np.int32)
        pg = np.full(B, page.num_pages, np.int32)
        sl = np.zeros(B, np.int32)
        lengths = np.zeros(B, np.int32)     # a stepped row's position + 1
        tables = np.zeros((B, pps), np.int32)
        stepped: List[int] = []
        for slot, req in list(sched.running.items()):
            if slot not in sched.running:
                continue   # preempted by an earlier slot's eviction
            segs, evicted = mgr.append_tokens(slot, 1)
            # a victim already staged in this batch is neutralized
            # so its K/V write cannot hit the page's new owner
            for victim in self.requeue_evicted(evicted, skip_slot=slot):
                if victim in stepped:
                    stepped.remove(victim)
                    pg[victim] = page.num_pages
                    lengths[victim] = 0
            if not segs:
                mgr.free_prompt(slot)
                sched.preempt(slot)
                continue
            toks[slot] = req.tokens[-1]
            pg[slot], sl[slot] = segs[0].page, segs[0].offset
            lengths[slot] = len(req.tokens) - self.bases.get(slot, 0)
            tables[slot] = mgr.block_table_array(slot, pps)
            stepped.append(slot)
        if not stepped:
            return
        self.progressed = True
        if self.econf.debug_checks:
            _validate_indices(page, tables, pg[None], sl[None], lengths)
        wpe_pos = np.clip(lengths - 1, 0, window - 1)
        starts = np.maximum(lengths - window, 0)
        with span("engine.step"):
            logits, self.pool = eng._model.entries.decode_step_paged(
                eng._decode_params, torch.from_numpy(toks),
                torch.from_numpy(wpe_pos), torch.from_numpy(pg),
                torch.from_numpy(sl), torch.from_numpy(tables),
                torch.from_numpy(lengths), self.pool, self.cfg,
                use_kernel=eng.use_kernel, starts=torch.from_numpy(starts),
                model=eng._model)
        self.decode_steps += 1
        self.single_steps += 1
        # rows gathered in `stepped` order so the parity RNG stream is
        # consumed per stepped row, in order
        reqs = [sched.running[s] for s in stepped]
        with span("engine.fetch"):
            picks, lps = self.host_pick(
                logits[to_device(torch.tensor(stepped), self.dev)], reqs)
        with span("engine.deliver"):
            self.deliver((s, r, [t], lp) for s, r, t, lp
                         in zip(stepped, reqs, picks, lps))
