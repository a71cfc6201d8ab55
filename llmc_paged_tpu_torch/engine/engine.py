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
  * admission waves, each with ONE padded prefill (rows padded to the
    wave's longest 16-token bucket, a power-of-two batch, logits only at
    each row's last prompt position); greedy first tokens are picked on
    the device and fetched after the first decode link is queued,
    sampled ones are drawn at admission;
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

Serving: ``run(feed=..., on_tokens=...)`` is the long-lived loop of
engine/server.ServingEngine (arrivals join at the next admission wave,
streaming flushes, cancellation, a live stats snapshot).

Host↔device traffic per link: a few int32 metadata arrays go up through
pinned memory without blocking (first tokens, positions, page/slot
coordinates, block tables; a speculative link uploads only its block
tables and its active-row mask); tokens (and logprobs, or a speculative
chain's acceptance counts) come down once per chain. Tensor parallelism
raises NotImplementedError and names its ROADMAP item.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from llmc_paged_tpu_torch import resolve_device
from llmc_paged_tpu_torch.config import EngineConfig, GPT2Config, PageConfig
from llmc_paged_tpu_torch.engine.scheduler import Request, Scheduler, State
from llmc_paged_tpu_torch.kv.layouts import init_pool, to_device, token_coords
from llmc_paged_tpu_torch.kv.manager import (
    BlockManager,
    PrefixCachingBlockManager,
)
from llmc_paged_tpu_torch.models import gpt2, gpt2_paged
from llmc_paged_tpu_torch.ops.int8 import quantize_params
from llmc_paged_tpu_torch.sampler import (
    Sampler,
    reconstruct_topk_row,
    sample_mult,
    topk_probs,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _later(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not in the torch port yet (ROADMAP.md, 'Left to port': "
        f"{item})")


def _bucket(n: int, step: int = 16) -> int:
    """Pad prefill lengths to buckets (bounded shape variety)."""
    return max(step, ((n + step - 1) // step) * step)


def _host(t: torch.Tensor) -> np.ndarray:
    """Device logits or probabilities → f32 numpy on the host."""
    return t.float().cpu().numpy()


def _sample_rows(sampler: Sampler, logits, n: int) -> List[int]:
    """Sample the first n rows of (N, V) device logits with one batched
    device reduction and transfer; the greedy/top-k/parity dispatch lives
    here (and in _pick_token for single rows) only."""
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


def _unpack_chunk(res, pen: bool, want_lp: bool):
    """decode_chunk_paged returns (out[, counts][, logps], pool) by flag;
    normalize to (out, counts|None, logps|None, pool)."""
    i = 1
    counts = lp = None
    if pen:
        counts = res[i]
        i += 1
    if want_lp:
        lp = res[i]
    return res[0], counts, lp, res[-1]


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


def _pick_token(sampler: Sampler, logits_row) -> int:
    """One token from a (V,) device logits row: greedy takes the argmax on
    the device and ships 4 bytes; top-k ships its prefix; a temperature
    alone ships the row; the parity sampler ships the softmax."""
    if sampler.greedy:
        return int(torch.argmax(logits_row))
    if sampler.transforms_logits and sampler.top_k:
        return _sample_rows_topk(sampler, logits_row[None], 1)[0]
    if sampler.transforms_logits:
        return sampler.sample_logits(_host(logits_row))
    return sampler.sample(_host(torch.softmax(logits_row, dim=-1)))


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
    otherwise (``device=None`` raises when no GPU is present).
    ``use_kernel=False`` selects the plain PyTorch attention instead of the
    CUDA kernels (the yardstick route)."""

    def __init__(self, params, cfg: GPT2Config,
                 econf: Optional[EngineConfig] = None, device=None,
                 use_kernel: bool = True):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.econf = econf = econf or EngineConfig()
        self._check_config()
        # int8 keeps the non-quantized leaves at activation_dtype
        dtype = _DTYPES[econf.activation_dtype if econf.param_dtype == "int8"
                        else econf.param_dtype]
        self.params = gpt2.to_device(params, cfg, dtype, self.device)
        quantized = self.params["wte"].dtype == torch.int8
        # the bf16 prefill copy is taken from the float params BEFORE
        # quantization; layernorm parameters stay fp32
        self._prefill_params = None
        if econf.prefill_param_dtype is not None:
            if econf.prefill_param_dtype != "bfloat16":
                raise ValueError("prefill_param_dtype: only 'bfloat16' is "
                                 f"supported, got "
                                 f"{econf.prefill_param_dtype!r}")
            if econf.param_dtype != "int8" or quantized:
                raise ValueError(
                    "prefill_param_dtype requires param_dtype='int8' with "
                    "FLOAT input params (it splits prefill/decode dtypes)")
            self._prefill_params = {
                k: (v.to(torch.bfloat16)
                    if k not in gpt2.LN_KEYS and v.dtype == torch.float32
                    else v)
                for k, v in self.params.items()}
        # int8 weights are quantized from the weights AFTER the cast to the
        # activation dtype
        if econf.param_dtype == "int8" and not quantized:
            self.params = quantize_params(self.params)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.use_kernel = use_kernel
        self.stats: Dict[str, float] = {}
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
            raise _later("mesh_shape", "training and tensor parallelism")
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
            toks.append(_pick_token(sampler, logits[0, -1]))
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
        toks.append(_pick_token(sampler, logits[0, -1]))
        for _ in range(max_new_tokens - 1):
            if stops and toks[-1] in stops:
                break
            pos = len(toks) - 1 - base
            logits, cache = gpt2.decode_step(
                self.params, torch.tensor([toks[-1]], dtype=torch.int32),
                torch.tensor([pos]), cache, cfg,
                wpe_pos=torch.tensor([min(pos, window - 1)]),
                starts=torch.tensor([max(0, pos + 1 - window)]))
            toks.append(_pick_token(sampler, logits[0]))
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
        if req.logprobs:
            if not econf.serve_logprobs:
                raise ValueError(
                    f"request {req.rid}: logprobs are disabled on this "
                    "engine (EngineConfig.serve_logprobs / CLI "
                    "--no-logprobs)")
            if econf.spec_k >= 2:
                raise ValueError(
                    f"request {req.rid}: logprobs under speculative "
                    "decoding are not supported (acceptance-variable "
                    "verify steps)")
            if econf.cache_mode != "paged":
                raise ValueError(
                    f"request {req.rid}: logprobs require paged serving")
        if req.prompt_logprobs:
            if not econf.serve_logprobs:
                raise ValueError(
                    f"request {req.rid}: logprobs are disabled on this "
                    "engine (EngineConfig.serve_logprobs / CLI "
                    "--no-logprobs)")
            if econf.cache_mode != "paged":
                raise ValueError(f"request {req.rid}: prompt_logprobs "
                                 "require paged serving")
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
            if econf.spec_k >= 2:
                raise ValueError(
                    f"request {req.rid}: penalties under speculative "
                    "decoding are not supported (the penalized pick is "
                    "not the verified raw argmax)")
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
                mgr = PrefixCachingBlockManager(page.num_pages,
                                                page.page_size, max_seqs)
                self._prefix_mgr = mgr
            else:
                # sequences a previous run left behind: their full hashed
                # pages demote to the cache (the across-run reuse)
                for pid in range(mgr.max_seqs):
                    mgr.free_prompt(pid)
        else:
            mgr = BlockManager(page.num_pages, page.page_size, max_seqs)
        pool = self._pool_cache
        self._pool_cache = None
        if pool is None:
            pool = init_pool(self.cfg, page, dtype=page.kv_dtype,
                             device=self.device)
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
        retired at the next iteration top or chain materialization."""
        cfg, econf = self.cfg, self.econf
        page = econf.page
        window = _check_window(window, cfg)
        sampler = sampler or self._default_sampler()
        if econf.spec_k >= 2 and not sampler.greedy:
            raise ValueError(
                "spec_k requires greedy serving: speculative verification "
                "accepts argmax matches; rejection sampling for the "
                "stochastic samplers is not implemented")
        sched = Scheduler(econf.max_batch)
        # a long-lived serving loop must not grow with request count:
        # finished requests are dropped after delivery; batch runs keep
        # them (run() returns them)
        retain_finished = feed is None
        n_finished = 0
        ttfts: "collections.deque" = collections.deque(maxlen=1024)
        dev = self.device

        def record_finished(r: Request) -> None:
            """Bookkeeping of every finish path; drops the request from
            sched.finished under serving (it was appended just before)."""
            nonlocal n_finished
            n_finished += 1
            if r.t_done is None:
                r.t_done = time.monotonic()
            if r.ttft is not None:
                ttfts.append(r.ttft)
            if not retain_finished:
                sched.finished.pop()

        def retire_unscheduled(r: Request) -> None:
            r.state = State.DONE
            sched.finished.append(r)
            record_finished(r)
            if on_finish is not None:
                on_finish(r)

        def submit_one(r: Request) -> None:
            if r.cancelled:        # cancelled before it ever reached us
                retire_unscheduled(r)
                return
            self.validate_request(r, window)
            if r.max_new_tokens <= 0:
                retire_unscheduled(r)
                return
            sched.submit(r)

        for r in requests:
            submit_one(r)

        # the pool is taken only after every request validated: a
        # ValueError above keeps the pool cache
        mgr, pool = self._paged_state()
        B = econf.max_batch
        pps = page.pages_per_seq
        t_start = time.monotonic()
        decode_tokens = 0
        decode_steps = 0        # device decode steps (each = L kernel calls)
        verify_steps = 0        # of which speculative verify steps
        single_steps = 0        # of which single-token steps
        suffix_prefills = 0     # prefix-cache suffix prefill calls
        peak_pages = 0
        iteration = 0
        # host wall-time breakdown: dispatch buckets measure host time to
        # build and enqueue work (the device runs asynchronously);
        # materialize measures the blocking device→host fetches
        tacc = {"prefill_dispatch": 0.0, "chain_dispatch": 0.0,
                "step_dispatch": 0.0, "materialize": 0.0}
        # per-slot count of prompt tokens dropped at admission (prompt
        # longer than the window); cache positions are relative to it
        bases: Dict[int, int] = {}
        # per-slot count of prompt tokens served from ADOPTED cached pages:
        # the suffix prefill starts at this position (0 without caching)
        cached: Dict[int, int] = {}
        prefix_on = page.prefix_cache
        prefix_stats = {"hit_tokens": 0, "hit_pages": 0, "registered": 0}
        use_spec = econf.spec_k >= 2
        spec_stats = {"steps": 0, "accepted": 0}
        # device sampling draws from one generator on the engine's device,
        # seeded per run; an all-greedy chain passes rng=None and keeps the
        # greedy stream
        sample_gen = None
        if econf.device_sampling:
            sample_gen = torch.Generator(device=dev)
            sample_gen.manual_seed(econf.seed)

        def requeue_evicted(evicted: List[int],
                            skip_slot: int = -1) -> List[int]:
            preempted = []
            for victim in set(evicted):
                if victim != skip_slot and victim in sched.running:
                    mgr.free_prompt(victim)
                    sched.preempt(victim)
                    preempted.append(victim)
            return preempted

        def apply_stop(req: Request) -> int:
            """Scan newly materialized tokens for a stop id; on a hit keep
            the stop token, discard the overshoot past it (and its
            logprobs) and mark the request stopped. Returns the discarded
            count. Runs before notify_tokens, so streams never see
            post-stop tokens."""
            stops = (req.stop_tokens if req.stop_tokens is not None
                     else econf.stop_tokens)
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

        def notify_tokens(req: Request) -> None:
            """Flush the tokens appended since the last flush (a watermark
            on the request, so it survives preemption)."""
            if on_tokens is None or req.cancelled:
                return
            n = len(req.generated)
            sent = getattr(req, "_stream_sent", 0)
            if n > sent:
                on_tokens(req, req.generated[sent:n])
                req._stream_sent = n

        def finish_slot(slot: int) -> None:
            req = sched.finish(slot)
            record_finished(req)
            # the live snapshot counts this finish before the callbacks
            # resolve the request's future
            update_live_stats()
            notify_tokens(req)
            if on_finish is not None:
                on_finish(req)

        def sweep_cancelled() -> None:
            """Retire requests cancelled since the last iteration. No
            chain is in flight at the iteration top, so a running row's
            pages free wholesale here as a finished row's do (the device
            runs in order). A cancel landing mid-chain is seen at that
            chain's materialization."""
            for req in [r for r in sched.waiting if r.cancelled]:
                sched.waiting.remove(req)
                retire_unscheduled(req)
            for slot, req in list(sched.running.items()):
                if req.cancelled:
                    mgr.free_prompt(slot)
                    finish_slot(slot)

        def update_live_stats() -> None:
            """Whole-dict swap, so readers on other threads (ServingEngine
            .stats(), HTTP GET /stats) never see a partial update.
            Counters only: a serving loop runs this every iteration."""
            dt = time.monotonic() - t_start
            self.live_stats = {
                "running": len(sched.running),
                "waiting": len(sched.waiting),
                "finished_total": n_finished,
                "decode_tokens": decode_tokens,
                "decode_tok_per_s": decode_tokens / dt if dt > 0 else 0.0,
                "pages_free": mgr.num_free(),
                "peak_pages_used": peak_pages,
                "preemptions": sched.preempt_count,
                "uptime_s": dt,
            }

        def poll_feed() -> None:
            """Serving, between chain links: arrivals join the waiting
            queue (a host queue check; nothing touches the device)."""
            nonlocal feed_open, queue_blocked
            new_reqs, feed_open = feed(False)
            for r in new_reqs:
                submit_one(r)
            queue_blocked = queue_blocked or bool(sched.waiting)

        feed_open = feed is not None
        while True:
            if feed_open:
                # requests that arrived join this iteration's admission
                # wave; an idle engine lets the feed block briefly
                new_reqs, feed_open = feed(not sched.has_work)
                for r in new_reqs:
                    submit_one(r)
            sweep_cancelled()
            update_live_stats()
            if not sched.has_work:
                if feed_open:
                    continue
                break
            iteration += 1
            if econf.log_every and iteration % econf.log_every == 0:
                dt = time.monotonic() - t_start
                print(f'{{"iter": {iteration}, '
                      f'"running": {len(sched.running)}, '
                      f'"waiting": {len(sched.waiting)}, '
                      f'"finished": {n_finished}, '
                      f'"pages_free": {mgr.num_free()}, '
                      f'"decode_tokens": {decode_tokens}, '
                      f'"tok_per_s": {decode_tokens / dt if dt else 0:.1f}}}',
                      flush=True)
            # ---- admission + one batched prefill per wave ----------------
            progressed = False
            # (device picks, device logprobs|None, group): greedy first
            # tokens picked on the device, fetched after the first link
            deferred = None
            admitted: List[Tuple[int, Request]] = []
            for slot in sched.free_slots():
                req = sched.pop_next_waiting()
                if req is None:
                    break
                base = max(0, len(req.tokens) - window)
                bases[slot] = base
                csl = 0
                if prefix_on:
                    # adopt the longest cached page chain matching the known
                    # tokens (prompt + any generated before a preemption),
                    # capped so that at least one token is prefilled
                    hit = mgr.match_prefix(req.tokens)
                    hit = hit[: (len(req.tokens) - 1) // page.page_size]
                    if hit:
                        mgr.adopt(slot, hit)
                        csl = len(hit) * page.page_size
                        prefix_stats["hit_pages"] += len(hit)
                        prefix_stats["hit_tokens"] += csl
                cached[slot] = csl
                segs, evicted = mgr.append_tokens(
                    slot, len(req.tokens) - base - csl)
                # a victim may be an earlier admission of this same wave:
                # drop it from the wave or its prefill would write K/V
                # through a cleared block table
                for victim in requeue_evicted(evicted, skip_slot=slot):
                    admitted = [(s, r) for s, r in admitted if s != victim]
                if not segs:
                    mgr.free_prompt(slot)
                    sched.waiting.insert(0, req)  # retry once pool drains
                    break
                progressed = True
                sched.admit(req, slot)
                admitted.append((slot, req))
            if admitted:
                t_pf0 = time.monotonic()
                group = admitted
                Tb = _bucket(max(len(req.tokens) - bases[slot]
                                 - cached[slot] for slot, req in group))
                Bg = 1 << (len(group) - 1).bit_length()
                xs = np.zeros((Bg, Tb), np.int32)
                valid = np.zeros((Bg, Tb), bool)
                tables_g = np.zeros((Bg, pps), np.int32)
                last = np.zeros(Bg, np.int64)
                offs = np.zeros(Bg, np.int32)
                for i, (slot, req) in enumerate(group):
                    skip = bases[slot] + cached[slot]
                    n = len(req.tokens) - skip
                    xs[i, :n] = req.tokens[skip:]
                    valid[i, :n] = True
                    tables_g[i] = mgr.block_table_array(slot, pps)
                    last[i] = n - 1
                    offs[i] = cached[slot]      # page-aligned by adopt
                pos = offs[:, None] + np.arange(Tb, dtype=np.int32)[None, :]
                pg, sl = token_coords(torch.from_numpy(tables_g),
                                      torch.from_numpy(pos), page.page_size,
                                      torch.from_numpy(valid), page.num_pages)
                plp_rows = [(i, req) for i, (slot, req) in enumerate(group)
                            if req.prompt_logprobs
                            and not req.prompt_logprob_values
                            and not req.generated]
                if offs.any():
                    # a row rides adopted pages: the suffix prefill attends
                    # the cached prefix through the block table (rows with
                    # offs 0 degenerate to plain prefill inside)
                    logits, pool = gpt2_paged.prefill_suffix_paged(
                        self._prefill_params or self.params,
                        torch.from_numpy(xs), pg, sl, pool,
                        torch.from_numpy(tables_g), torch.from_numpy(offs),
                        cfg, last_pos=torch.from_numpy(last),
                        use_kernel=self.use_kernel)             # (Bg, V)
                    suffix_prefills += 1
                elif plp_rows:
                    # scoring rows take the full (Bg, T, V) logits, the
                    # next-token logprobs are taken on the device and
                    # fetched once for the wave
                    full, pool = gpt2_paged.prefill_paged(
                        self._prefill_params or self.params,
                        torch.from_numpy(xs), pg, sl, pool, cfg,
                        last_pos=None,
                        use_kernel=self.use_kernel)             # (Bg, T, V)
                    logits, plp_d = _prefill_plp_extract(full, xs, valid,
                                                         last)
                    del full
                    plp = plp_d.cpu().numpy()
                    for i, req in plp_rows:
                        req.prompt_logprob_values = [
                            float(v) for v in plp[i, : len(req.prompt) - 1]]
                else:
                    logits, pool = gpt2_paged.prefill_paged(
                        self._prefill_params or self.params,
                        torch.from_numpy(xs), pg, sl, pool, cfg,
                        last_pos=torch.from_numpy(last),
                        use_kernel=self.use_kernel)             # (Bg, V)
                if prefix_on:
                    # publish this wave's full prompt pages only now, after
                    # the call that writes their K/V is queued (a same-wave
                    # evictee never prefills); the device runs in order,
                    # so a later adopter's reads see these writes
                    for slot, req in group:
                        prefix_stats["registered"] += mgr.register_prompt(
                            slot, req.tokens)
                group_reqs = [r for _, r in group]
                group_lp = any(r.logprobs for r in group_reqs)
                lg = logits[: len(group)]
                if all(_effective(sampler, r)[0] for r in group_reqs) \
                        and not any(_has_penalties(r) for r in group_reqs):
                    # greedy: pick on the device and fetch after the first
                    # chain link is queued, so the download overlaps decode
                    picks_d = torch.argmax(lg, dim=-1).int()
                    lps_d = None
                    if group_lp:
                        lgf = lg.float()
                        lps_d = (torch.gather(lgf, 1,
                                              picks_d.long()[:, None])[:, 0]
                                 - torch.logsumexp(lgf, dim=-1))
                    deferred = (picks_d, lps_d, list(group))
                else:
                    # a sampled or penalized row draws its first token now,
                    # from the host stream in row order
                    if any(_has_overrides(r) or _has_penalties(r)
                           for r in group_reqs):
                        first_toks = _sample_rows_per_request(
                            sampler, lg, group_reqs)
                    else:
                        first_toks = _sample_rows(sampler, lg, len(group))
                    lrows = _host(lg) if group_lp else None
                    for i, (slot, req) in enumerate(group):
                        req.generated.append(first_toks[i])
                        if req.logprobs:
                            req.logprob_values.append(
                                _row_logprob(lrows[i], first_toks[i]))
                        req.mark_first_token()
                        apply_stop(req)
                        notify_tokens(req)
                        if req.done:
                            mgr.free_prompt(slot)
                            finish_slot(slot)
                tacc["prefill_dispatch"] += time.monotonic() - t_pf0

            def flush_deferred():
                """Materialize the deferred prefill picks (and logprobs, in
                the same copy). Runs before any path that reads
                req.tokens[-1] on the host."""
                nonlocal deferred, progressed
                if deferred is None:
                    return
                t_m0 = time.monotonic()
                picks, lps = _fetch(deferred[0], deferred[1])
                tacc["materialize"] += time.monotonic() - t_m0
                for i, (slot, req) in enumerate(deferred[2]):
                    req.generated.append(int(picks[i]))
                    if req.logprobs and lps is not None:
                        req.logprob_values.append(float(lps[i]))
                    req.mark_first_token()
                    apply_stop(req)
                    notify_tokens(req)
                    if req.done:
                        mgr.free_prompt(slot)
                        finish_slot(slot)
                progressed = True
                deferred = None

            # ---- sliding-window page reclamation -------------------------
            if window < page.max_context:
                for slot, req in sched.running.items():
                    start = len(req.tokens) - bases.get(slot, 0) - window
                    if start >= page.page_size:
                        mgr.release_below(slot, start)
            peak_pages = max(peak_pages, page.num_pages - mgr.num_free())

            # ---- chunked decode ------------------------------------------
            chunk = 1
            # a batch whose every row is effectively greedy chains; a
            # stochastic row needs device sampling to chain (the host
            # stream cannot feed back on the device)
            all_greedy = all(_effective(sampler, r)[0]
                             for r in sched.running.values())
            row_overrides = any(_has_overrides(r)
                                for r in sched.running.values())
            chainable = all_greedy or econf.device_sampling
            # once admission has run, anything still waiting is blocked on
            # slots or pages: chains run anyway but stay short
            queue_blocked = bool(sched.waiting)
            # a streaming consumer, or a stop (seen only at
            # materialization), caps chains at stream_links links
            stream_cap = (econf.stream_links
                          if any((r.stream and on_tokens is not None)
                                 or (r.stop_tokens if r.stop_tokens
                                     is not None else econf.stop_tokens)
                                 for r in sched.running.values())
                          else 0)

            def cancel_pending() -> bool:
                """A running row was cancelled from another thread: break
                the chain at this link so the materialization retires it
                now, not at the chain's end."""
                return any(r.cancelled for r in sched.running.values())

            def defer_counts():
                """One not-yet-appended token per slot with a deferred
                prefill pick."""
                return {s: 1 for s, _ in deferred[2]} if deferred else {}

            # ---- speculative chunk chain (EngineConfig.spec_k) ---------
            # Like the chain below, but each device step VERIFIES spec_k
            # tokens (carried token + device n-gram drafts) and yields
            # 1..spec_k of them. Acceptance is data-dependent, so the host
            # reserves the maximum (S*spec_k tokens a row a link) and rolls
            # the manager back to the accepted length with truncate_to
            # once the chain materializes.
            if use_spec and sched.running:
                flush_deferred()   # the spec chain reads req.tokens
                S = max(1, econf.decode_chunk)
                Ksp = econf.spec_k
                TK = S * Ksp
                ps = page.page_size
                pending_spec: List = []   # (out dev, counts dev, plan)
                t_cd0 = time.monotonic()
                links = 0
                hist_d = first_d = pos0_d = None
                pre_len: Dict[int, int] = {}
                gen_before = {s: len(r.generated)
                              for s, r in sched.running.items()}
                while True:
                    plan: List[int] = []
                    need_pages = 0
                    for slot, req in sched.running.items():
                        rem = req.max_new_tokens - gen_before[slot]
                        if links * S >= rem:
                            # >= 1 token is accepted a step: the row has
                            # finished in earlier links
                            continue
                        ln = mgr.seq_len(slot)
                        if ln + TK > page.max_context:
                            continue   # no headroom for a full reservation
                        tail = (ps - ln % ps) % ps
                        need_pages += max(0, -(-(TK - tail) // ps))
                        plan.append(slot)
                    if not plan or need_pages > mgr.num_free():
                        break
                    for slot in plan:
                        pre_len.setdefault(slot, mgr.seq_len(slot))
                        segs, evicted = mgr.append_tokens(slot, TK)
                        if evicted:
                            raise RuntimeError(
                                "free-page guard failed: eviction inside a "
                                f"speculative chain (victims {evicted})")
                    tables = np.zeros((B, pps), np.int32)
                    for slot in plan:
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
                            to_device(torch.from_numpy(keep), dev),
                            pos0_d, -1)
                    out_d, counts_d, hist_d, first_d, pos0_d, pool = \
                        gpt2_paged.decode_chunk_spec(
                            self.params, first_d, pos0_d, hist_d, pool,
                            torch.from_numpy(tables), cfg, num_steps=S,
                            spec_k=Ksp, ngram=econf.spec_ngram,
                            use_kernel=self.use_kernel, active=keep)
                    decode_steps += S
                    verify_steps += S
                    pending_spec.append((out_d, counts_d, list(plan)))
                    links += 1
                    peak_pages = max(peak_pages,
                                     page.num_pages - mgr.num_free())
                    if feed_open:        # serving: arrivals break chains
                        poll_feed()
                    update_live_stats()  # per-link snapshot
                    # acceptance is data-dependent: a row MAY have finished
                    # once links*S*spec_k covers its remaining budget
                    may_free = any(
                        sched.running[s].max_new_tokens - gen_before[s]
                        <= links * S * Ksp for s in plan)
                    if stream_cap and links >= stream_cap:
                        break
                    if cancel_pending():
                        break
                    if queue_blocked or ((feed_open or on_finish is not None)
                                         and may_free):
                        # under queue pressure a row may finish at ANY
                        # link: materialize so its slot and pages free;
                        # when serving, deliver a finished row now
                        break
                tacc["chain_dispatch"] += time.monotonic() - t_cd0
                if pending_spec:
                    progressed = True
                    t_m0 = time.monotonic()
                    # one device→host copy for the whole chain: the tokens
                    # and counts of every link in one tensor
                    n_out = S * Ksp * B
                    flat = torch.stack([
                        torch.cat([o.reshape(-1), c.reshape(-1)])
                        for o, c, _ in pending_spec]).cpu().numpy()
                    tacc["materialize"] += time.monotonic() - t_m0
                    all_out = flat[:, :n_out].reshape(-1, S, Ksp, B)
                    all_cnt = flat[:, n_out:].reshape(-1, S, B)
                    committed = {s: 0 for s in pre_len}
                    for li, (_, _, plan) in enumerate(pending_spec):
                        for slot in plan:
                            req = sched.running[slot]
                            for s_i in range(S):
                                cnt = int(all_cnt[li, s_i, slot])
                                req.generated.extend(
                                    int(t)
                                    for t in all_out[li, s_i, :cnt, slot])
                            committed[slot] += int(all_cnt[li, :, slot].sum())
                            spec_stats["steps"] += S
                    for slot, pre in pre_len.items():
                        req = sched.running[slot]
                        spec_stats["accepted"] += committed[slot]
                        mgr.truncate_to(slot, pre + committed[slot])
                        if len(req.generated) > req.max_new_tokens:
                            del req.generated[req.max_new_tokens:]
                        apply_stop(req)
                        decode_tokens += len(req.generated) - gen_before[slot]
                        notify_tokens(req)
                    for slot in list(sched.running):
                        if sched.running[slot].done:
                            mgr.free_prompt(slot)
                            finish_slot(slot)
                    # a row still needing tokens but WITHOUT headroom for a
                    # full reservation can never join a spec plan: fall
                    # through to the plain chain for it, or it would starve
                    if not any(
                            r.max_new_tokens > len(r.generated)
                            and mgr.seq_len(sl) + TK > page.max_context
                            for sl, r in sched.running.items()):
                        continue
                # the spec chain could not run (pool pressure, no headroom):
                # fall through to the plain chain, which needs fewer pages
                # a link, and the single-token step below it

            dct = defer_counts()
            if chainable and sched.running:
                # capacity-bound only: rows that reach max_new mid-chunk are
                # truncated on the host
                cap = min(page.max_context
                          - (len(r.tokens) - bases.get(s2, 0)
                             + dct.get(s2, 0))
                          for s2, r in sched.running.items())
                dc = max(1, econf.decode_chunk)
                if queue_blocked and sched.free_slots():
                    dc = max(dc // 4, 1)   # page-blocked: shorter chunks
                for cand in (dc, max(dc // 4, 1)):
                    if cap >= cand > 1:
                        chunk = cand
                        break
            if chunk > 1 and sched.running:
                # chain: tokens feed back on the device within and between
                # chunks; page coordinates are reserved ahead and each link
                # is guarded by a free-page check, so no eviction happens
                # mid-chain; token values come back ONCE after the chain
                ps = page.page_size
                # the chain's sampling mode: an all-greedy chain keeps the
                # argmax (rng None); a uniform sampled batch passes the
                # sampler's scalars; only per-request overrides build (B,)
                # arrays. Everything goes up once a chain.
                chain_rng = sample_gen is not None and not all_greedy
                want_lp = any(r.logprobs for r in sched.running.values())
                samp_kw = {}
                if chain_rng and row_overrides:
                    tarr = np.ones(B, np.float32)
                    karr = np.zeros(B, np.int32)
                    garr = np.zeros(B, bool)
                    kmax = 0
                    for slot2, r2 in sched.running.items():
                        g2, tk2, tmp2 = _effective(sampler, r2)
                        garr[slot2] = g2
                        tarr[slot2] = tmp2 if not g2 else 1.0
                        if not g2 and tk2 and tk2 < cfg.vocab_size:
                            # tk2 >= V means no filter (the host
                            # topk_probs bound), not a clamp to V-1
                            karr[slot2] = tk2
                            kmax = max(kmax, tk2)
                    # a power-of-two cap, below V so the filter stays on
                    kcap = (min(1 << (kmax - 1).bit_length(),
                                cfg.vocab_size - 1) if kmax else None)
                    karr = np.minimum(karr, kcap or 0)
                    samp_kw = dict(
                        rng=sample_gen, top_k=kcap,
                        temperature=to_device(torch.from_numpy(tarr), dev),
                        k_arr=(to_device(torch.from_numpy(karr), dev)
                               if kcap else None),
                        greedy_rows=to_device(torch.from_numpy(garr), dev))
                elif chain_rng:
                    samp_kw = dict(rng=sample_gen, top_k=sampler.top_k,
                                   temperature=sampler.temperature)
                # penalties thread a (B, V) count plane through the chain:
                # built on the host from each row's full context at chain
                # start, uploaded once, updated on the device with each
                # pick
                pen_kw = {}
                if any(_has_penalties(r) for r in sched.running.values()):
                    fparr = np.zeros(B, np.float32)
                    pparr = np.zeros(B, np.float32)
                    cnt0 = np.zeros((B, cfg.vocab_size), np.int32)
                    for slot2, r2 in sched.running.items():
                        fparr[slot2] = r2.frequency_penalty
                        pparr[slot2] = r2.presence_penalty
                        np.add.at(cnt0[slot2],
                                  np.clip(np.asarray(r2.tokens), 0,
                                          cfg.vocab_size - 1), 1)
                    pen_kw = dict(
                        pen_counts=to_device(torch.from_numpy(cnt0), dev),
                        freq_pen=to_device(torch.from_numpy(fparr), dev),
                        pres_pen=to_device(torch.from_numpy(pparr), dev))
                pending: List = []   # (toks (chunk,B), logps|None, stepped)
                pend_counts: Dict[int, int] = {}
                first_dev = None
                t_cd0 = time.monotonic()
                while True:
                    dct = defer_counts()
                    need_pages = 0
                    plan: List[int] = []
                    for slot, req in sched.running.items():
                        rem = (req.max_new_tokens - len(req.generated)
                               - dct.get(slot, 0) - pend_counts.get(slot, 0))
                        if rem <= 0:
                            continue
                        if window < page.max_context:
                            # mid-chain reclamation: safe to reallocate at
                            # once, the device stream is in order
                            start = mgr.seq_len(slot) - window
                            if start >= ps:
                                mgr.release_below(slot, start)
                        ln = mgr.seq_len(slot)
                        if ln + chunk > page.max_context:
                            continue
                        tail = (ps - ln % ps) % ps
                        need_pages += max(0, -(-(chunk - tail) // ps))
                        plan.append(slot)
                    if not plan or need_pages > mgr.num_free():
                        break
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
                            # an eviction here would write K/V through a
                            # cleared block table into another sequence
                            raise RuntimeError(
                                "free-page guard failed: eviction inside a "
                                f"chunk chain (victims {evicted})")
                        coords = [(s.page, s.offset + i) for s in segs
                                  for i in range(s.count)]
                        if len(coords) != chunk:
                            raise RuntimeError("chunk reservation short")
                        first[slot] = req.tokens[-1]  # used by link 0 only
                        pos0[slot] = (len(req.tokens) - 1 + pend_ct
                                      + dct.get(slot, 0)
                                      - bases.get(slot, 0))
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
                    if econf.debug_checks:
                        _validate_indices(page, tables, pgs, sls)
                    if first_dev is not None:
                        link_first = first_dev
                    else:
                        link_first = to_device(torch.from_numpy(first), dev)
                        if deferred is not None:
                            dslots = to_device(torch.tensor(
                                [s for s, _ in deferred[2]]), dev)
                            link_first[dslots] = deferred[0]
                    res = gpt2_paged.decode_chunk_paged(
                        self.params, link_first, torch.from_numpy(pos0),
                        torch.from_numpy(pgs), torch.from_numpy(sls),
                        torch.from_numpy(tables), pool, cfg,
                        num_steps=chunk, window=window,
                        use_kernel=self.use_kernel, want_logprobs=want_lp,
                        **samp_kw, **pen_kw)
                    toks_out, counts_out, lp_out, pool = _unpack_chunk(
                        res, bool(pen_kw), want_lp)
                    if counts_out is not None:
                        pen_kw["pen_counts"] = counts_out
                    decode_steps += chunk
                    first_dev = toks_out[-1]
                    pending.append((toks_out, lp_out, stepped))
                    # the first link is queued: fetch the deferred picks
                    flush_deferred()
                    peak_pages = max(peak_pages,
                                     page.num_pages - mgr.num_free())
                    if feed_open:        # serving: arrivals break chains
                        poll_feed()
                    update_live_stats()  # per-link snapshot
                    if stream_cap and len(pending) >= stream_cap:
                        break
                    if cancel_pending():
                        break
                    if (feed_open or on_finish is not None) and will_free:
                        break   # deliver the finishing row now
                    if queue_blocked and \
                            (will_free or window < page.max_context
                             or sched.free_slots()):
                        # under queue pressure, materialize as soon as a
                        # row can finish (or pages/slots may free) so the
                        # waiting queue gets its admission retry
                        break
                tacc["chain_dispatch"] += time.monotonic() - t_cd0
                if pending:
                    progressed = True
                    flush_deferred()
                    t_m0 = time.monotonic()
                    # one device→host copy for the whole chain: tokens and
                    # logprobs together
                    all_picks, all_lps = _fetch(
                        torch.stack([t for t, _, _ in pending]),
                        torch.stack([p for _, p, _ in pending])
                        if want_lp else None)
                    tacc["materialize"] += time.monotonic() - t_m0
                    for li, (picks, (_, _, stepped)) in enumerate(
                            zip(all_picks, pending)):
                        for slot, keep in stepped:
                            req = sched.running.get(slot)
                            if req is None or req.stopped:
                                continue   # finished at its first token
                            req.generated.extend(int(t)
                                                 for t in picks[:keep, slot])
                            if req.logprobs and all_lps is not None:
                                req.logprob_values.extend(
                                    float(v)
                                    for v in all_lps[li, :keep, slot])
                            decode_tokens += keep
                    for slot in {s for _, _, st in pending for s, _ in st}:
                        req = sched.running.get(slot)
                        if req is not None:
                            decode_tokens -= apply_stop(req)
                            notify_tokens(req)
                    for slot in list(sched.running):
                        if sched.running[slot].done:
                            mgr.free_prompt(slot)
                            finish_slot(slot)
                    continue
                chunk = 1   # no chain could run: single-token step below

            # ---- single-token decode step --------------------------------
            flush_deferred()
            if sched.running:
                toks = np.zeros(B, np.int32)
                wpe_pos = np.zeros(B, np.int32)
                pg = np.full(B, page.num_pages, np.int32)
                sl = np.zeros(B, np.int32)
                lengths = np.zeros(B, np.int32)
                starts = np.zeros(B, np.int32)
                tables = np.zeros((B, pps), np.int32)
                stepped_s: List[int] = []
                for slot, req in list(sched.running.items()):
                    if slot not in sched.running:
                        continue   # preempted by an earlier slot's eviction
                    segs, evicted = mgr.append_tokens(slot, 1)
                    # a victim already staged in this batch is neutralized
                    # so its K/V write cannot hit the page's new owner
                    for victim in requeue_evicted(evicted, skip_slot=slot):
                        if victim in stepped_s:
                            stepped_s.remove(victim)
                            pg[victim] = page.num_pages
                            lengths[victim] = 0
                    if not segs:
                        mgr.free_prompt(slot)
                        sched.preempt(slot)
                        continue
                    pos = len(req.tokens) - 1 - bases.get(slot, 0)
                    toks[slot] = req.tokens[-1]
                    wpe_pos[slot] = min(pos, window - 1)
                    pg[slot], sl[slot] = segs[0].page, segs[0].offset
                    lengths[slot] = pos + 1
                    starts[slot] = max(0, pos + 1 - window)
                    tables[slot] = mgr.block_table_array(slot, pps)
                    stepped_s.append(slot)
                if stepped_s:
                    progressed = True
                    if econf.debug_checks:
                        _validate_indices(page, tables, pg[None], sl[None],
                                          lengths)
                    t_sd0 = time.monotonic()
                    logits, pool = gpt2_paged.decode_step_paged(
                        self.params, torch.from_numpy(toks),
                        torch.from_numpy(wpe_pos), torch.from_numpy(pg),
                        torch.from_numpy(sl), torch.from_numpy(tables),
                        torch.from_numpy(lengths), pool, cfg,
                        use_kernel=self.use_kernel,
                        starts=torch.from_numpy(starts))
                    tacc["step_dispatch"] += time.monotonic() - t_sd0
                    decode_steps += 1
                    single_steps += 1
                    decode_tokens += len(stepped_s)
                    # rows gathered in `stepped_s` order so the parity RNG
                    # stream is consumed per stepped row, in order
                    step_reqs = [sched.running[s] for s in stepped_s]
                    t_m0 = time.monotonic()
                    step_logits = logits[to_device(torch.tensor(stepped_s),
                                                   dev)]
                    if any(_has_overrides(r) or _has_penalties(r)
                           for r in step_reqs):
                        row_toks = _sample_rows_per_request(
                            sampler, step_logits, step_reqs)
                    else:
                        row_toks = _sample_rows(sampler, step_logits,
                                                len(stepped_s))
                    lrows = (_host(step_logits)
                             if any(r.logprobs for r in step_reqs) else None)
                    tacc["materialize"] += time.monotonic() - t_m0
                    for i, (slot, tok) in enumerate(zip(stepped_s,
                                                        row_toks)):
                        req = sched.running[slot]
                        req.generated.append(tok)
                        if req.logprobs:
                            req.logprob_values.append(
                                _row_logprob(lrows[i], tok))
                        apply_stop(req)
                        notify_tokens(req)
                        if req.done:
                            mgr.free_prompt(slot)
                            finish_slot(slot)

            if not progressed and not sched.running:
                raise RuntimeError(
                    "scheduler stalled: pool too small for any waiting "
                    "request (need a larger page pool or shorter prompts)")

        self._pool_cache = pool
        update_live_stats()
        dt = time.monotonic() - t_start
        self.stats = {
            "wall_s": dt,
            "decode_tokens": decode_tokens,
            "decode_steps": decode_steps,
            "decode_tok_per_s": decode_tokens / dt if dt > 0 else 0.0,
            "peak_pages_used": peak_pages,
            "preemptions": sched.preempt_count,
            # the last 1024 finishes: exact for batch runs, a recent
            # window for long-lived serving
            "p50_ttft_s": float(np.median(ttfts)) if ttfts else 0.0,
            "t_prefill_dispatch_s": round(tacc["prefill_dispatch"], 4),
            "t_chain_dispatch_s": round(tacc["chain_dispatch"], 4),
            "t_step_dispatch_s": round(tacc["step_dispatch"], 4),
            "t_materialize_s": round(tacc["materialize"], 4),
            "verify_steps": verify_steps,
            "single_steps": single_steps,
            "suffix_prefills": suffix_prefills,
        }
        if use_spec:
            # spec_steps counts S per row per link; spec_tok_per_step is
            # committed tokens per verify step (overshoot included): the
            # raw acceptance of the drafting, in [1, spec_k]
            self.stats["spec_steps"] = spec_stats["steps"]
            self.stats["spec_tok_per_step"] = round(
                spec_stats["accepted"] / spec_stats["steps"], 3) \
                if spec_stats["steps"] else 0.0
        if prefix_on:
            # prompt tokens served from adopted pages (their prefill was
            # skipped) and the cache's occupancy after the run
            self.stats["prefix_hit_tokens"] = prefix_stats["hit_tokens"]
            self.stats["prefix_hit_pages"] = prefix_stats["hit_pages"]
            self.stats["prefix_pages_registered"] = \
                prefix_stats["registered"]
            self.stats["prefix_cached_pages"] = mgr.num_cached()
        return sched.finished

    def warmup(self, window: Optional[int] = None) -> Dict[str, float]:
        """Run the JAX package's throwaway requests through every path
        this engine's configuration can reach (the smallest prefill
        bucket and the decode chain or single-token step, then the
        logprobs and prompt-logprobs variants when serve_logprobs), so
        that the first tenant of a server pays none of the first-use
        costs: on the card, the CUDA kernels build (all four serving
        sources at once, the long-prompt prefill's flash kernel
        included, "build") and the caching allocator warms.
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

        def one(tag: str, **kw) -> None:
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

        one("default")                  # prefill bucket + chunk/step path
        if self.econf.serve_logprobs:
            if self.econf.spec_k < 2:
                one("logprobs", logprobs=True)
            if not self.econf.page.prefix_cache:
                one("prompt_logprobs", prompt_logprobs=True)
        return timings
