"""L4: the paged serving engine (port of the paged ``run()`` path of
llmc_paged_tpu/engine/engine.py).

Continuous batching over the paged pool, greedy:
  * admission waves, each with ONE padded prefill (rows padded to the
    wave's longest 16-token bucket, a power-of-two batch, logits only at
    each row's last prompt position); the first tokens are picked on the
    device and fetched after the first decode link is queued;
  * sliding-window page reclamation;
  * chains of K-step decode chunks: pages reserved K tokens ahead, a
    free-page guard so no eviction happens mid-chain, tokens fed back on
    the device between links, and ONE device→host copy per chain;
  * a single-token step when no chain can run, with LRU preemption and
    requeue of the victims;
  * stop tokens.

Host↔device traffic per link: a few int32 metadata arrays go up (first
tokens, positions, page/slot coordinates, block tables); tokens come down
once per chain. Options outside this slice of the port raise
NotImplementedError and name their ROADMAP item.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from llmc_paged_tpu_torch import resolve_device
from llmc_paged_tpu_torch.config import EngineConfig, GPT2Config, PageConfig
from llmc_paged_tpu_torch.engine.scheduler import Request, Scheduler, State
from llmc_paged_tpu_torch.kv.layouts import init_pool, token_coords
from llmc_paged_tpu_torch.kv.manager import BlockManager
from llmc_paged_tpu_torch.models import gpt2, gpt2_paged
from llmc_paged_tpu_torch.ops.int8 import quantize_params

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _later(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not in the torch port yet (ROADMAP.md, 'Left to port': "
        f"{item})")


def _bucket(n: int, step: int = 16) -> int:
    """Pad prefill lengths to buckets (bounded shape variety)."""
    return max(step, ((n + step - 1) // step) * step)


def _validate_indices(page_cfg: PageConfig, tables: np.ndarray,
                      pgs: np.ndarray, sls: np.ndarray,
                      lengths: Optional[np.ndarray] = None) -> None:
    """Host-side bounds check of every device index
    (EngineConfig.debug_checks); page == num_pages is the drop sentinel."""
    if not (tables.min() >= 0 and tables.max() < page_cfg.num_pages):
        raise ValueError("block table entry out of range")
    if not (pgs.min() >= 0 and pgs.max() <= page_cfg.num_pages):
        raise ValueError("page coordinate out of range")
    if not (sls.min() >= 0 and sls.max() < page_cfg.page_size):
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
    """Paged GPT-2 serving on one device: the card unless ``device`` says
    otherwise (``device=None`` raises when no GPU is present).
    ``use_kernel=False`` selects the plain PyTorch attention instead of the
    CUDA kernel (the yardstick route)."""

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
        # the pool is kept across run() calls: stale contents are never
        # read (tables and lengths only cover tokens of the current run)
        self._pool_cache = None

    def _check_config(self) -> None:
        econf, page = self.econf, self.econf.page
        if econf.cache_mode != "paged":
            raise _later(f"cache_mode={econf.cache_mode!r}",
                         "the dense and no-cache modes")
        if econf.spec_k >= 2:
            raise _later("spec_k >= 2", "the multi-query kernel with "
                         "speculative decode and prefix caching")
        if page.prefix_cache:
            raise _later("prefix_cache", "the multi-query kernel with "
                         "speculative decode and prefix caching")
        if econf.mesh_shape:
            raise _later("mesh_shape", "training and tensor parallelism")
        if econf.device_sampling:
            raise _later("device_sampling", "host sampling and device "
                         "sampling")
        if not econf.greedy:
            raise _later("non-greedy sampling", "host sampling and device "
                         "sampling")
        if econf.param_dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(f"param_dtype {econf.param_dtype!r}")
        if econf.activation_dtype not in _DTYPES:
            raise ValueError(f"activation_dtype {econf.activation_dtype!r}")
        if page.kv_dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(f"kv_dtype {page.kv_dtype!r}")

    def validate_request(self, req: Request,
                         window: Optional[int] = None) -> None:
        """Raise if ``req`` could never be scheduled (ValueError) or asks
        for an option outside this slice of the port
        (NotImplementedError)."""
        page = self.econf.page
        window = _check_window(window, self.cfg)
        if not req.prompt:
            raise ValueError(f"request {req.rid} has an empty prompt")
        if req.logprobs or req.prompt_logprobs:
            raise _later("logprobs", "logprobs and penalties")
        if req.frequency_penalty or req.presence_penalty:
            raise _later("penalties", "logprobs and penalties")
        if req.greedy is not None or req.top_k is not None \
                or req.temperature is not None:
            raise _later("per-request sampling overrides",
                         "host sampling and device sampling")
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

    def _paged_state(self):
        page = self.econf.page
        mgr = BlockManager(page.num_pages, page.page_size,
                           max(page.max_seqs, self.econf.max_batch))
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
        filled). ``on_finish(req)`` is called as each request finishes.
        ``sampler``, ``feed`` and ``on_tokens`` belong to later slices."""
        if sampler is not None:
            raise _later("a host sampler", "host sampling and device "
                         "sampling")
        if feed is not None or on_tokens is not None:
            raise _later("feed/on_tokens", "formats/tokenizer/CLI/server/"
                         "HTTP")
        cfg, econf = self.cfg, self.econf
        page = econf.page
        window = _check_window(window, cfg)
        sched = Scheduler(econf.max_batch)
        ttfts: "collections.deque" = collections.deque(maxlen=1024)
        dev = self.device

        def record_finished(r: Request) -> None:
            if r.t_done is None:
                r.t_done = time.monotonic()
            if r.ttft is not None:
                ttfts.append(r.ttft)
            if on_finish is not None:
                on_finish(r)

        for r in requests:
            self.validate_request(r, window)
        for r in requests:
            if r.cancelled or r.max_new_tokens <= 0:
                r.state = State.DONE
                sched.finished.append(r)
                record_finished(r)
            else:
                sched.submit(r)

        mgr, pool = self._paged_state()
        B = econf.max_batch
        pps = page.pages_per_seq
        t_start = time.monotonic()
        decode_tokens = 0
        decode_steps = 0        # device decode steps (each = L kernel calls)
        peak_pages = 0
        iteration = 0
        # host wall-time breakdown: dispatch buckets measure host time to
        # build and enqueue work (the device runs asynchronously);
        # materialize measures the blocking device→host fetches
        tacc = {"prefill_dispatch": 0.0, "chain_dispatch": 0.0,
                "materialize": 0.0}
        # per-slot count of prompt tokens dropped at admission (prompt
        # longer than the window); cache positions are relative to it
        bases: Dict[int, int] = {}

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
            the stop token, discard the overshoot past it and mark the
            request stopped. Returns the discarded count."""
            stops = (req.stop_tokens if req.stop_tokens is not None
                     else econf.stop_tokens)
            if not stops or req.stopped:
                return 0
            gen = req.generated
            for k in range(getattr(req, "_stop_scanned", 0), len(gen)):
                if gen[k] in stops:
                    discarded = len(gen) - (k + 1)
                    del gen[k + 1:]
                    req.stopped = True
                    return discarded
            req._stop_scanned = len(gen)
            return 0

        def finish_slot(slot: int) -> None:
            record_finished(sched.finish(slot))

        while sched.has_work:
            iteration += 1
            if econf.log_every and iteration % econf.log_every == 0:
                dt = time.monotonic() - t_start
                print(f'{{"iter": {iteration}, '
                      f'"running": {len(sched.running)}, '
                      f'"waiting": {len(sched.waiting)}, '
                      f'"finished": {len(sched.finished)}, '
                      f'"pages_free": {mgr.num_free()}, '
                      f'"decode_tokens": {decode_tokens}, '
                      f'"tok_per_s": {decode_tokens / dt if dt else 0:.1f}}}',
                      flush=True)
            # ---- admission + one batched prefill per wave ----------------
            progressed = False
            deferred = None   # (device picks, group): greedy first tokens
            admitted: List[Tuple[int, Request]] = []
            for slot in sched.free_slots():
                req = sched.pop_next_waiting()
                if req is None:
                    break
                base = max(0, len(req.tokens) - window)
                bases[slot] = base
                segs, evicted = mgr.append_tokens(slot,
                                                  len(req.tokens) - base)
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
                                 for slot, req in group))
                Bg = 1 << (len(group) - 1).bit_length()
                xs = np.zeros((Bg, Tb), np.int32)
                valid = np.zeros((Bg, Tb), bool)
                tables_g = np.zeros((Bg, pps), np.int32)
                last = np.zeros(Bg, np.int64)
                for i, (slot, req) in enumerate(group):
                    n = len(req.tokens) - bases[slot]
                    xs[i, :n] = req.tokens[bases[slot]:]
                    valid[i, :n] = True
                    tables_g[i] = mgr.block_table_array(slot, pps)
                    last[i] = n - 1
                pos = np.tile(np.arange(Tb, dtype=np.int32), (Bg, 1))
                pg, sl = token_coords(torch.from_numpy(tables_g),
                                      torch.from_numpy(pos), page.page_size,
                                      torch.from_numpy(valid), page.num_pages)
                logits, pool = gpt2_paged.prefill_paged(
                    self._prefill_params or self.params,
                    torch.from_numpy(xs), pg, sl, pool, cfg,
                    last_pos=torch.from_numpy(last))            # (Bg, V)
                # pick on the device and fetch after the first chain link
                # is queued, so the download overlaps decode
                picks_d = torch.argmax(logits[: len(group)], dim=-1).int()
                deferred = (picks_d, list(group))
                tacc["prefill_dispatch"] += time.monotonic() - t_pf0

            def flush_deferred():
                """Materialize the deferred prefill picks. Runs before any
                path that reads req.tokens[-1] on the host."""
                nonlocal deferred, progressed
                if deferred is None:
                    return
                t_m0 = time.monotonic()
                picks = deferred[0].cpu().numpy()
                tacc["materialize"] += time.monotonic() - t_m0
                for i, (slot, req) in enumerate(deferred[1]):
                    req.generated.append(int(picks[i]))
                    req.mark_first_token()
                    apply_stop(req)
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

            # ---- chunked greedy decode -----------------------------------
            chunk = 1
            # once admission has run, anything still waiting is blocked on
            # slots or pages: chains run anyway but stay short
            queue_blocked = bool(sched.waiting)
            # a stop is only seen at materialization: cap chains at
            # stream_links links while a row has stop ids
            stream_cap = (econf.stream_links
                          if any(r.stop_tokens if r.stop_tokens is not None
                                 else econf.stop_tokens
                                 for r in sched.running.values())
                          else 0)

            def defer_counts():
                """One not-yet-appended token per slot with a deferred
                prefill pick."""
                return {s: 1 for s, _ in deferred[1]} if deferred else {}

            dct = defer_counts()
            if sched.running:
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
                pending: List = []   # (toks (chunk,B) device, [(slot, keep)])
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
                        link_first = torch.from_numpy(first).to(dev)
                        if deferred is not None:
                            dslots = torch.tensor(
                                [s for s, _ in deferred[1]], device=dev)
                            link_first[dslots] = deferred[0]
                    toks_out, pool = gpt2_paged.decode_chunk_paged(
                        self.params, link_first, torch.from_numpy(pos0),
                        torch.from_numpy(pgs), torch.from_numpy(sls),
                        torch.from_numpy(tables), pool, cfg,
                        num_steps=chunk, window=window,
                        use_kernel=self.use_kernel)
                    decode_steps += chunk
                    first_dev = toks_out[-1]
                    pending.append((toks_out, stepped))
                    # the first link is queued: fetch the deferred picks
                    flush_deferred()
                    peak_pages = max(peak_pages,
                                     page.num_pages - mgr.num_free())
                    if stream_cap and len(pending) >= stream_cap:
                        break
                    if on_finish is not None and will_free:
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
                    # one device→host copy for the whole chain
                    all_picks = torch.stack(
                        [t for t, _ in pending]).cpu().numpy()
                    tacc["materialize"] += time.monotonic() - t_m0
                    for picks, (_, stepped) in zip(all_picks, pending):
                        for slot, keep in stepped:
                            req = sched.running.get(slot)
                            if req is None or req.stopped:
                                continue   # finished at its first token
                            req.generated.extend(int(t)
                                                 for t in picks[:keep, slot])
                            decode_tokens += keep
                    for slot in {s for _, st in pending for s, _ in st}:
                        req = sched.running.get(slot)
                        if req is not None:
                            decode_tokens -= apply_stop(req)
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
                    logits, pool = gpt2_paged.decode_step_paged(
                        self.params, torch.from_numpy(toks),
                        torch.from_numpy(wpe_pos), torch.from_numpy(pg),
                        torch.from_numpy(sl), torch.from_numpy(tables),
                        torch.from_numpy(lengths), pool, cfg,
                        use_kernel=self.use_kernel,
                        starts=torch.from_numpy(starts))
                    decode_steps += 1
                    decode_tokens += len(stepped_s)
                    t_m0 = time.monotonic()
                    rows = torch.tensor(stepped_s, device=dev)
                    row_toks = torch.argmax(logits[rows], dim=-1).cpu()
                    tacc["materialize"] += time.monotonic() - t_m0
                    for slot, tok in zip(stepped_s, row_toks.tolist()):
                        req = sched.running[slot]
                        req.generated.append(tok)
                        apply_stop(req)
                        if req.done:
                            mgr.free_prompt(slot)
                            finish_slot(slot)

            if not progressed and not sched.running:
                raise RuntimeError(
                    "scheduler stalled: pool too small for any waiting "
                    "request (need a larger page pool or shorter prompts)")

        self._pool_cache = pool
        dt = time.monotonic() - t_start
        self.stats = {
            "wall_s": dt,
            "decode_tokens": decode_tokens,
            "decode_steps": decode_steps,
            "decode_tok_per_s": decode_tokens / dt if dt > 0 else 0.0,
            "peak_pages_used": peak_pages,
            "preemptions": sched.preempt_count,
            "p50_ttft_s": float(np.median(ttfts)) if ttfts else 0.0,
            "t_prefill_dispatch_s": round(tacc["prefill_dispatch"], 4),
            "t_chain_dispatch_s": round(tacc["chain_dispatch"], 4),
            "t_materialize_s": round(tacc["materialize"], 4),
        }
        return sched.finished
