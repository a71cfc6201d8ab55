"""Asynchronous continuous-serving front over InferenceEngine (port of
llmc_paged_tpu/engine/server.py).

The reference (and InferenceEngine.run with a fixed list) batches a KNOWN
set of requests; a serving deployment receives requests over time.
ServingEngine owns a background thread running ONE long-lived
engine.run() whose `feed` drains a thread-safe queue every scheduler
iteration — an arriving request joins the running batch at the next
admission wave (sharing its prefill wave, page pool, and decode chunks
with in-flight sequences) instead of waiting for a batch boundary.

The device never idles between "batches": chunk chains keep running
while new prompts queue, and admission waves prefill whatever has
arrived by the time a slot frees. All serving features compose (chunked
decode, device sampling, spec_k, prefix caching, int8).

Threads: client threads touch only Python objects (requests, futures,
queues); every CUDA tensor lives on the serving thread, which makes the
engine's device current before its first launch (a new thread's current
device is index 0).

Tensor parallelism (an engine with EngineConfig.mesh_shape): each rank
of a model group runs its own engine loop (parallel/sharding.py) and
must take every host decision as the others do, or the next collective
hangs; a serving loop takes its decisions from client threads, which
exist on the group's leader (``mesh.leader``, model rank 0) only. So a
ServingEngine is built on every rank of the mesh, in the same order on
each (the ranks' fronts pair up by order on ``mesh.host_group``).
Clients submit, stream and cancel on the leader; there ``cancel`` only
records the rid. The leader's feed drains its queue and broadcasts one
message over the host group: the new requests as plain fields
(``WIRE_FIELDS``), the rids cancelled since the last poll, and whether
the feed is still open (it stays open while requests live, so a cancel
during close's drain still reaches every rank). Every rank's feed, the
leader's included, builds or keeps its requests and sets ``cancelled``
on its own request objects inside the feed call, so the engine's checks
right after each poll see the same flags on every rank. Invariant: ONE
broadcast for each feed call, on every rank. On a follower, submit,
submit_stream and cancel raise, naming the leader; ``close()`` waits for
the loop, which ends when the leader's message says closed.

Usage:
    srv = ServingEngine(engine)           # spawns the serving thread
    fut = srv.submit([1, 2, 3], max_new_tokens=32)   # any thread
    tokens = fut.result()                 # prompt + generated
    srv.close()                           # drain + join

No reference analogue (its mains decode a fixed prompt set); this is the
L4 capability a production deployment needs on top of them.
"""

from __future__ import annotations

import collections
import itertools
import queue
import threading
import time
from concurrent.futures import CancelledError, Future
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from llmc_paged_tpu_torch.engine.scheduler import Request
from llmc_paged_tpu_torch.sampler import Sampler

# how long the feed blocks waiting for work when the engine is idle; a
# wake also happens immediately on close()
_IDLE_POLL_S = 0.02

# the Request fields the engine reads, sent from a leader to its
# followers (t_submit stays on the leader's clock)
WIRE_FIELDS = ("rid", "prompt", "max_new_tokens", "stream", "stop_tokens",
               "temperature", "top_k", "greedy", "priority", "logprobs",
               "prompt_logprobs", "frequency_penalty", "presence_penalty",
               "cancelled")


class QueueFull(RuntimeError):
    """Raised by submit/submit_stream when max_pending live requests are
    already in flight — backpressure instead of unbounded queueing (the
    HTTP front maps this to 503 + Retry-After)."""


class StreamHandle:
    """Iterator over token batches plus a cancellation handle: abandoning
    the stream should not leave the request decoding to max_new_tokens —
    call .cancel() (the HTTP front does so on client disconnect)."""

    def __init__(self, serving: "ServingEngine", rid: int, q: "queue.Queue"):
        self.rid = rid
        self._serving = serving
        self._q = q

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is ServingEngine._DONE:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item

    def cancel(self) -> bool:
        return self._serving.cancel(self.rid)


class ServingEngine:
    _DONE = object()    # stream-queue terminal sentinel

    def __init__(self, engine, window: Optional[int] = None,
                 sampler: Optional[Sampler] = None,
                 max_pending: Optional[int] = None):
        self._engine = engine
        # the device the engine runs on, with its index: a bare "cuda" is
        # the current card of the thread that builds the front
        dev = engine.device
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self._device = dev
        # under TP: the mesh, and the rids cancelled since the last poll
        self._mesh = getattr(engine, "mesh", None)
        self.is_leader = self._mesh is None or self._mesh.model_rank == 0
        self._cancels: List[int] = []
        self.broadcasts = 0                # the feed's broadcasts so far
        self._bcast_ms: "collections.deque" = collections.deque(
            maxlen=4096)                   # host ms of the latest ones
        self._window = window
        self._sampler = sampler
        self._max_pending = max_pending
        self._q: "queue.Queue[Optional[Request]]" = queue.Queue()
        self._futures = {}
        self._streams = {}                 # rid -> token-batch queue
        self._requests = {}                # rid -> live Request (for cancel)
        self._lock = threading.Lock()
        self._open = True
        self._rid = itertools.count()
        self._error: Optional[BaseException] = None
        # set when the loop has ended: close() waits on it, not on
        # Thread.join, which a KeyboardInterrupt leaves marking a running
        # thread as stopped
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="llmc-serving", daemon=True)
        self._thread.start()

    # ---- client side (any thread) --------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               rid: Optional[int] = None,
               stop_tokens: Optional[Sequence[int]] = None,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               greedy: Optional[bool] = None,
               priority: int = 0, logprobs: bool = False,
               prompt_logprobs: bool = False,
               frequency_penalty: float = 0.0,
               presence_penalty: float = 0.0) -> Future:
        """Enqueue a request; returns a Future resolving to the full token
        list (prompt + generated). Invalid requests (too long for the
        pool / incompatible with the serving mode) fail their OWN future
        here, at submission, never the serving loop. temperature/top_k/
        greedy override the engine sampler for THIS request (None keeps
        the engine default)."""
        self._check_leader("submit")
        with self._lock:
            if not self._open:
                raise RuntimeError("ServingEngine is closed")
            if self._error is not None:
                raise RuntimeError("serving loop died") from self._error
            if self._max_pending is not None and \
                    len(self._requests) >= self._max_pending:
                raise QueueFull(f"{len(self._requests)} live requests "
                                f">= max_pending {self._max_pending}")
            req = Request(rid=next(self._rid) if rid is None else rid,
                          prompt=list(prompt),
                          max_new_tokens=max_new_tokens,
                          stop_tokens=(None if stop_tokens is None
                                       else list(stop_tokens)),
                          temperature=temperature, top_k=top_k,
                          greedy=greedy, priority=priority,
                          logprobs=logprobs,
                          prompt_logprobs=prompt_logprobs,
                          frequency_penalty=frequency_penalty,
                          presence_penalty=presence_penalty)
            fut: Future = Future()
            fut.rid = req.rid                  # handle for cancel(rid)
            fut.request = req   # carries logprob_values after completion
            try:
                self._engine.validate_request(req, self._window)
            except ValueError as e:
                fut.set_exception(e)
                return fut
            req.t_submit = time.monotonic()    # TTFT includes queue time
            self._futures[req.rid] = fut
            self._requests[req.rid] = req
            # enqueue INSIDE the lock: close() flips _open under the same
            # lock, so a request admitted here is in the queue before the
            # feed can observe closed+empty and exit (put never blocks —
            # the queue is unbounded)
            self._q.put(req)
        return fut

    def submit_stream(self, prompt: Sequence[int], max_new_tokens: int,
                      rid: Optional[int] = None,
                      stop_tokens: Optional[Sequence[int]] = None,
                      temperature: Optional[float] = None,
                      top_k: Optional[int] = None,
                      greedy: Optional[bool] = None,
                      priority: int = 0, logprobs: bool = False,
                      prompt_logprobs: bool = False,
                      frequency_penalty: float = 0.0,
                      presence_penalty: float = 0.0):
        """Streaming twin of submit(): returns an iterator yielding token
        BATCHES (lists) as the engine materializes them — granularity is
        decode-chain links, bounded by EngineConfig.stream_links while any
        stream runs. Invalid requests raise here, synchronously."""
        self._check_leader("submit_stream")
        with self._lock:
            if not self._open:
                raise RuntimeError("ServingEngine is closed")
            if self._error is not None:
                raise RuntimeError("serving loop died") from self._error
            if self._max_pending is not None and \
                    len(self._requests) >= self._max_pending:
                raise QueueFull(f"{len(self._requests)} live requests "
                                f">= max_pending {self._max_pending}")
            req = Request(rid=next(self._rid) if rid is None else rid,
                          prompt=list(prompt),
                          max_new_tokens=max_new_tokens, stream=True,
                          stop_tokens=(None if stop_tokens is None
                                       else list(stop_tokens)),
                          temperature=temperature, top_k=top_k,
                          greedy=greedy, priority=priority,
                          logprobs=logprobs,
                          prompt_logprobs=prompt_logprobs,
                          frequency_penalty=frequency_penalty,
                          presence_penalty=presence_penalty)
            self._engine.validate_request(req, self._window)
            req.t_submit = time.monotonic()
            q: "queue.Queue" = queue.Queue()
            self._streams[req.rid] = q
            self._requests[req.rid] = req
            self._q.put(req)       # inside the lock — see submit()
        handle = StreamHandle(self, req.rid, q)
        handle.request = req    # carries logprob_values after completion
        return handle

    def cancel(self, rid: int) -> bool:
        """Abort a live request from any thread. The engine notices at its
        next host-side poll point (iteration top, or the current chain's
        materialization), frees the slot and pages, and finishes the
        request: its Future raises CancelledError; its stream ends (tokens
        already streamed stay delivered). Returns False when the request
        already finished (its result stands) or is unknown. Racing a
        natural finish is benign — one of the two outcomes lands. Under
        TP the rid is recorded and every rank sets the flag at the next
        poll (module docstring)."""
        self._check_leader("cancel")
        with self._lock:
            req = self._requests.get(rid)
            if req is None:
                return False
            if self._mesh is None:
                req.cancelled = True
            else:
                self._cancels.append(rid)
        return True

    def cancel_all(self) -> int:
        """Cancel every live request (a server that stops); returns how
        many."""
        with self._lock:
            rids = list(self._requests)
        return sum(self.cancel(rid) for rid in rids)

    def _check_leader(self, what: str) -> None:
        if not self.is_leader:
            raise RuntimeError(
                f"{what} on rank {self._mesh.rank}: this ServingEngine "
                f"follows rank {self._mesh.leader}, the leader of its "
                "model group, which alone takes requests")

    def stats(self) -> dict:
        """Live serving snapshot: the engine's per-iteration counters
        (running/waiting/finished, decode tok/s, pages free, preemptions,
        uptime) plus this front's pending request count. Safe from any
        thread — the engine swaps the whole dict atomically. Under TP
        also the feed's broadcasts and the median host ms of the latest
        4096."""
        out = dict(self._engine.live_stats)
        with self._lock:
            out["pending_futures"] = len(self._futures)
            out["open_streams"] = len(self._streams)
            if self._mesh is not None:
                out["broadcasts"] = self.broadcasts
                out["broadcast_ms_p50"] = (float(np.median(self._bcast_ms))
                                           if self._bcast_ms else 0.0)
        return out

    def close(self, wait: bool = True) -> None:
        """Stop accepting requests; the loop drains everything already
        submitted, then exits. On a follower: wait for the loop, which
        ends when the leader closes."""
        with self._lock:
            first, self._open = self._open, False
        if first and self.is_leader:
            self._q.put(None)                  # wake an idle feed
        if wait and (first or not self.is_leader):
            self._done.wait()
            self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- engine side (serving thread) -----------------------------------

    def _drain(self, block: bool) -> List[Request]:
        out: List[Request] = []
        try:
            while True:
                item = self._q.get(block=block and not out,
                                   timeout=_IDLE_POLL_S)
                if item is not None:
                    out.append(item)
                block = False                  # drain the rest non-blocking
        except queue.Empty:
            pass
        return out

    def _feed(self, block: bool):
        if self._mesh is None:
            out = self._drain(block)
            with self._lock:
                still_open = self._open or not self._q.empty() or bool(out)
            return out, still_open
        box = [None]
        if self.is_leader:
            out = self._drain(block)
            # submit and cancel hold the lock, so every rid cancelled by
            # now names a request in this drain or an earlier one
            with self._lock:
                out += self._drain(False)
                cancels, self._cancels = self._cancels, []
                still_open = self._open or bool(self._requests)
            box[0] = ([{k: getattr(r, k) for k in WIRE_FIELDS}
                       for r in out], cancels, still_open)
        t0 = time.perf_counter()
        dist.broadcast_object_list(box, src=self._mesh.leader,
                                   group=self._mesh.host_group)
        ms = 1e3 * (time.perf_counter() - t0)
        fields, cancels, still_open = box[0]
        if not self.is_leader:
            out = [Request(**f) for f in fields]
        with self._lock:
            self.broadcasts += 1
            self._bcast_ms.append(ms)
            for r in out:
                self._requests[r.rid] = r
            for rid in cancels:
                req = self._requests.get(rid)
                if req is not None:
                    req.cancelled = True
        return out, still_open

    def _on_tokens(self, req: Request, new_tokens) -> None:
        sq = self._streams.get(req.rid)
        if sq is not None:
            sq.put(list(new_tokens))

    def _on_finish(self, req: Request) -> None:
        with self._lock:
            self._requests.pop(req.rid, None)
        fut = self._futures.pop(req.rid, None)
        if fut is not None:
            if req.cancelled:
                fut.set_exception(CancelledError())
            else:
                fut.set_result(req.tokens)
        sq = self._streams.pop(req.rid, None)
        if sq is not None:
            sq.put(self._DONE)

    def _loop(self) -> None:
        try:
            if self._device.type == "cuda":
                torch.cuda.set_device(self._device)
            self._engine.run([], window=self._window, sampler=self._sampler,
                             feed=self._feed, on_finish=self._on_finish,
                             on_tokens=self._on_tokens)
        except BaseException as e:     # fail every pending future/stream
            with self._lock:
                self._error = e
                self._open = False
                pending = list(self._futures.values())
                self._futures.clear()
                streams = list(self._streams.values())
                self._streams.clear()
                self._requests.clear()
            for fut in pending:
                fut.set_exception(e)
            for sq in streams:
                sq.put(e)
        finally:
            self._done.set()
