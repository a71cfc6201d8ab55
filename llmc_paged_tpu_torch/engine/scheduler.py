"""Continuous-batching scheduler (L4): a copy of
llmc_paged_tpu/engine/scheduler.py.

  * requests are admitted into decode slots while pages are available;
  * every decode step runs ALL running slots in one batched device step;
  * when the pool exhausts, the manager's whole-prompt LRU eviction
    preempts a sequence; the victim keeps its generated tokens and is
    requeued for recompute-style re-admission (its next prefill covers
    prompt + generated-so-far).
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Dict, List, Optional


class State(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    DONE = "done"


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    generated: List[int] = dataclasses.field(default_factory=list)
    state: State = State.WAITING
    # streaming consumer attached (run(on_tokens=...)): decode chains cap
    # at EngineConfig.stream_links while this request runs
    stream: bool = False
    # generation stops after the first of these token ids appears (the id
    # is kept as the last generated token); None -> EngineConfig default.
    # Decode chains overshoot past a stop and the engine discards the
    # excess at materialization.
    stop_tokens: Optional[List[int]] = None
    stopped: bool = False
    # per-request sampling overrides, resolved against the engine sampler
    # (None: the sampler's own; temperature 0 means greedy)
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    greedy: Optional[bool] = None
    # admission priority: higher admits sooner; FIFO within a class.
    # Preemption victims stay LRU (block manager policy).
    priority: int = 0
    # when True, logprob_values[i] is generated[i]'s log-probability under
    # the model's RAW softmax (independent of temperature/top-k). Paged
    # serving only; not under spec_k.
    logprobs: bool = False
    logprob_values: List[float] = dataclasses.field(default_factory=list)
    # when True, prompt_logprob_values[i] is prompt[i+1]'s logprob given
    # prompt[:i+1], from the full-T logits of its first admission's
    # prefill. Paged only; not with prefix caching; the prompt must fit
    # the window.
    prompt_logprobs: bool = False
    prompt_logprob_values: List[float] = dataclasses.field(
        default_factory=list)
    # the pick is taken from logits - frequency_penalty*count
    # - presence_penalty*(count > 0), counts over the FULL context
    # (prompt + generated); logprob_values stay raw-softmax. Not under
    # spec_k.
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    # abort flag, settable from any thread: the engine notices at its next
    # host-side poll point (iteration top, or a chain's materialization),
    # frees the slot and pages, and finishes the request without further
    # tokens (ServingEngine.cancel resolves its future with
    # CancelledError)
    cancelled: bool = False
    slot: Optional[int] = None
    preemptions: int = 0
    t_submit: float = 0.0
    # the start of the request's first admission wave (every row of a wave
    # shares it): t_admit - t_submit is its wait in the queue
    t_admit: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None
    # summed over the request's admissions: the real tokens it prefilled,
    # and the padded length Tb of its prefill call (the call's (rows, Tb)
    # token slots over its rows)
    prefill_tokens: int = 0
    prefill_slots: float = 0.0

    @property
    def tokens(self) -> List[int]:
        return self.prompt + self.generated

    @property
    def ttft(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit

    def mark_first_token(self) -> None:
        if self.t_first_token is None:
            self.t_first_token = time.monotonic()

    @property
    def done(self) -> bool:
        return (self.cancelled or self.stopped
                or len(self.generated) >= self.max_new_tokens)


class Scheduler:
    """Slot/queue bookkeeping; page accounting is delegated to the block
    manager owned by the engine."""

    def __init__(self, max_batch: int):
        self.max_batch = max_batch
        self.waiting: List[Request] = []
        self.running: Dict[int, Request] = {}   # slot -> request
        self.finished: List[Request] = []
        # cumulative counter (preemptions of every request, ever): the
        # live-stats path must not scan per-request fields each iteration
        self.preempt_count = 0

    def submit(self, req: Request) -> None:
        # a serving front stamps arrival time at enqueue; don't overwrite
        # it (TTFT must include any time spent queued before admission)
        if not req.t_submit:
            req.t_submit = time.monotonic()
        self.waiting.append(req)

    def free_slots(self) -> List[int]:
        return [s for s in range(self.max_batch) if s not in self.running]

    def pop_next_waiting(self) -> Optional[Request]:
        """Earliest request of the highest waiting priority class (strict
        priority, FIFO within a class; a preempted request re-queued at
        the FRONT keeps seniority within its class)."""
        if not self.waiting:
            return None
        best = max(range(len(self.waiting)),
                   key=lambda i: (self.waiting[i].priority, -i))
        return self.waiting.pop(best)

    def admit(self, req: Request, slot: int) -> None:
        req.state = State.RUNNING
        req.slot = slot
        self.running[slot] = req

    def preempt(self, slot: int) -> Request:
        """Victim keeps its generated tokens and goes to the FRONT of the
        queue (it has seniority); re-admission re-prefills prompt+generated."""
        req = self.running.pop(slot)
        req.state = State.WAITING
        req.slot = None
        req.preemptions += 1
        self.preempt_count += 1
        self.waiting.insert(0, req)
        return req

    def finish(self, slot: int) -> Request:
        req = self.running.pop(slot)
        req.state = State.DONE
        req.slot = None
        req.t_done = time.monotonic()
        self.finished.append(req)
        return req

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)
