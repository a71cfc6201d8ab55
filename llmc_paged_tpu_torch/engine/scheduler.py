"""Continuous-batching scheduler (L4): a copy of
llmc_paged_tpu/engine/scheduler.py.

  * requests are admitted into decode slots while pages are available;
  * every decode step runs ALL running slots in one batched device step;
  * when the pool exhausts, the manager's whole-prompt LRU eviction
    preempts a sequence; the victim keeps its generated tokens and is
    requeued for recompute-style re-admission (its next prefill covers
    prompt + generated-so-far).

Request fields for options outside this slice of the port (streaming,
per-request sampling, logprobs, penalties) are kept so requests carry
over; the port's engine rejects a request that sets one.
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
    # streaming flag of the JAX package's serving front (a later slice)
    stream: bool = False
    # generation stops after the first of these token ids appears (the id
    # is kept as the last generated token); None -> EngineConfig default.
    # Decode chains overshoot past a stop and the engine discards the
    # excess at materialization.
    stop_tokens: Optional[List[int]] = None
    stopped: bool = False
    # per-request sampling overrides, logprobs and penalties: later slices
    # of the port (the engine raises NotImplementedError when one is set)
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    greedy: Optional[bool] = None
    # admission priority: higher admits sooner; FIFO within a class.
    # Preemption victims stay LRU (block manager policy).
    priority: int = 0
    logprobs: bool = False
    logprob_values: List[float] = dataclasses.field(default_factory=list)
    prompt_logprobs: bool = False
    prompt_logprob_values: List[float] = dataclasses.field(
        default_factory=list)
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    # a request cancelled before run() finishes at once, with no tokens
    cancelled: bool = False
    slot: Optional[int] = None
    preemptions: int = 0
    t_submit: float = 0.0
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None

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
