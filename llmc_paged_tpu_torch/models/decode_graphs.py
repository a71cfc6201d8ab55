"""CUDA graphs of the chained decode step (``gpt2_paged.decode_chunk_paged``).

In eager PyTorch a chained step is about 100 launches a layer (the
layernorms, the int8 linears, the chunk attention's tail and merge, the
GELU), and the host enqueues them slower than the card runs them. A
greedy chain on one card instead captures one step as a CUDA graph and
replays it K times a link, so a step costs the host one graph launch.

``DecodeGraphs`` is the cache an engine owns and hands to
``decode_chunk_paged``; the function decides by what the call can observe
whether it replays (``gpt2_paged.graph_eligible``). The cache holds:

  * the objects every graph reads (params, pool, config): a call over
    other objects drops every graph first, so no graph is keyed on an id
    or a data pointer that a free could hand to another tensor;
  * static buffers a (rows, table width): one set, sized to the longest
    chunk, shared by every graph of those rows (the in-flight f32 K/V
    tails are the bulk: 5 GB at GPT-2 XL, 256 rows, 32 steps);
  * the graphs, a (rows, table width, window, logprobs, steps) each, in
    one memory pool. At a key's first use every chunk length the owner
    can ask for is captured, after one eager warm-up step each on a side
    stream (cuBLAS's and the kernels' first-use set-up stays out of the
    capture), inside a ``model.capture`` span;
  * ``captures`` and ``steps``: graphs captured, chained steps replayed.

The kernel wrappers' launch counters (``LAUNCHES`` of ``ops/``) count
kernels the card runs for the engine's steps: a warm-up step and a
capture leave them as they were, and each replay adds what its capture
counted.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch

from llmc_paged_tpu_torch.ops import flash_attention, int8, paged_attention
from llmc_paged_tpu_torch.utils.spans import span

# the kernel wrappers' launch counters
_COUNTERS = (paged_attention.LAUNCHES, flash_attention.LAUNCHES,
             int8.LAUNCHES)


def _counts():
    return [dict(c) for c in _COUNTERS]


def _restore(saved) -> None:
    for c, s in zip(_COUNTERS, saved):
        c.update(s)


class DecodeGraphs:
    """Graphs of one chained decode step, replayed K times a link.
    ``chunks``: every chain length the owner can ask for; each is captured
    at a key's first use."""

    def __init__(self, chunks: Sequence[int] = ()):
        self.chunks = tuple(sorted({int(k) for k in chunks if k > 1}))
        self.captures = 0
        self.steps = 0
        self._owner: Tuple = ()
        self._buffers: Dict[Tuple, object] = {}
        self._graphs: Dict[Tuple, Tuple] = {}
        self._mempool = None

    def reset(self) -> None:
        """Drop every graph and buffer (and the objects they read)."""
        self._owner = ()
        self._buffers.clear()
        self._graphs.clear()

    def bind(self, *owner) -> None:
        """The graphs read ``owner`` (params, pool, config): objects other
        than the ones they were captured over drop them all. The objects
        are held, so their ids cannot be reused while graphs read them."""
        if len(owner) != len(self._owner) or any(
                a is not b for a, b in zip(owner, self._owner)):
            self.reset()
            self._owner = owner

    def buffers(self, key: Tuple, steps: int, make: Callable):
        """The static buffers of ``key`` for ``steps`` steps or more:
        ``make(n)`` builds them for n = the longest chunk length."""
        buf = self._buffers.get(key)
        if buf is None or buf.steps < steps:
            # graphs over the smaller buffers would read freed memory
            self._graphs = {k: g for k, g in self._graphs.items()
                            if k[:len(key)] != key}
            buf = self._buffers[key] = make(max((steps,) + self.chunks))
        return buf

    def graph(self, key: Tuple, steps: int, step: Callable[[int], None],
              restart: Callable[[], None], device,
              keep: Sequence[torch.Tensor] = ()):
        """The graph of ``key`` + (steps,). At its first use it captures
        it and every chunk length not captured for ``key``: ``step(k)``
        is one step of a k-step link and ``restart()`` resets the step
        index before each warm-up step. ``keep``: device tensors the
        step adds to (a counter) that its warm-up steps must leave as
        they were."""
        g = self._graphs.get(key + (steps,))
        if g is not None:
            return g
        with span("model.capture"), torch.cuda.device(device):
            saved = [t.clone() for t in keep]
            for k in sorted({steps, *self.chunks}, reverse=True):
                if key + (k,) not in self._graphs:
                    self._graphs[key + (k,)] = self._capture(
                        lambda k=k: step(k), restart)
            for t, s in zip(keep, saved):
                t.copy_(s)
        return self._graphs[key + (steps,)]

    def _capture(self, fn: Callable[[], None], restart: Callable[[], None]):
        saved = _counts()
        restart()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        if self._mempool is None:
            self._mempool = torch.cuda.graph_pool_handle()
        g = torch.cuda.CUDAGraph()
        before = _counts()
        # thread_local: a serving front's other threads may call CUDA
        with torch.cuda.graph(g, pool=self._mempool,
                              capture_error_mode="thread_local"):
            fn()
        launches = [{k: c[k] - b[k] for k in c if c[k] != b[k]}
                    for c, b in zip(_counts(), before)]
        _restore(saved)
        self.captures += 1
        return g, launches

    def replay(self, g, steps: int) -> None:
        """``steps`` replays of graph ``g``, each inside a ``model.step``
        span, each adding its capture's launches to the counters."""
        graph, launches = g
        for _ in range(steps):
            with span("model.step"):
                graph.replay()
                for c, d in zip(_COUNTERS, launches):
                    for k, n in d.items():
                        c[k] += n
        self.steps += steps
