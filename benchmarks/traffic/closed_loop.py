"""Closed-loop traffic: a fixed number of clients, each sending its next
request the moment its last one finishes, so the engine holds as many
requests as there are clients (the cell's concurrency).

The mix file gives the lengths:

    "prompt_len": [lo, hi], "output_len": [lo, hi]  (inclusive)
    "dist": "log_uniform"          (the only distribution so far)
    "max_total": n                 (prompt + output at most n)
    "prompt_logprobs": bool        (score the prompt)
    "block": n                     (requests a block, see below)
    "fixed_groups": bool           (see below; default false)

Every seed sends the SAME set of sizes in another order: the sizes of a
block are the distribution's quantiles at (i + 0.5) / block, prompt and
output lengths paired by one fixed permutation, and each block of
requests is that set shuffled by the run's seed; the token ids are
uniform over the vocabulary and drawn from the seed. So two seeds differ
in which sizes come when and in the tokens, never in the work a block
holds.

With ``fixed_groups`` the block is cut, once for every seed, into groups
of ``clients`` sizes (a fixed shuffle), and the seed shuffles the order
of the groups and the order within each. Where every client's request
finishes together (one token a request), a group is one admission wave,
so every seed runs the same waves in another order: which sizes share a
wave sets its padded length, and with it the wave's work.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np


def _quantiles(dist: str, lo: int, hi: int, n: int) -> np.ndarray:
    if dist != "log_uniform":
        raise ValueError(f"length distribution {dist!r}: only "
                         "'log_uniform' is defined")
    u = (np.arange(n) + 0.5) / n
    x = np.exp(math.log(lo) + u * (math.log(hi + 1) - math.log(lo)))
    return np.clip(np.floor(x), lo, hi).astype(np.int64)


def size_set(mix: dict) -> List[Tuple[int, int]]:
    """The block's (prompt, output) lengths, the same for every seed."""
    n = int(mix["block"])
    prompts = _quantiles(mix["dist"], *mix["prompt_len"], n)
    outputs = _quantiles(mix["dist"], *mix["output_len"], n)
    outputs = outputs[np.random.default_rng(0).permutation(n)]
    cap = int(mix["max_total"])
    return [(int(p), int(max(1, min(o, cap - p))))
            for p, o in zip(prompts, outputs)]


class Traffic:
    """Requests of a closed-loop mix of ``clients`` clients, in the order a
    run sends them: ``next()`` gives (prompt token ids, max_new_tokens,
    prompt_logprobs)."""

    def __init__(self, mix: dict, vocab_size: int, seed: int, clients: int):
        self.sizes = size_set(mix)
        self.vocab = int(vocab_size)
        self.prompt_logprobs = bool(mix.get("prompt_logprobs", False))
        self.rng = np.random.default_rng(seed)
        self.groups = None
        if mix.get("fixed_groups", False):
            n = len(self.sizes)
            if n % clients:
                raise ValueError(f"block {n} is not a multiple of the "
                                 f"{clients} clients")
            cut = np.random.default_rng(1).permutation(n)
            self.groups = cut.reshape(n // clients, clients)
        self.order: List[int] = []

    def _block(self) -> List[int]:
        if self.groups is None:
            return self.rng.permutation(len(self.sizes)).tolist()
        return [int(i) for g in self.rng.permutation(len(self.groups))
                for i in self.rng.permutation(self.groups[g])]

    def next(self) -> Tuple[List[int], int, bool]:
        if not self.order:
            self.order = self._block()[::-1]
        p, o = self.sizes[self.order.pop()]
        prompt = self.rng.integers(0, self.vocab, p).tolist()
        return prompt, o, self.prompt_logprobs
