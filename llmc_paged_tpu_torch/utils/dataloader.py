"""Token-stream DataLoader (port of llmc_paged_tpu/utils/dataloader.py;
reference: DataLoader, train_gpt2.c:968-1033).

Streams (inputs, targets) = (B*T, shifted-by-one) int32 windows from a raw
token .bin, advancing by B*T per batch and wrapping when fewer than B*T+1
tokens remain — byte-identical batch sequence to the C loader. Batches are
numpy arrays on the host; the caller moves them to its device."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from llmc_paged_tpu_torch import formats


class DataLoader:
    def __init__(self, path: str, B: int, T: int):
        self.tokens = formats.read_token_stream(path)
        self.B, self.T = B, T
        if len(self.tokens) < B * T + 1:
            raise ValueError(
                f"token file too small: {len(self.tokens)} < {B * T + 1}")
        self.num_batches = len(self.tokens) // (B * T)
        self.pos = 0

    def reset(self) -> None:
        self.pos = 0

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        B, T = self.B, self.T
        if self.pos + B * T + 1 > len(self.tokens):
            self.pos = 0  # wraparound (train_gpt2.c:1020)
        chunk = self.tokens[self.pos: self.pos + B * T + 1]
        x = chunk[:-1].reshape(B, T).astype(np.int32)
        y = chunk[1:].reshape(B, T).astype(np.int32)
        self.pos += B * T
        return x, y
