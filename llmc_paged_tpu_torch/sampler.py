"""Host-side sampling with bit-exact parity to the reference RNG (a copy
of llmc_paged_tpu/sampler.py: numpy only, the same integer recurrence and
float32 arithmetic, so the two packages draw the same tokens from the
same rows).

The reference samples on the host from the full-vocab softmax using an
xorshift64* generator (random_u32/random_f32, train_gpt2.c:1041-1050) and a
linear CDF walk (sample_mult, train_gpt2.c:1052-1063), seed 1337
(paged_infer.c:975). Generated token streams can therefore be compared
token-for-token against the C binaries given identical probabilities.

This must stay host-side Python (not a device generator): parity is
defined by this exact integer recurrence.
"""

from __future__ import annotations

import numpy as np

_MASK64 = (1 << 64) - 1


class XorshiftRNG:
    """xorshift64* — matches random_u32 (train_gpt2.c:1041-1047) exactly."""

    def __init__(self, seed: int = 1337):
        self.state = seed & _MASK64
        assert self.state != 0, "xorshift state must be nonzero"

    def random_u32(self) -> int:
        s = self.state
        s ^= s >> 12
        s ^= (s << 25) & _MASK64
        s ^= s >> 27
        self.state = s
        return ((s * 0x2545F4914F6CDD1D) & _MASK64) >> 32

    def random_f32(self) -> float:
        # (u32 >> 8) / 2^24, float32-rounded like the C expression
        return float(np.float32(self.random_u32() >> 8) / np.float32(16777216.0))


def sample_mult(probabilities: np.ndarray, coin: float) -> int:
    """CDF sampling with float32 accumulation order identical to
    sample_mult (train_gpt2.c:1052-1063)."""
    probs = np.asarray(probabilities, dtype=np.float32)
    cdf = np.cumsum(probs, dtype=np.float32)
    hits = cdf > np.float32(coin)
    if not hits.any():
        return probs.shape[0] - 1  # rounding-error fallback, as in C
    return int(np.argmax(hits))


def sample_argmax(probabilities: np.ndarray) -> int:
    """Greedy decode (cached_infer.c generate_tokens_from_logits :894-908
    takes the max-probability token)."""
    return int(np.argmax(probabilities))


def topk_probs(logits: np.ndarray, top_k: int | None = None,
               temperature: float = 1.0) -> np.ndarray:
    """Temperature + top-k filtered softmax over a (V,) logits row — the
    PyTorch reference's sampling transform (GPT.generate,
    train_gpt2.py:197-222: logits / temperature, logits < kth-largest →
    -inf, softmax). Ties at the k-th value are all kept, matching
    torch.topk's `logits < v[:, [-1]]` masking."""
    logits = np.asarray(logits, dtype=np.float32)
    if temperature != 1.0:
        logits = logits / np.float32(temperature)
    if top_k is not None and 0 < top_k < logits.shape[-1]:
        kth = np.partition(logits, -top_k)[-top_k]
        logits = np.where(logits < kth, -np.inf, logits)
    x = logits - logits.max()
    p = np.exp(x, dtype=np.float32)
    return p / p.sum(dtype=np.float32)


def reconstruct_topk_row(values: np.ndarray, indices: np.ndarray,
                         vocab_size: int) -> np.ndarray:
    """Rebuild a full (V,) logits row from a device-shipped top-k prefix,
    -inf elsewhere. For top-k sampling the host transform (topk_probs +
    sample_mult) sees bit-identical fp32 inputs at identical positions —
    masked entries exp to exactly 0.0 either way — so the sampled token
    (and the xorshift stream) is bit-equal to shipping the whole row,
    at ~k/V of the transfer."""
    row = np.full(vocab_size, -np.inf, np.float32)
    row[np.asarray(indices)] = np.asarray(values, np.float32)
    return row


class Sampler:
    """Per-engine sampler state. One shared RNG stream across the decode
    loop, exactly like the single `rng_state` local in the reference mains.

    ``top_k`` / ``temperature`` add the PyTorch reference's sampling
    transform (train_gpt2.py:197-222) in front of the C CDF walk; both
    default to the C binaries' behavior (full vocab, T=1)."""

    def __init__(self, seed: int = 1337, greedy: bool = False,
                 top_k: int | None = None, temperature: float = 1.0):
        self.rng = XorshiftRNG(seed)
        if temperature == 0:
            # the common "temperature 0 = deterministic" idiom; dividing
            # logits by zero would NaN the softmax and silently emit the
            # CDF-fallback token (V-1) forever
            greedy, temperature = True, 1.0
        if temperature < 0:
            # a negative temperature inverts the logit ordering after
            # scaling, which would silently break the engine's top-k
            # prefix-ship boundary-tie test (engine._sample_rows_topk
            # assumes kth-largest on RAW logits stays kth after scaling)
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if top_k is not None and top_k < 1:
            # top_k=0/-1 would slip through truthiness dispatches and
            # sample a silently truncated distribution (the top-k prefix
            # ship keeps ~top_k+16 entries and applies no filter)
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        self.greedy = greedy
        self.top_k = top_k
        self.temperature = temperature

    @property
    def transforms_logits(self) -> bool:
        return self.top_k is not None or self.temperature != 1.0

    def sample(self, probabilities: np.ndarray) -> int:
        if self.greedy:
            return sample_argmax(probabilities)
        coin = self.rng.random_f32()
        return sample_mult(probabilities, coin)

    def sample_logits(self, logits: np.ndarray) -> int:
        """Sample from a raw (V,) logits row, applying temperature/top-k."""
        if self.greedy:
            return int(np.argmax(logits))
        return self.sample(topk_probs(logits, self.top_k, self.temperature))
