"""Configuration dataclasses: the port's own copies of the JAX package's
GPT2Config, PageConfig and EngineConfig (same fields, same defaults), so
that one EngineConfig describes the same deployment in both packages.

``mesh_shape`` (tensor parallelism, ``{"model": m}`` or ``{"data": d,
"model": m}``) runs the engine in each rank of a torch.distributed
group of d·m ranks (``parallel/sharding.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    """Model shape, as carried by the checkpoint header."""

    max_seq_len: int = 1024   # maxT — wpe rows
    vocab_size: int = 50257   # V
    num_layers: int = 12      # L
    num_heads: int = 12       # NH
    channels: int = 768       # C

    # A TPU tiling knob of the JAX package (wte rows padded to this
    # multiple). The port keeps the field so configurations carry over,
    # but never pads: logits are V wide either way.
    vocab_pad_multiple: int = 2048

    @property
    def head_dim(self) -> int:
        assert self.channels % self.num_heads == 0
        return self.channels // self.num_heads

    @property
    def padded_vocab_size(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @staticmethod
    def gpt2_124m() -> "GPT2Config":
        return GPT2Config(1024, 50257, 12, 12, 768)

    @staticmethod
    def gpt2_350m() -> "GPT2Config":
        return GPT2Config(1024, 50257, 24, 16, 1024)

    @staticmethod
    def gpt2_774m() -> "GPT2Config":
        return GPT2Config(1024, 50257, 36, 20, 1280)

    @staticmethod
    def gpt2_1558m() -> "GPT2Config":
        return GPT2Config(1024, 50257, 48, 25, 1600)

    @staticmethod
    def tiny(max_seq_len: int = 64, vocab_size: int = 256, num_layers: int = 2,
             num_heads: int = 4, channels: int = 32) -> "GPT2Config":
        """Small config for tests."""
        return GPT2Config(max_seq_len, vocab_size, num_layers, num_heads,
                          channels)


@dataclasses.dataclass(frozen=True)
class PageConfig:
    """KV page-pool geometry. ``page_size`` is tokens per page;
    ``num_pages`` the pool size; ``max_seqs`` bounds concurrent sequences;
    ``pages_per_seq`` caps one sequence's block table."""

    page_size: int = 32
    num_pages: int = 128
    max_seqs: int = 8
    pages_per_seq: int = 32
    kv_dtype: str = "float32"   # "float32" | "bfloat16" | "int8"
    prefix_cache: bool = False  # content-keyed sharing of full prompt pages

    @property
    def max_context(self) -> int:
        return self.page_size * self.pages_per_seq


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Top-level engine switches (field-for-field the JAX package's)."""

    cache_mode: str = "paged"          # "none" | "dense" | "paged"
    page: PageConfig = dataclasses.field(default_factory=PageConfig)
    param_dtype: str = "float32"       # "float32" | "bfloat16" | "int8"
    # compute dtype of the non-quantized leaves for param_dtype="int8"
    activation_dtype: str = "float32"
    # "bfloat16": a second, bf16 copy of the weights serves the prefill
    # while decode stays on the int8 weights
    prefill_param_dtype: Optional[str] = None
    max_batch: int = 8
    max_new_tokens: int = 64
    temperature: float = 1.0
    top_k: Optional[int] = None
    greedy: bool = False
    # sample on the DEVICE inside decode chunks (a torch.Generator seeded
    # with `seed`, top_k/temperature transform) instead of the host parity
    # sampler: a sampled batch chains, at the cost of the bit-exact
    # xorshift stream (which stays the default)
    device_sampling: bool = False
    decode_chunk: int = 16             # greedy tokens per device round trip
    spec_k: int = 0
    spec_ngram: int = 3
    # streaming (run(on_tokens=...)): while a request with stream=True
    # runs, chains materialize at least every N links
    stream_links: int = 4
    # allow Request.logprobs / prompt_logprobs (CLI --no-logprobs)
    serve_logprobs: bool = True
    # default stop ids for requests that set none (Request.stop_tokens)
    stop_tokens: tuple = ()
    seed: int = 1337
    mesh_shape: Optional[dict] = None
    # validate every device-bound index on the host before dispatch
    debug_checks: bool = False
    log_every: int = 0
