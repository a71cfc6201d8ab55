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
class RopeGroup:
    """The rotary embedding of one kind of layer: HF's ``rope_parameters``
    entry. ``rope_type`` "default" (inv_freq = theta^(-2i/d)) or "yarn"
    (``factor`` over ``original_max_position_embeddings``, ramp between
    ``beta_fast`` and ``beta_slow`` rotations, cos and sin scaled by
    ``attention_factor``, the ramp's ends floored/ceiled with
    ``truncate``)."""

    rope_type: str = "default"
    rope_theta: float = 10000.0
    factor: float = 1.0
    original_max_position_embeddings: int = 0
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    attention_factor: Optional[float] = None
    truncate: bool = True


SLIDING, FULL = "sliding_attention", "full_attention"


@dataclasses.dataclass(frozen=True)
class MellumConfig:
    """Mellum 2 (JetBrains' ``model_type`` "mellum"): RMSNorm pre-norm
    blocks of grouped-query attention (``num_kv_heads`` K/V heads shared
    by ``num_heads // num_kv_heads`` query heads, ``head_dim`` wide, no
    bias), each layer sliding (keys within ``sliding_window`` positions)
    or full by ``layer_types``, with a rope group a kind; every layer's
    MLP is a sparse mixture of ``num_experts`` SwiGLU experts of width
    ``expert_width``, ``top_k`` a token under a softmax router
    (renormalized with ``norm_topk_prob``); untied embedding and lm_head.
    A published model's numbers come from its config.json (``from_hf``;
    Mellum2-12B-A2.5B's is benchmarks/configs/mellum2-12b-a2.5b-bf16.json).
    """

    vocab_size: int
    num_layers: int
    channels: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    layer_types: tuple
    sliding_window: int
    rope_sliding: RopeGroup
    rope_full: RopeGroup
    num_experts: int
    top_k: int
    expert_width: int
    norm_topk_prob: bool
    rms_eps: float
    max_seq_len: int              # max_position_embeddings

    def __post_init__(self):
        if len(self.layer_types) != self.num_layers or \
                set(self.layer_types) - {SLIDING, FULL}:
            raise ValueError(f"layer_types: {self.num_layers} entries of "
                             f"{SLIDING!r} or {FULL!r}")
        if self.num_heads % self.num_kv_heads:
            raise ValueError("num_heads must be a multiple of num_kv_heads")

    @property
    def group(self) -> int:
        """Query heads a K/V head serves."""
        return self.num_heads // self.num_kv_heads

    def sliding(self, i: int) -> bool:
        return self.layer_types[i] == SLIDING

    @staticmethod
    def from_hf(d: dict) -> "MellumConfig":
        """From HF's config.json keys (JetBrains/Mellum2-*'s)."""
        def group(g):
            return RopeGroup(**{f.name: g[f.name]
                                for f in dataclasses.fields(RopeGroup)
                                if f.name in g})
        rp = d["rope_parameters"]
        return MellumConfig(
            vocab_size=d["vocab_size"], num_layers=d["num_hidden_layers"],
            channels=d["hidden_size"], num_heads=d["num_attention_heads"],
            num_kv_heads=d["num_key_value_heads"], head_dim=d["head_dim"],
            layer_types=tuple(d["layer_types"]),
            sliding_window=d["sliding_window"],
            rope_sliding=group(rp[SLIDING]), rope_full=group(rp[FULL]),
            num_experts=d["num_experts"], top_k=d["num_experts_per_tok"],
            expert_width=d["moe_intermediate_size"],
            norm_topk_prob=d["norm_topk_prob"], rms_eps=d["rms_norm_eps"],
            max_seq_len=d["max_position_embeddings"])

    @staticmethod
    def tiny(num_layers: int = 4, sliding_window: int = 16,
             original_max: int = 16, vocab_size: int = 256) -> "MellumConfig":
        """Small config for tests: 3 sliding layers a full one, 8 query
        and 2 K/V heads of 16, 8 experts of width 32, 2 a token, and a
        YaRN group whose original length the tests' contexts outgrow."""
        return MellumConfig(
            vocab_size=vocab_size, num_layers=num_layers, channels=64,
            num_heads=8, num_kv_heads=2, head_dim=16,
            layer_types=tuple(FULL if i % 4 == 3 else SLIDING
                              for i in range(num_layers)),
            sliding_window=sliding_window,
            rope_sliding=RopeGroup("default", 10000.0),
            rope_full=RopeGroup("yarn", 10000.0, 4.0, original_max, 32.0,
                                1.0, None),
            num_experts=8, top_k=2, expert_width=32, norm_topk_prob=True,
            rms_eps=1e-6, max_seq_len=4096)


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
