"""Mellum 2 (``model_type`` "mellum"): all that the harness knows of this
family, the functions ``families/gpt2.py`` lists.

The config file holds HF's config.json keys (JetBrains/Mellum2-*);
every layer's MLP must be sparse, with no attention bias, SiLU experts
and an untied lm_head, which the program serves. The serving mode is the
config file's ``serving`` group: bf16 weights and activations (the
published dtype), one copy of the weights on the card, int8 KV pages.

``make_weights`` draws the weights in the served dtype straight away (a
bf16 copy from f32 draws made a slice at a time): the program takes them
as they are, so the card never holds a second copy, and the reference
reads the same copy after the window.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict

import torch

from benchmarks import roofline, weights
from benchmarks.reference import mellum_ref
from llmc_paged_tpu_torch.config import EngineConfig, MellumConfig, PageConfig
from llmc_paged_tpu_torch.models import mellum_paged

REFERENCE, CONTROL = mellum_ref.REFERENCE, mellum_ref.CONTROL

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# f32 elements a slice of the weight draw (1 GiB)
DRAW_SLICE = 1 << 28

# the int8 multi-query parts kernel at head_dim 128 (query tile 4, not
# normalized), the CUTLASS grouped GEMM of the expert products (not its
# data-preparation kernel), and the prompt's attention: the library's
# flash (causal) and memory-efficient (band mask) kernels
KERNELS = {"parts": r"parts_kernel<[^,]+, signed char, true, 128, \d+, \d+, "
                    r"false",
           "moe": r"^(?!.*prepare_grouped_gemm).*GroupProblemShape",
           "prompt_attn": r"fmha_cutlassF|pytorch_flash::flash_fwd"}


def program_config(cfg: dict) -> MellumConfig:
    want = {"attention_bias": False, "hidden_act": "silu",
            "tie_word_embeddings": False}
    bad = {k: cfg.get(k) for k, v in want.items() if cfg.get(k, v) != v}
    if bad or any(t != "sparse" for t in cfg.get("mlp_layer_types", [])):
        raise ValueError(f"the program serves Mellum with {want} and every "
                         f"MLP sparse; the config has {bad or cfg}")
    return MellumConfig.from_hf(cfg)


def engine_config(cfg: dict, concurrency: int) -> EngineConfig:
    s = cfg["serving"]
    page = PageConfig(page_size=s["page_size"],
                      num_pages=concurrency * s["pages_per_seq"]
                      + s["spare_pages"],
                      max_seqs=concurrency, pages_per_seq=s["pages_per_seq"],
                      kv_dtype=s["kv_dtype"])
    return EngineConfig(cache_mode="paged", page=page,
                        param_dtype=s["param_dtype"],
                        activation_dtype=s["activation_dtype"],
                        max_batch=concurrency, greedy=s["greedy"],
                        decode_chunk=s["decode_chunk"])


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of ``cfg`` from ``seed`` in the served dtype: every
    matrix N(0, initializer_range) from one generator on the device, in
    the program's parameter order, RMSNorm weights 1."""
    from llmc_paged_tpu_torch.models import mellum
    device = torch.device(device)
    dtype = _DTYPES[cfg["serving"]["param_dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(weights.seed64(seed))
    std = cfg["initializer_range"]
    out = {}
    for k, shp in mellum.param_shapes(program_config(cfg)).items():
        t = torch.empty(shp, dtype=dtype, device=device)
        if k in mellum.NORM_KEYS:
            t.fill_(1.0)
        else:
            flat = t.view(-1)
            for a in range(0, flat.numel(), DRAW_SLICE):
                b = min(a + DRAW_SLICE, flat.numel())
                flat[a:b] = torch.randn(b - a, generator=gen,
                                        device=device).mul_(std)
        out[k] = t
    return out


def served_model(params: Dict[str, torch.Tensor], cfg: dict,
                 precision: Dict[str, str]) -> mellum_ref.ServedModel:
    """The reference at ``precision``, its weights as served: bf16 weights
    are the served copy's values ("bf16"), f32 weights (a test's
    configuration) are kept whole."""
    s = cfg["serving"]
    if s["param_dtype"] == "float32":
        precision = {k: "float32" if v == "bf16" else v
                     for k, v in precision.items()}
    return mellum_ref.ServedModel(params, cfg, precision,
                                  s["activation_dtype"])


def _widths(cfg: dict):
    return SimpleNamespace(
        L=cfg["num_hidden_layers"], C=cfg["hidden_size"],
        V=cfg["vocab_size"], NH=cfg["num_attention_heads"],
        NKV=cfg["num_key_value_heads"], HD=cfg["head_dim"],
        E=cfg["num_experts"], K=cfg["num_experts_per_tok"],
        I=cfg["moe_intermediate_size"], W=cfg["sliding_window"],
        sliding=[t == "sliding_attention" for t in cfg["layer_types"]])


def linear_flops(cfg: dict) -> float:
    """One token through every layer's active weights: q/k/v and o, the
    router, its top_k experts' gate, up and down; two operations a
    multiply-add."""
    w = _widths(cfg)
    per_layer = ((w.NH + 2 * w.NKV) * w.HD * w.C + w.C * w.NH * w.HD
                 + w.E * w.C + w.K * 3 * w.I * w.C)
    return 2.0 * w.L * per_layer


def attention_flops(cfg: dict, ctx: int) -> float:
    """One query over ``ctx`` keys in every layer, a sliding layer's over
    min(ctx, W): QK and PV, 4 * keys * NH * HD a layer."""
    w = _widths(cfg)
    keys = sum(min(ctx, w.W) if s else ctx for s in w.sliding)
    return 4.0 * keys * w.NH * w.HD


def prefill_attention_flops(cfg: dict, n: int) -> float:
    """A causal prompt of n tokens: query t attends t + 1 keys, or
    min(t + 1, W) on a sliding layer."""
    w = _widths(cfg)
    full = n * (n + 1) / 2
    m = min(n, w.W)
    slid = m * (m + 1) / 2 + (n - m) * w.W
    keys = sum(slid if s else full for s in w.sliding)
    return 4.0 * keys * w.NH * w.HD


def flops(cfg: dict) -> SimpleNamespace:
    """``prefill(n, lm_rows)``: a prompt of ``n`` real tokens with
    ``lm_rows`` rows of the lm_head; ``decode(ctx)``: one token over
    ``ctx`` keys (itself included), with its lm_head row. Active FLOPs:
    the experts a token is routed to, not all of them. (The harness calls
    ``decode`` once a served token on the engine's thread, so the widths
    are read once here.)"""
    w = _widths(cfg)
    lin, head = linear_flops(cfg), 2.0 * w.C * w.V
    n_slide = sum(w.sliding)
    n_full = w.L - n_slide
    qk = 4.0 * w.NH * w.HD

    def decode(ctx):
        return lin + qk * (n_slide * min(ctx, w.W) + n_full * ctx) + head

    return SimpleNamespace(
        prefill=lambda n, lm_rows: (n * lin + prefill_attention_flops(cfg, n)
                                    + lm_rows * head),
        decode=decode)


def kv_bytes_per_token(cfg: dict) -> float:
    """One token's K and V in one layer of the int8 pool: NKV heads of
    head_dim bytes each, and an f32 scale a head for each."""
    w = _widths(cfg)
    return w.NKV * (2.0 * w.HD + 2 * 4)


def parts_step_bytes(cfg: dict, lengths, steps: int, chained: bool) -> float:
    """The K/V bytes and scales the parts calls of ``steps`` decode steps
    read, summed over the layers: a row's live [start, len) in each (a
    chained step j reads its committed length n from max(0, n + j + 1 -
    W) on a sliding layer; a single step its n tokens from max(0, n - W)),
    at one read of each byte."""
    w = _widths(cfg)
    tokens = 0
    for n in lengths:
        for j in range(steps):
            live_s = min(n, w.W - 1 - j) if chained else min(n, w.W)
            tokens += sum(live_s if s else n for s in w.sliding)
    return tokens * kv_bytes_per_token(cfg)


def moe_layer_bound_s(cfg: dict, rows: int) -> float:
    """The least time of one layer's two grouped products over ``rows``
    routed rows: for each, all E experts' bf16 weights and the rows in
    and out at the HBM peak, or 2 * rows * in * out at the bf16 peak,
    whichever is larger."""
    w = _widths(cfg)
    total = 0.0
    for fan_in, fan_out in ((w.C, 2 * w.I), (w.I, w.C)):
        nbytes = 2.0 * (w.E * fan_in * fan_out + rows * (fan_in + fan_out))
        total += max(nbytes / roofline.PEAK_HBM_BYTES,
                     2.0 * rows * fan_in * fan_out / roofline.PEAK_BF16_FLOPS)
    return total


def _moe_calls(r: dict):
    """(grouped products a record's span launches, the sum of their
    bounds): two a layer, a step of a chain or a group of a prefill."""
    if r["kind"] == "prefill":
        batches = [sum(r["lengths"][i] for i in g)
                   for g in mellum_paged.prefill_groups(r["lengths"])]
    else:
        batches = [r["B"]] * r.get("steps", 1)
    return batches


def prompt_attn_calls(cfg: dict, T: int) -> int:
    """Attention calls of a prefill group padded to T tokens: one a full
    layer (causal), ceil(T / W) a sliding one (causal up to W, then a
    banded call a block of W queries)."""
    w = _widths(cfg)
    n_slide = sum(w.sliding)
    return w.L - n_slide + n_slide * -(-T // w.W)


def kernels(cfg: dict) -> Dict[str, tuple]:
    """The parts, expert and prompt-attention kernels: each call's bound
    (the span's bound over the calls it should launch) and the calls
    expected, L a step for the parts kernel, 2 L a step (or a prefill
    group) for the grouped products, ``prompt_attn_calls`` a prefill
    group for the prompt's attention, whose bound is the real rows'
    attention FLOPs (``prefill_attention_flops``) at the bf16 peak."""
    w = _widths(cfg)

    def parts_expected(r):
        return 0 if r["kind"] == "prefill" else w.L * r.get("steps", 1)

    def parts_bound(r):
        n = parts_expected(r)
        if not n:
            return 0.0
        return parts_step_bytes(cfg, r["lengths"], r.get("steps", 1),
                                r["kind"] == "chunk") \
            / roofline.PEAK_HBM_BYTES / n

    def moe_expected(r):
        return 2 * w.L * len(_moe_calls(r))

    def moe_bound(r):
        batches = _moe_calls(r)
        if not batches:
            return 0.0
        total = w.L * sum(moe_layer_bound_s(cfg, w.K * b) for b in batches)
        return total / moe_expected(r)

    def attn_expected(r):
        if r["kind"] != "prefill":
            return 0
        return sum(prompt_attn_calls(cfg, max(r["lengths"][i] for i in g))
                   for g in mellum_paged.prefill_groups(r["lengths"]))

    def attn_bound(r):
        n = attn_expected(r)
        if not n:
            return 0.0
        return sum(prefill_attention_flops(cfg, m) for m in r["lengths"]) \
            / roofline.PEAK_BF16_FLOPS / n

    return {"parts": (KERNELS["parts"], parts_bound, parts_expected),
            "moe": (KERNELS["moe"], moe_bound, moe_expected),
            "prompt_attn": (KERNELS["prompt_attn"], attn_bound,
                            attn_expected)}


def span_targets() -> list:
    """The family's three device entries (``models/mellum_paged``):

    * ``prefill``: a padded admission wave: its rows, padded length and
      each row's real length (tokens whose pool page is a real page);
    * ``chunk``: one link of a decode chain: its steps and each live
      row's committed length;
    * ``step``: a single-token step: each live row's length.
    """
    return [(mellum_paged, "prefill_paged", "prefill", _describe_prefill),
            (mellum_paged, "decode_chunk_paged", "chunk", _describe_chunk),
            (mellum_paged, "decode_step_paged", "step", _describe_step)]


def _host(t) -> torch.Tensor:
    return torch.as_tensor(t).cpu()


def _describe_prefill(params, tokens, page, slot, pool, cfg, last_pos=None,
                      **kw):
    pg = _host(page)
    B, T = pg.shape
    return {"B": int(B), "T": int(T),
            "lengths": [int(n) for n in (pg < pool.num_pages).sum(
                dim=1).tolist()],
            "all_rows": last_pos is None}


def _describe_chunk(params, first_tokens, positions0, *args, num_steps=1,
                    **kw):
    pos0 = _host(positions0)
    return {"B": int(pos0.shape[0]), "steps": int(num_steps),
            "lengths": [int(n) for n in pos0.tolist() if n >= 0]}


def _describe_step(params, tokens, positions, page, slot, block_tables,
                   lengths, *args, **kw):
    ln = _host(lengths)
    return {"B": int(ln.shape[0]), "steps": 1,
            "lengths": [int(n) for n in ln.tolist() if n > 0]}

