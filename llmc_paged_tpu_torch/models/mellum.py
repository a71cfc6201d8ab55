"""L2: Mellum 2 as plain functions over a dict of tensors: the parameter
layout, RMSNorm, the two rotary groups (default and YaRN), the grouped
query/key/value projections and the sparse expert layer. The paged
forward that uses them is models/mellum_paged.py.

Parameters are stacked on a leading L axis, weights stored (OC, IC) as
in GPT-2's layout; the query, key and value projections are one matrix
(``wqkv``: the NH query heads, then the NKV key heads, then the NKV
value heads), and each layer's experts are stacked on an E axis
(``w_gate_up``: the gate rows, then the up rows).

The layer, as HF's Mellum / Qwen3-MoE code writes it:

    h  = x + wo(attn(rope(q), rope(k), v))       q, k, v from rms(x)
    x' = h + moe(rms(h))
    moe(y) = sum over the top_k experts e of w_e * down_e(silu(gate_e(y))
             * up_e(y)), w = softmax(router(y)) at the top_k, renormalized

RMSNorm normalizes in f32 and multiplies its weight in the weights'
dtype (HF's order); rope is applied in f32 and rounded back once. The
residual stream, the router's input and the logits are kept in f32 (the
products' inputs and outputs are in the weights' dtype): at bf16 a
rounding of the residual or of the router's input flips an expert choice
at a near-tie about once a token, and a bf16 logit near the top is
rounded by up to 2^-7 of its size.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from llmc_paged_tpu_torch import resolve_device
from llmc_paged_tpu_torch.config import MellumConfig, RopeGroup
from llmc_paged_tpu_torch.utils.spans import span

Params = Dict[str, torch.Tensor]

LAYER_KEYS = ("attn_norm", "wqkv", "wo", "mlp_norm", "router", "w_gate_up",
              "w_down")
NORM_KEYS = ("attn_norm", "mlp_norm", "final_norm")


def param_shapes(cfg: MellumConfig) -> Dict[str, tuple]:
    """Every parameter's shape, in the order weights are drawn."""
    L, C, V = cfg.num_layers, cfg.channels, cfg.vocab_size
    HD, NH, NKV = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    E, I = cfg.num_experts, cfg.expert_width
    return {"embed": (V, C),
            "attn_norm": (L, C),
            "wqkv": (L, (NH + 2 * NKV) * HD, C),
            "wo": (L, C, NH * HD),
            "mlp_norm": (L, C),
            "router": (L, E, C),
            "w_gate_up": (L, E, 2 * I, C),
            "w_down": (L, E, C, I),
            "final_norm": (C,),
            "lm_head": (V, C)}


def init_params(cfg: MellumConfig, generator: torch.Generator,
                dtype=torch.float32, device=None, std: float = 0.02
                ) -> Params:
    """Random weights: every matrix N(0, std) drawn from ``generator`` in
    ``param_shapes`` order, RMSNorm weights 1."""
    device = resolve_device(device)
    out: Params = {}
    for k, shp in param_shapes(cfg).items():
        if k in NORM_KEYS:
            t = torch.ones(shp)
        else:
            t = std * torch.randn(shp, generator=generator,
                                  device=generator.device)
        out[k] = t.to(device=device, dtype=dtype)
    return out


def prepare_params(params, cfg: MellumConfig, dtype: torch.dtype,
                   device) -> Params:
    """The serving copy on ``device`` in ``dtype``: a tensor already
    there in that dtype is kept as it is (no second copy of the weights
    is made); every shape is checked."""
    want = param_shapes(cfg)
    if set(params) != set(want):
        raise ValueError(f"Mellum params: want keys {sorted(want)}, got "
                         f"{sorted(params)}")
    out: Params = {}
    for k, v in params.items():
        t = torch.as_tensor(v)
        if tuple(t.shape) != want[k]:
            raise ValueError(f"{k}: shape {tuple(t.shape)}, want {want[k]}")
        out[k] = t.to(device=device, dtype=dtype)
    return out


def layer_stack(params: Params) -> Params:
    return {k: params[k] for k in LAYER_KEYS}


def layer(stack: Params, i: int) -> Params:
    return {k: w[i] for k, w in stack.items()}


# ---- rotary embedding -------------------------------------------------------

def _yarn_range(g: RopeGroup, dim: int):
    """HF's find_correction_range: the rotary dims whose wavelengths the
    original context holds more than beta_slow / fewer than beta_fast
    times (floored/ceiled with ``truncate``)."""
    def corr(rot):
        return (dim * math.log(g.original_max_position_embeddings
                               / (rot * 2 * math.pi))) / (
            2 * math.log(g.rope_theta))
    lo, hi = corr(g.beta_fast), corr(g.beta_slow)
    if g.truncate:
        lo, hi = math.floor(lo), math.ceil(hi)
    return max(lo, 0), min(hi, dim - 1)


def inv_freq(g: RopeGroup, dim: int):
    """(inv_freq (dim/2,) f32, the factor cos and sin are scaled by) of a
    rope group: HF's _compute_default_rope_parameters and
    _compute_yarn_parameters."""
    pos_freqs = g.rope_theta ** (torch.arange(0, dim, 2,
                                              dtype=torch.float32) / dim)
    if g.rope_type == "default":
        return 1.0 / pos_freqs, 1.0
    if g.rope_type != "yarn":
        raise ValueError(f"rope_type {g.rope_type!r}")
    extra, inter = 1.0 / pos_freqs, 1.0 / (g.factor * pos_freqs)
    lo, hi = _yarn_range(g, dim)
    if lo == hi:
        hi += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - lo)
                       / (hi - lo), 0, 1)
    keep = 1 - ramp                    # the extrapolated share a dim
    att = g.attention_factor
    if att is None:
        att = 0.1 * math.log(g.factor) + 1.0 if g.factor > 1 else 1.0
    return inter * (1 - keep) + extra * keep, float(att)


def rope_tables(cfg: MellumConfig, device):
    """{kind: (inv_freq on ``device``, scale)} for "sliding" and "full"."""
    return {kind: (f.to(device), s) for kind, (f, s) in (
        ("sliding", inv_freq(cfg.rope_sliding, cfg.head_dim)),
        ("full", inv_freq(cfg.rope_full, cfg.head_dim)))}


def cos_sin(table, pos: torch.Tensor):
    """cos and sin (pos.shape + (dim,)) f32 at integer positions ``pos``,
    each half repeated (HF's cat(freqs, freqs)) and scaled."""
    f, scale = table
    ang = pos.float()[..., None] * f
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang) * scale, torch.sin(ang) * scale


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """HF's rotate_half form on the heads x (..., H, dim), cos/sin
    (..., dim) broadcast over the heads; computed in f32, returned in
    x's dtype."""
    xf = x.float()
    h = xf.shape[-1] // 2
    rot = torch.cat([-xf[..., h:], xf[..., :h]], dim=-1)
    return (xf * cos[..., None, :] + rot * sin[..., None, :]).to(x.dtype)


# ---- the block's pieces -----------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float,
             dtype: torch.dtype = None) -> torch.Tensor:
    """x normalized in f32, rounded to ``dtype`` (default the weight's)
    and multiplied by the weight there."""
    dtype = dtype or w.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return w.to(dtype) * xf.to(dtype)


def qkv(x: torch.Tensor, lp: Params, cfg: MellumConfig):
    """(q (..., NH, HD), k (..., NKV, HD), v (..., NKV, HD)) of rms(x)."""
    h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
    y = F.linear(h, lp["wqkv"])
    NH, NKV, HD = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = y.split((NH * HD, NKV * HD, NKV * HD), dim=-1)
    lead = y.shape[:-1]
    return (q.reshape(*lead, NH, HD), k.reshape(*lead, NKV, HD),
            v.reshape(*lead, NKV, HD))


def grouped_linear(x: torch.Tensor, w: torch.Tensor,
                   offs: torch.Tensor) -> torch.Tensor:
    """Rows of x sorted by group (group e holds rows [offs[e-1], offs[e]))
    times their group's weight: x (N, IC), w (E, OC, IC) → (N, OC), by
    ``torch._grouped_mm``: on the card a CUTLASS grouped GEMM over the
    offsets on the device (bf16 only; no host sync, so it captures in a
    graph), on the CPU any float dtype."""
    return torch._grouped_mm(x, w.transpose(-2, -1), offs=offs)


def route(y: torch.Tensor, router: torch.Tensor, cfg: MellumConfig):
    """(weights (N, top_k) f32, experts (N, top_k)): the softmax of the
    f32 router logits at their top_k, renormalized with norm_topk_prob."""
    probs = torch.softmax(F.linear(y.float(), router.float()), dim=-1)
    w, idx = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.norm_topk_prob:
        w = w / w.sum(dim=-1, keepdim=True)
    return w, idx


def moe(y: torch.Tensor, lp: Params, cfg: MellumConfig,
        counts: torch.Tensor | None = None) -> torch.Tensor:
    """The sparse expert layer over tokens y (N, C) (already normalized;
    the router reads them in f32, the experts in their weights' dtype):
    the routed rows sorted by expert, two grouped products (gate and up
    together, then down), each token's top_k rows weighted and summed
    with f32 accumulation; returns (N, C) in the weights' dtype. Every
    step runs on the device without reading anything back. ``counts``
    (E,) int64: the routed rows an expert are added to it."""
    with span("model.moe"):
        N, C = y.shape
        E, K, I = cfg.num_experts, cfg.top_k, cfg.expert_width
        w, idx = route(y, lp["router"], cfg)
        flat = idx.reshape(-1)
        order = torch.sort(flat, stable=True).indices
        per = torch.zeros(E, dtype=torch.int64, device=y.device).scatter_add_(
            0, flat, torch.ones_like(flat))
        if counts is not None:
            counts.add_(per)
        offs = torch.cumsum(per, 0).int()
        dt = lp["w_gate_up"].dtype
        xs = y[order // K].to(dt)                           # (N*K, C)
        gu = grouped_linear(xs, lp["w_gate_up"], offs)      # (N*K, 2I)
        a = F.silu(gu[:, :I]) * gu[:, I:]
        out = grouped_linear(a, lp["w_down"], offs)         # (N*K, C)
        # each token's K rows back in routing order (a gather through the
        # inverse permutation), weighted and summed by one batched product
        # (f32 accumulation; the weights in the activations' dtype, HF's)
        inv = torch.empty_like(order)
        inv[order] = torch.arange(N * K, device=y.device)
        rows = out[inv].view(N, K, C)
        return torch.bmm(w.to(dt)[:, None, :], rows)[:, 0]


def linear_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w.T with an f32 result: on the card a bf16 product that writes
    its f32 accumulators (mm's ``out_dtype``), elsewhere in f32."""
    if x.is_cuda and x.dtype == torch.bfloat16 == w.dtype:
        return torch.mm(x.reshape(-1, x.shape[-1]), w.t(),
                        out_dtype=torch.float32).view(*x.shape[:-1],
                                                      w.shape[0])
    return F.linear(x.float(), w.float())


def logits(x: torch.Tensor, params: Params, cfg: MellumConfig):
    """f32 logits of the residual stream x."""
    return linear_f32(rms_norm(x, params["final_norm"], cfg.rms_eps),
                      params["lm_head"])
