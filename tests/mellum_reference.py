"""The plain reference of Mellum 2: its whole forward pass in f32 plain
PyTorch, with no cache, no kernels and no batching, written from the
published description (HF's Mellum / Qwen3-MoE modelling code and
JetBrains/Mellum2-12B-A2.5B-Instruct's config.json). It imports torch
only, and sets TF32 off for the products.

The configuration is HF's config.json keys (``hidden_size``,
``layer_types``, ``rope_parameters``, ...), the weights the program's
names and layout (models/mellum.py: stacked on L, (OC, IC)).

The layer:

    h  = x + o(attn(rms(x)))
    x' = h + moe(rms(h))

* RMSNorm: x * rsqrt(mean(x^2) + eps) * w.
* q, k, v = rms(x) @ wqkv (no bias), NH query heads and NKV key/value
  heads of head_dim; query head h reads K/V head h // (NH / NKV).
* RoPE in HF's rotate_half form on q and k: default inv_freq on sliding
  layers; YaRN's on full layers, with cos and sin multiplied by
  attention_factor (so the scores carry its square).
* Scores q.k / sqrt(head_dim), causal; a sliding layer's query at
  position p attends keys max(0, p - W + 1) .. p.
* Router: f32 softmax over the experts' logits, the top k, renormalized
  to sum 1 with norm_topk_prob. Expert: down(silu(gate(y)) * up(y)).
* Logits: rms(x) @ lm_head (untied).

Departures from the published description, by design: the weights are
random (the tests' and the benchmark's); there is no q/k norm (the
config has no key for one: an assumption); the MTP head the model card
describes is left out (no key for it either).
"""

from __future__ import annotations

import math

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def inv_freq(group: dict, dim: int):
    """(inv_freq (dim/2,), cos/sin scale) of one ``rope_parameters``
    entry: "default", or "yarn" with HF's correction range (floored and
    ceiled unless ``truncate`` is False) and attention_factor (0.1 ln
    factor + 1 where the config gives none)."""
    base = float(group["rope_theta"])
    pos_freqs = base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim)
    if group["rope_type"] == "default":
        return 1.0 / pos_freqs, 1.0
    factor = float(group["factor"])
    orig = group["original_max_position_embeddings"]

    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (
            2 * math.log(base))

    lo, hi = corr(group["beta_fast"]), corr(group["beta_slow"])
    if group.get("truncate", True):
        lo, hi = math.floor(lo), math.ceil(hi)
    lo, hi = max(lo, 0), min(hi, dim - 1)
    if lo == hi:
        hi += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - lo)
            / (hi - lo)).clamp(0, 1)
    extra, inter = 1.0 / pos_freqs, 1.0 / (factor * pos_freqs)
    f = inter * ramp + extra * (1 - ramp)
    att = group.get("attention_factor")
    if att is None:
        att = 0.1 * math.log(factor) + 1.0
    return f, float(att)


def _rope(x, pos, group, dim):
    f, scale = inv_freq(group, dim)
    ang = pos.float()[:, None] * f.to(x.device)      # f32, as HF
    ang = torch.cat([ang, ang], dim=-1)
    cos = (torch.cos(ang) * scale)[:, None, :]
    sin = (torch.sin(ang) * scale)[:, None, :]
    h = dim // 2
    rot = torch.cat([-x[..., h:], x[..., :h]], dim=-1)
    return x * cos + rot * sin


def _rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w


def _moe(y, router, w_gate_up, w_down, cfg):
    E, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    I = cfg["moe_intermediate_size"]
    probs = torch.softmax(y @ router.t(), dim=-1)
    w, idx = torch.topk(probs, k, dim=-1)
    if cfg["norm_topk_prob"]:
        w = w / w.sum(dim=-1, keepdim=True)
    out = torch.zeros_like(y)
    for e in range(E):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        gu = y[tok] @ w_gate_up[e].t()
        a = torch.nn.functional.silu(gu[:, :I]) * gu[:, I:]
        out.index_add_(0, tok, (a @ w_down[e].t()) * w[tok, slot][:, None])
    return out


def forward(W: dict, cfg: dict, tokens) -> torch.Tensor:
    """Logits (T, V) of one sequence of token ids, every position."""
    W = {k: v.float() for k, v in W.items()}
    tokens = torch.as_tensor(tokens, dtype=torch.long,
                             device=W["embed"].device)
    T = tokens.shape[0]
    NH, NKV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    HD = cfg["head_dim"]
    eps, Wn = cfg["rms_norm_eps"], cfg["sliding_window"]
    pos = torch.arange(T, device=tokens.device)
    causal = pos[None, :] <= pos[:, None]
    band = causal & (pos[None, :] > pos[:, None] - Wn)
    x = W["embed"][tokens]
    for i, kind in enumerate(cfg["layer_types"]):
        h = _rms(x, W["attn_norm"][i], eps)
        q, k, v = (h @ W["wqkv"][i].t()).split(
            (NH * HD, NKV * HD, NKV * HD), dim=-1)
        q, k, v = (t.reshape(T, -1, HD) for t in (q, k, v))
        group = cfg["rope_parameters"][kind]
        q, k = _rope(q, pos, group, HD), _rope(k, pos, group, HD)
        k, v = (t.repeat_interleave(NH // NKV, dim=1) for t in (k, v))
        s = torch.einsum("thd,shd->hts", q, k) / math.sqrt(HD)
        keep = band if kind == "sliding_attention" else causal
        s = s.masked_fill(~keep, float("-inf"))
        att = torch.einsum("hts,shd->thd", torch.softmax(s, dim=-1), v)
        x = x + att.reshape(T, NH * HD) @ W["wo"][i].t()
        y = _rms(x, W["mlp_norm"][i], eps)
        x = x + _moe(y, W["router"][i], W["w_gate_up"][i], W["w_down"][i],
                     cfg)
    return _rms(x, W["final_norm"], eps) @ W["lm_head"].t()
