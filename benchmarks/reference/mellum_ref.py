"""The plain Mellum 2 reference of the serving cell: the forward pass of
``tests/mellum_reference.py`` (the layer as published: RMSNorm,
grouped-query attention with default rope on sliding layers and YaRN on
full ones, the softmax top-k router and SwiGLU experts, the untied
lm_head) in f32 plain PyTorch (TF32 off: run it under
``reference.full_f32``), with the benchmark's own frozen copy of the
arithmetic by which the served model stores its numbers. It imports
torch only: nothing of the program.

The serving mode it follows (a configuration's ``serving`` group):

* the weights as served, bf16 (``prefill``/``decode``: "bf16"): the
  program's copy, exact;
* each token's K and V enter the pool as int8 per (token, head) over the
  head dim, scale = absmax / 127 rounded to bf16, values rounded half to
  even and clipped to ±127 (``kv``: "int8"): a prompt attends its own K
  and V as computed, every later query reads them from the pool, and a
  sliding layer's query at p reads keys p - W + 1 .. p.

Where it departs from the program, by design: activations stay f32 (the
program rounds them to bf16), and a decode query reads every earlier
generated token from the pool, where the program reads the tokens of its
own decode link unquantized.

The weights are read from the one copy the card holds (24 GB in bf16 at
the cell's size; f32 would be twice that) and brought to f32 one layer
and one expert at a time.

The control takes each stated precision one step down (``CONTROL``):
fp8 (e4m3) weights with a scale a row, int4 K and V. "float32" weights
and K/V keep every number as given (the tests' check that this copy and
the plain forward agree).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

REFERENCE = {"prefill": "bf16", "decode": "bf16", "kv": "int8"}
CONTROL = {"prefill": "fp8", "decode": "fp8", "kv": "int4"}

NORM_KEYS = ("attn_norm", "mlp_norm", "final_norm")
INT_MAX = {"int8": 127.0, "int4": 7.0}
E4M3_MAX = 448.0
# queries a block of the attention (its scores are NH x block x keys f32)
QUERY_BLOCK = 256


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def quant_rows(x: torch.Tensor, kind: str,
               bf16_scale: bool = True) -> torch.Tensor:
    """x quantized over its last axis and brought back to f32: int8 or
    int4 symmetric (scale absmax / qmax, rounded to bf16 where the
    program computes it in bf16, 1 on an all-zero row, round half to
    even, clip), fp8 e4m3 with a scale of absmax / 448 a row, or
    unchanged ("float32")."""
    if kind == "float32":
        return x
    absmax = x.abs().amax(dim=-1, keepdim=True)
    if kind == "fp8":
        scale = torch.where(absmax > 0, absmax / E4M3_MAX,
                            torch.ones_like(absmax))
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    qmax = INT_MAX[kind]
    scale = torch.where(absmax > 0, absmax / qmax, torch.ones_like(absmax))
    if bf16_scale:
        scale = round_bf16(scale)
    return torch.clamp(torch.round(x / scale), -qmax, qmax) * scale


def derive(w: torch.Tensor, kind: str) -> torch.Tensor:
    """The f32 values of a matrix as a model served in ``kind`` holds it:
    "float32" (as given), "bf16" (rounded to bf16) or "fp8" (that bf16
    copy quantized a row at a time)."""
    if kind == "float32":
        return w.float()
    w = round_bf16(w.float())
    return quant_rows(w, "fp8") if kind == "fp8" else w


def inv_freq(group: dict, dim: int):
    """(inv_freq (dim/2,) f32, cos/sin scale) of one ``rope_parameters``
    entry (HF's default and YaRN formulas, in f32 as HF computes them)."""
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
    f = (1.0 / (factor * pos_freqs)) * ramp + (1.0 / pos_freqs) * (1 - ramp)
    att = group.get("attention_factor")
    if att is None:
        att = 0.1 * math.log(factor) + 1.0
    return f, float(att)


def _rope(x, pos, group, dim):
    f, scale = inv_freq(group, dim)
    ang = pos.float()[:, None] * f.to(x.device)
    ang = torch.cat([ang, ang], dim=-1)
    cos = (torch.cos(ang) * scale)[:, None, :]
    sin = (torch.sin(ang) * scale)[:, None, :]
    h = dim // 2
    return x * cos + torch.cat([-x[..., h:], x[..., :h]], dim=-1) * sin


def _rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) \
        * w.float()


class ServedModel:
    """The reference (``REFERENCE``) or the control (``CONTROL``) over the
    served weights ``params`` (the program's names and layout) and the
    configuration ``cfg`` (HF's config.json keys). ``activations``: the
    program's compute dtype, in which it computes the K/V scales
    ("bfloat16" rounds them to bf16, "float32" keeps them)."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: dict,
                 precision: Dict[str, str] = REFERENCE,
                 activations: str = "bfloat16"):
        self.W, self.cfg = params, cfg
        self.precision = precision
        self.kv = precision["kv"]
        self.bf16_scale = activations == "bfloat16"

    def _moe(self, y, i: int, kind: str):
        cfg, W = self.cfg, self.W
        E, k = cfg["num_experts"], cfg["num_experts_per_tok"]
        I = cfg["moe_intermediate_size"]
        probs = torch.softmax(y @ derive(W["router"][i], kind).t(), dim=-1)
        w, idx = torch.topk(probs, k, dim=-1)
        if cfg["norm_topk_prob"]:
            w = w / w.sum(dim=-1, keepdim=True)
        out = torch.zeros_like(y)
        for e in range(E):
            tok, slot = torch.nonzero(idx == e, as_tuple=True)
            if tok.numel() == 0:
                continue
            gu = y[tok] @ derive(W["w_gate_up"][i][e], kind).t()
            a = torch.nn.functional.silu(gu[:, :I]) * gu[:, I:]
            out.index_add_(0, tok, (a @ derive(W["w_down"][i][e], kind).t())
                           * w[tok, slot][:, None])
        return out

    def forward(self, tokens: torch.Tensor, pos0: int,
                past: Optional[List[Tuple[torch.Tensor, ...]]], kind: str,
                quantize_own: bool, logit_rows) -> Tuple:
        """One causal pass over ``tokens`` (T,) at positions pos0.. with
        ``past`` (per layer (K, V), (P, NKV, HD), as the pool holds them)
        in front, on weights served in ``kind``. Returns (logits at
        ``logit_rows``, per layer (K, V) of these tokens as the pool holds
        them). ``quantize_own``: the queries read this pass's own K and V
        from the pool too (decode), not as computed (a prompt)."""
        cfg, W = self.cfg, self.W
        NH, NKV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        HD, eps = cfg["head_dim"], cfg["rms_norm_eps"]
        Wn, G = cfg["sliding_window"], NH // NKV
        dev = tokens.device
        T = tokens.shape[0]
        P = 0 if past is None else past[0][0].shape[0]
        qpos = pos0 + torch.arange(T, device=dev)
        kpos = torch.arange(P + T, device=dev)
        x = derive(W["embed"][tokens], kind)
        new = []
        for i, lt in enumerate(cfg["layer_types"]):
            h = _rms(x, W["attn_norm"][i], eps)
            q, k, v = (h @ derive(W["wqkv"][i], kind).t()).split(
                (NH * HD, NKV * HD, NKV * HD), dim=-1)
            q, k, v = (t.reshape(T, -1, HD) for t in (q, k, v))
            group = cfg["rope_parameters"][lt]
            q, k = _rope(q, qpos, group, HD), _rope(k, qpos, group, HD)
            kp, vp = (quant_rows(t, self.kv, self.bf16_scale)
                      for t in (k, v))
            new.append((kp, vp))
            ks, vs = (kp, vp) if quantize_own else (k, v)
            if past is not None:
                ks = torch.cat([past[i][0], ks])
                vs = torch.cat([past[i][1], vs])
            att = torch.empty(T, NKV, G, HD, device=dev)
            qg = q.reshape(T, NKV, G, HD)
            for a in range(0, T, QUERY_BLOCK):
                b = min(a + QUERY_BLOCK, T)
                qp = qpos[a:b, None]
                keep = kpos[None, :] <= qp
                if lt == "sliding_attention":
                    keep = keep & (kpos[None, :] > qp - Wn)
                s = torch.einsum("tngd,snd->ngts", qg[a:b], ks) \
                    / math.sqrt(HD)
                s = s.masked_fill(~keep, float("-inf"))
                att[a:b] = torch.einsum("ngts,snd->tngd",
                                        torch.softmax(s, dim=-1), vs)
            x = x + att.reshape(T, NH * HD) @ derive(W["wo"][i], kind).t()
            x = x + self._moe(_rms(x, W["mlp_norm"][i], eps), i, kind)
        xr = _rms(x[logit_rows], W["final_norm"], eps)
        return xr @ derive(W["lm_head"], kind).t(), new

    def logits(self, prompt: Sequence[int], generated: Sequence[int],
               all_prompt_rows: bool = False):
        """Logits at every position that produced a served token: the
        prompt's last position (served token 0), then each generated
        token but the last (served tokens 1..). With
        ``all_prompt_rows`` also the logits at every prompt position.
        Returns (served (len(generated), V), prompt rows or None)."""
        dev = self.W["embed"].device
        p = torch.as_tensor(list(prompt), dtype=torch.long, device=dev)
        n = p.shape[0]
        rows = slice(0, n) if all_prompt_rows else slice(n - 1, n)
        lg_p, past = self.forward(p, 0, None, self.precision["prefill"],
                                  False, rows)
        served = [lg_p[-1:]]
        if len(generated) > 1:
            g = torch.as_tensor(list(generated[:-1]), dtype=torch.long,
                                device=dev)
            lg_d, _ = self.forward(g, n, past, self.precision["decode"],
                                   True, slice(None))
            served.append(lg_d)
        return torch.cat(served), (lg_p if all_prompt_rows else None)
