"""The plain GPT-2 reference of the serving cells: a forward pass in f32
(TF32 off: run it under ``reference.full_f32``) in plain PyTorch, with
the benchmark's own frozen copy of the arithmetic by which the served
model derives its stored numbers from the f32 weights. It imports torch
only: nothing of the program.

The serving mode it follows (a configuration's ``serving`` group):

* the prompt runs on a bf16 copy of the weights: every leaf but the
  layernorms rounded to bf16 (``prefill: "bf16"``);
* decode runs on int8 weights: the leaves rounded to bf16, then each row
  of the four block matrices and of wte (embedding and tied lm_head)
  quantized symmetrically, scale = absmax / 127 rounded to bf16, values
  rounded half to even and clipped to ±127 (``decode: "int8"``);
* each token's K and V enter the pool as int8 per (token, head) with the
  same formula (``kv: "int8"``): a prompt attends its own K and V as
  computed, every later query reads them from the pool.

Where it departs from the program, by design: activations stay f32 (the
program rounds them to bf16), and a decode query reads every earlier
generated token from the pool, where the program reads the tokens of its
own decode chunk unquantized.

The control takes each stated precision one step down (``CONTROL``): the
prompt on fp8 (e4m3) weights with a scale a row, decode on int4 weights,
int4 K and V.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

REFERENCE = {"prefill": "bf16", "decode": "int8", "kv": "int8"}
CONTROL = {"prefill": "fp8", "decode": "int4", "kv": "int4"}

LN_KEYS = ("ln1w", "ln1b", "ln2w", "ln2b", "lnfw", "lnfb")
MATRIX_KEYS = ("qkvw", "attprojw", "fcw", "fcprojw", "wte")
INT_MAX = {"int8": 127.0, "int4": 7.0}
E4M3_MAX = 448.0
LN_EPS = 1e-5
GELU_SCALE = math.sqrt(2.0 / math.pi)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def quant_rows(x: torch.Tensor, kind: str) -> torch.Tensor:
    """x quantized over its last axis and brought back to f32: int8 or
    int4 symmetric (scale absmax / qmax rounded to bf16, 1 on an all-zero
    row, round half to even, clip), or fp8 e4m3 with a scale of absmax /
    448 a row."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    if kind == "fp8":
        scale = torch.where(absmax > 0, absmax / E4M3_MAX,
                            torch.ones_like(absmax))
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    qmax = INT_MAX[kind]
    scale = round_bf16(torch.where(absmax > 0, absmax / qmax,
                                   torch.ones_like(absmax)))
    return torch.clamp(torch.round(x / scale), -qmax, qmax) * scale


def derive(params32: Dict[str, torch.Tensor], kind: str
           ) -> Dict[str, torch.Tensor]:
    """The f32 values of the weights as a model served in ``kind`` holds
    them: "bf16" (every leaf but the layernorms rounded to bf16), or
    "int8" / "int4" / "fp8" (the block matrices and wte of that bf16 copy
    quantized a row at a time)."""
    out = {}
    for k, v in params32.items():
        if k in LN_KEYS:
            out[k] = v.float()
            continue
        w = round_bf16(v)
        out[k] = quant_rows(w, kind) if kind != "bf16" and \
            k in MATRIX_KEYS else w
    return out


def _ln(x, w, b):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * w + b


def _gelu(x):
    return 0.5 * x * (1.0 + torch.tanh(GELU_SCALE * (x + 0.044715 * x ** 3)))


def forward(W: Dict[str, torch.Tensor], NH: int, tokens: torch.Tensor,
            pos0: int, past: Optional[List[Tuple[torch.Tensor, ...]]],
            kv: str, quantize_own: bool, logit_rows) -> Tuple:
    """One causal pass over ``tokens`` (T,) at positions pos0.. with
    ``past`` (per layer (K, V), (P, NH, HS), already as the pool holds
    them) in front. Returns (logits (rows, V) at ``logit_rows``, per layer
    (K, V) of these tokens as the pool holds them). ``quantize_own``:
    the queries read this pass's own K and V from the pool too (decode),
    not as computed (a prompt)."""
    T = tokens.shape[0]
    C = W["wte"].shape[1]
    HS = C // NH
    L = W["qkvw"].shape[0]
    dev = W["wte"].device
    x = W["wte"][tokens] + W["wpe"][pos0 + torch.arange(T, device=dev)]
    P = 0 if past is None else past[0][0].shape[0]
    keep = torch.ones(T, P + T, dtype=torch.bool, device=dev)
    keep[:, P:] = torch.ones(T, T, dtype=torch.bool, device=dev).tril()
    new = []
    for i in range(L):
        h = _ln(x, W["ln1w"][i], W["ln1b"][i])
        qkv = h @ W["qkvw"][i].t() + W["qkvb"][i]
        q, k, v = (t.reshape(T, NH, HS) for t in qkv.split(C, dim=-1))
        kp, vp = quant_rows(k, kv), quant_rows(v, kv)
        new.append((kp, vp))
        ks, vs = (kp, vp) if quantize_own else (k, v)
        if past is not None:
            ks = torch.cat([past[i][0], ks])
            vs = torch.cat([past[i][1], vs])
        s = torch.einsum("thd,shd->hts", q, ks) / math.sqrt(HS)
        s = s.masked_fill(~keep, float("-inf"))
        att = torch.einsum("hts,shd->thd", torch.softmax(s, dim=-1), vs)
        x = x + att.reshape(T, C) @ W["attprojw"][i].t() + W["attprojb"][i]
        h2 = _ln(x, W["ln2w"][i], W["ln2b"][i])
        x = x + _gelu(h2 @ W["fcw"][i].t() + W["fcb"][i]) \
            @ W["fcprojw"][i].t() + W["fcprojb"][i]
    xr = _ln(x[logit_rows], W["lnfw"], W["lnfb"])
    return xr @ W["wte"].t(), new


class ServedModel:
    """The reference (``REFERENCE``) or the control (``CONTROL``) built
    from the f32 weights: ``prefill`` and ``decode`` weight sets and the
    KV format."""

    def __init__(self, params32: Dict[str, torch.Tensor], NH: int,
                 precision: Dict[str, str] = REFERENCE):
        self.NH = NH
        self.kv = precision["kv"]
        self.prefill_w = derive(params32, precision["prefill"])
        self.decode_w = derive(params32, precision["decode"])

    def logits(self, prompt: Sequence[int], generated: Sequence[int],
               all_prompt_rows: bool = False):
        """Logits at every position that produced a served token: the
        prompt's last position (served token 0), then each generated
        token but the last (served tokens 1..). With
        ``all_prompt_rows`` also the logits at every prompt position.
        Returns (served (len(generated), V), prompt rows or None)."""
        dev = self.prefill_w["wte"].device
        p = torch.as_tensor(list(prompt), dtype=torch.long, device=dev)
        n = p.shape[0]
        rows = slice(0, n) if all_prompt_rows else slice(n - 1, n)
        lg_p, past = forward(self.prefill_w, self.NH, p, 0, None, self.kv,
                             False, rows)
        first = lg_p[-1:]
        served = [first]
        if len(generated) > 1:
            g = torch.as_tensor(list(generated[:-1]), dtype=torch.long,
                                device=dev)
            lg_d, _ = forward(self.decode_w, self.NH, g, n, past, self.kv,
                              True, slice(None))
            served.append(lg_d)
        return torch.cat(served), (lg_p if all_prompt_rows else None)
