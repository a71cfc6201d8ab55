"""L1 ops: plain PyTorch building blocks (port of llmc_paged_tpu/ops/layers.py).

Parity notes, as in the JAX package:
  * layernorm: eps=1e-5, biased variance, statistics in fp32, result cast
    back to the input dtype
  * gelu: tanh approximation with the sqrt(2/pi) constant
  * attention: scale 1/sqrt(head_dim) before the softmax
Float32 matmuls must run in full fp32 on the card: callers that compare
with the reference set ``torch.backends.cuda.matmul.allow_tf32 = False``
(PyTorch's default), the analogue of the JAX package's Precision.HIGHEST.
"""

from __future__ import annotations

import torch

LN_EPS = 1e-5
GELU_SCALE = 0.7978845608028654  # sqrt(2/pi)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm over the last axis with biased variance; the reduction
    runs in fp32 and the result is cast back to x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    out = (xf - mean) * rstd * w.float() + b.float()
    return out.to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximated GELU."""
    cube = 0.044715 * x * x * x
    return 0.5 * x * (1.0 + torch.tanh(GELU_SCALE * (x + cube)))


def linear(x: torch.Tensor, w: torch.Tensor,
           b: torch.Tensor | None = None) -> torch.Tensor:
    """x(..., IC) @ w(OC, IC)^T + b, in x's dtype."""
    out = torch.matmul(x, w.t())
    if b is not None:
        out = out + b
    return out


def _scale(HS: int, dtype: torch.dtype) -> float:
    """1/sqrt(HS) rounded through ``dtype`` (the JAX package computes it
    in the query's dtype)."""
    return float(1.0 / torch.sqrt(torch.tensor(HS, dtype=dtype)))


def causal_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Dense causal attention; q,k,v are (B, NH, T, HS) → (B, NH, T, HS).
    The plain O(T²) version the paged prefill uses."""
    T, HS = q.shape[2], q.shape[3]
    scores = torch.matmul(q, k.transpose(-1, -2)) * _scale(HS, q.dtype)
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    neg = torch.finfo(scores.dtype).min
    scores = scores.masked_fill(~causal, neg)
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs, v)


# the prefill attention on every device: plain torch (no library kernel)
prefill_attention = causal_attention


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: torch.Tensor,
                     start: torch.Tensor | None = None) -> torch.Tensor:
    """Single-position attention over a dense KV cache.

    q: (B, NH, HS); k_cache/v_cache: (B, NH, S, HS); ``length``: (B,) valid
    positions per row; optional ``start``: (B,) window lower bound. A
    fully masked row (start >= length) returns zeros. Mixed dtypes (an
    f32 query over a bf16 cache) promote, as jnp.einsum does."""
    B, NH, S, HS = k_cache.shape
    dt = torch.promote_types(q.dtype, k_cache.dtype)
    q, k_cache, v_cache = q.to(dt), k_cache.to(dt), v_cache.to(dt)
    scores = torch.einsum("bhd,bhkd->bhk", q, k_cache) * _scale(HS, q.dtype)
    pos = torch.arange(S, device=q.device).view(1, 1, S)
    valid = pos < length.view(B, 1, 1)
    if start is not None:
        valid = valid & (pos >= start.view(B, 1, 1))
    neg = torch.finfo(scores.dtype).min
    scores = scores.masked_fill(~valid, neg)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(valid, probs, torch.zeros((), dtype=probs.dtype,
                                                  device=probs.device))
    return torch.einsum("bhk,bhkd->bhd", probs, v_cache)
