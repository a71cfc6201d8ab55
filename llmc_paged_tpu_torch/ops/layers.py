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

# re-exported under the JAX package's name (its layers.py:86)
from llmc_paged_tpu_torch.ops.flash_attention import causal_attention_flash

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


def takes_flash(q: torch.Tensor, use_kernel: bool = True) -> bool:
    """The JAX package's rule for the flash kernel, with "on the card"
    for "on the TPU": bf16 q, T >= 256 and T % 128 == 0."""
    T = q.shape[2]
    return (q.is_cuda and use_kernel and q.dtype == torch.bfloat16
            and T >= 256 and T % 128 == 0)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      use_kernel: bool = True) -> torch.Tensor:
    """Dispatch: the flash kernel (``causal_attention_flash``) where
    ``takes_flash``, the dense ``causal_attention`` otherwise, so fp32
    prefill keeps the dense path's parity, as in the JAX package. The
    kernel takes contiguous (B, NH, T, HS) operands: the heads the model
    hands over are transposed views, copied here."""
    if takes_flash(q, use_kernel):
        return causal_attention_flash(q.contiguous(), k.contiguous(),
                                      v.contiguous())
    return causal_attention(q, k, v)


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


def softmax_cross_entropy(logits: torch.Tensor,
                          targets: torch.Tensor) -> torch.Tensor:
    """Mean NLL over all (B, T) positions: logits (B, T, V), targets
    (B, T) int (crossentropy_forward, train_gpt2.c:427-441, mean at
    :796-806); log-softmax in the logits' dtype, as the JAX package."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets[..., None].long())[..., 0]
    return nll.mean()
