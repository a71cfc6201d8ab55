"""Weight-only INT8 (port of the host half of llmc_paged_tpu/ops/int8.py):
per-output-channel quantization and the serving int8 linear.

    out[b, oc] = s[oc] * sum_ic x[b, ic] * wq[oc, ic]     (+ bias)

On the JAX package's serving path the int8 linear is a plain XLA product
(its Pallas ``int8_matmul`` serves only the kernel lab); here it is a
plain torch product over the dequantized weight. The JAX package's
128-padding of quantized weights (``pad_weight_for_tpu``) is a Mosaic
tiling artifact and is not ported: the port's weights keep their shapes.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

QUANT_KEYS = ("qkvw", "attprojw", "fcw", "fcprojw", "wte")


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 over the last axis: x (..., HS) →
    (int8 (..., HS), scale f32 (...)). absmax/127 (computed in x's
    dtype), round half to even, clip ±127, scale 1.0 on all-zero rows."""
    absmax = x.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / 127.0,
                        torch.ones((), dtype=absmax.dtype,
                                   device=absmax.device)).float()
    xq = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return xq.to(torch.int8), scale


def quantize_per_row(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8: w (OC, IC) → (int8, f32 (OC,)).
    The same formula as the KV pages' quantize_rows."""
    if w.dtype == torch.int8:
        raise ValueError("already quantized — re-quantizing would "
                         "overwrite the scales")
    return quantize_rows(w)


def int8_linear(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                b: torch.Tensor | None = None,
                bf16_compute: bool = True) -> torch.Tensor:
    """The serving int8 linear: x(..., IC) @ dequant(wq)(OC, IC)^T + b,
    f32 result.

    bf16_compute=True: the activation rounds to bf16 and the product is
    taken in f32 — int8 weights are exact in bf16 and a product of two
    bf16 values is exact in f32, so this is the JAX package's bf16
    multiply with f32 accumulation. False: the fp32-exact product."""
    xin = x.to(torch.bfloat16).float() if bf16_compute else x.float()
    out = torch.matmul(xin, wq.t().float()) * scale
    if b is not None:
        out = out + b
    return out


def quantize_params(params: Dict[str, torch.Tensor], keys=QUANT_KEYS
                    ) -> Dict[str, torch.Tensor]:
    """Quantize the matmul weights of a params dict, adding '<k>_scale'
    entries (per-(layer, row) scales for the stacked (L, OC, IC) weights).
    Layernorms, biases and wpe stay float."""
    out = dict(params)
    for k in keys:
        wq, s = quantize_per_row(params[k])   # rows over the last axis
        out[k] = wq
        out[k + "_scale"] = s
    return out
