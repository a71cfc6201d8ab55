"""Weight-only INT8 (port of llmc_paged_tpu/ops/int8.py): per-output-
channel quantization, the serving int8 linear, and the fused dequant
matmul ``int8_matmul`` with its hand-written CUDA kernel.

    out[b, oc] = s[oc] * sum_ic x[b, ic] * wq[oc, ic]     (+ bias)

On the JAX package's serving path the int8 linear is a plain XLA product
(its Pallas ``int8_matmul`` serves only the kernel lab); here it is a
plain torch product over the dequantized weight, and ``int8_matmul``
(``csrc/int8_matmul.cu``) serves the kernel lab
(``ops/dev/bench_int8_matmul.py``). The JAX package's 128-padding of
quantized weights (``pad_weight_for_tpu``) and its tile pickers are
Mosaic tiling artifacts and are not ported: the port's weights keep
their shapes and the kernel takes any B, OC and IC.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from llmc_paged_tpu_torch.ops._build import check_operand, entry, launch

QUANT_KEYS = ("qkvw", "attprojw", "fcw", "fcprojw", "wte")

# launches of the CUDA kernel, by compute mode (plain ints; reset by callers)
LAUNCHES = {"int8_matmul_bf16": 0, "int8_matmul_fp32": 0}
_X_KIND = {torch.float32: 0, torch.bfloat16: 1}   # the .cu enum


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


def dequantize(wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(OC, IC) int8 and (OC,) scales → f32 weights."""
    return wq.float() * scale[:, None]


def int8_linear_ref(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                    b: torch.Tensor | None = None) -> torch.Tensor:
    """The JAX package's ``int8_linear_xla``: x(..., IC) @ wq^T in x's
    dtype (the int8 values cast to it), then the scale, then the bias.
    In fp32 with TF32 off it is the kernel lab's validation reference."""
    out = torch.matmul(x, wq.t().to(x.dtype)) * scale.to(x.dtype)
    if b is not None:
        out = out + b
    return out


def int8_matmul_ref(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                    bf16_compute: bool = True) -> torch.Tensor:
    """Plain version of int8_matmul: the kernel's arithmetic (x rounded
    to bf16 once with ``bf16_compute``, f32 products, the scale applied
    after the sum), f32 (B, OC)."""
    return int8_linear(x, wq, scale, bf16_compute=bf16_compute)


def int8_matmul(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                bf16_compute: bool = True) -> torch.Tensor:
    """Fused dequant matmul: x (B, IC) f32/bf16 × wq (OC, IC) int8 with
    per-channel scale (OC,) f32 → (B, OC) f32 (contract of the JAX
    package's ``int8_matmul``). bf16_compute=True rounds x to bf16 once
    (int8 × bf16 products are exact in f32); False keeps the f32
    product. A CPU tensor takes the plain version; a CUDA tensor
    launches ``csrc/int8_matmul.cu`` or raises."""
    if x.device.type == "cpu":
        return int8_matmul_ref(x, wq, scale, bf16_compute)
    if x.device.type != "cuda":
        raise ValueError(f"no int8_matmul route for device {x.device}")
    if x.dim() != 2 or wq.dim() != 2:
        raise ValueError(f"x {tuple(x.shape)} and wq {tuple(wq.shape)} are "
                         "not (B, IC) and (OC, IC)")
    B, IC = x.shape
    OC = wq.shape[0]
    check_operand("x", x, tuple(_X_KIND), (B, IC), x.device)
    check_operand("wq", wq, (torch.int8,), (OC, IC), x.device)
    check_operand("scale", scale, (torch.float32,), (OC,), x.device)
    out = torch.empty((B, OC), dtype=torch.float32, device=x.device)
    if out.numel() == 0 or IC == 0:
        return out.zero_()
    fn = entry("int8_matmul", "int8_matmul",
               [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
               + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    launch(fn, x.device, (_X_KIND[x.dtype], int(bf16_compute), x.data_ptr(),
                          wq.data_ptr(), scale.data_ptr(), out.data_ptr(),
                          B, OC, IC), "int8_matmul")
    LAUNCHES["int8_matmul_bf16" if bf16_compute else "int8_matmul_fp32"] += 1
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
