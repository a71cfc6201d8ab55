"""INT8 dequant-matmul kernel lab (dev/cuda/matmul_forward.cu pattern),
port of llmc_paged_tpu/ops/dev/bench_int8_matmul.py.

The versions: the naive dequant product (the validation reference), the
CUDA kernel in both compute modes, the f32 and bf16 dense products for
context (bf16 is the bar: twice the weight bytes of int8), a
dequant-to-bf16 product, and one version the JAX lab cannot have: the
port's serving ``int8_linear`` on the bf16 activation it serves, a plain
product over the weight dequantized on every call. The bf16 mode
differs from the f32 reference by the activation's rounding (~5e-3), so
it is held against ``int8_linear``, the same arithmetic in plain
PyTorch (x rounded to bf16 once, f32 products); both kernel modes at
1e-5 rel + 1e-5·max|ref| abs, since only the order of the f32 sums
differs.

Run: python -m llmc_paged_tpu_torch.ops.dev.bench_int8_matmul [--set 124m|1558m|all]
     [--device cpu] [--iters N]
"""

from __future__ import annotations

import torch

from llmc_paged_tpu_torch.ops.dev.harness import parse_args, sweep
from llmc_paged_tpu_torch.ops.int8 import (
    int8_linear,
    int8_linear_ref,
    int8_matmul,
    quantize_per_row,
)
from llmc_paged_tpu_torch.ops.layers import linear


def make_args(B, OC, IC, device):
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(B, IC, generator=g, device=device)
    w = torch.randn(OC, IC, generator=g, device=device) * 0.02
    wq, s = quantize_per_row(w)
    return x, wq, s, w, w.bfloat16(), x.bfloat16()


# the kernel against its plain arithmetic: f32 sums in another order
KERNEL_TOL = {"rtol": 1e-5, "atol": 1e-5, "atol_of_max": True}

VERSIONS = {
    "v0_dequant_ref (naive)": lambda x, wq, s, w, wb, xb:
        int8_linear_ref(x, wq, s),
    # bf16 multiply (int8 exact in bf16, the activation rounds): ~5e-3 off
    # the f32 reference, so held against the serving linear's arithmetic
    "v1_cuda_fused": (lambda x, wq, s, w, wb, xb: int8_matmul(x, wq, s),
                      dict(KERNEL_TOL, ref="int8_linear (port)")),
    "v1_cuda_fp32exact": (lambda x, wq, s, w, wb, xb:
                          int8_matmul(x, wq, s, bf16_compute=False),
                          KERNEL_TOL),
    # the port's serving int8 linear on the bf16 activation it serves
    "int8_linear (port)": (lambda x, wq, s, w, wb, xb:
                           int8_linear(xb, wq, s), {"validate": False}),
    # timing context only: these differ numerically from the int8 ref
    "fp32_matmul (context)": (lambda x, wq, s, w, wb, xb: linear(x, w),
                              {"validate": False}),
    # the bar the fused kernel must beat: the bf16 dense product
    "bf16_matmul (serving)": (lambda x, wq, s, w, wb, xb: linear(xb, wb),
                              {"validate": False}),
    "v2_dequant_bf16": (lambda x, wq, s, w, wb, xb:
                        torch.matmul(xb, wq.t().bfloat16()).float() * s,
                        {"validate": False}),
}


def weight_bytes(B, OC, IC):
    return OC * IC  # int8


def flops(B, OC, IC):
    return 2 * B * OC * IC


CONFIGS = {
    "124m": [
        (8, 2304, 768),      # 124M qkv
        (8, 3072, 768),      # 124M fc
        (8, 51200, 768),     # 124M lm_head (padded vocab)
        (256, 3072, 768),    # prefill rows
    ],
    # the JAX lab's padded 1.5B shapes, kept so the numbers compare config
    # for config (the port's weights are unpadded), plus the unpadded qkv
    "1558m": [
        (8, 4864, 1664),     # qkv padded
        (8, 1664, 1664),     # attproj padded
        (8, 6400, 1664),     # fc padded
        (8, 1664, 6400),     # fcproj padded
        (8, 51200, 1664),    # lm_head padded
        (8, 4800, 1600),     # qkv unpadded
    ],
}


def main(argv=None):
    a = parse_args(argv, CONFIGS, "124m")
    configs = (CONFIGS[a.set] if a.set != "all"
               else [c for s in CONFIGS.values() for c in s])
    return sweep(VERSIONS, make_args, configs,
                 ref_name="v0_dequant_ref (naive)", flops_fn=flops,
                 bytes_fn=weight_bytes, iters=a.iters, device=a.device)


if __name__ == "__main__":
    main()
