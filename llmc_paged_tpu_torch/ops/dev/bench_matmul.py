"""Matmul lab (dev/cuda/matmul_forward.cu pattern), port of
llmc_paged_tpu/ops/dev/bench_matmul.py: the decode GEMVs and prefill
GEMMs of GPT-2 across dtype and precision, all plain ``torch.matmul``
(the port leaves dense products to PyTorch, as the JAX package left them
to XLA; the INT8 fused dequant kernel is in bench_int8_matmul.py).

fp32 with TF32 off is the parity mode; "fp32_default" allows TF32 for
that version only (the JAX lab's DEFAULT precision, bf16x3 passes on the
TPU) and restores the setting after each call; bf16 is the serving mode.

Run: python -m llmc_paged_tpu_torch.ops.dev.bench_matmul [--device cpu]
     [--iters N]
"""

from __future__ import annotations

import torch

from llmc_paged_tpu_torch.ops.dev.harness import parse_args, sweep
from llmc_paged_tpu_torch.ops.layers import linear


def make_args(B, OC, IC, device):
    g = torch.Generator(device=device).manual_seed(0)
    x32 = torch.randn(B, IC, generator=g, device=device)
    w32 = torch.randn(OC, IC, generator=g, device=device) * 0.02
    return x32, w32, x32.bfloat16(), w32.bfloat16()


def _linear_tf32(x, w):
    """linear with TF32 allowed for this call only."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return linear(x, w)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


VERSIONS = {
    "fp32_highest (parity)": lambda x, w, xh, wh: linear(x, w),
    # TF32 keeps ~3 decimal digits: timing context, not a validation
    # target
    "fp32_default": (lambda x, w, xh, wh: _linear_tf32(x, w),
                     {"validate": False}),
    # bf16 differs numerically by design: timing context only
    "bf16 (serving)": (lambda x, w, xh, wh: linear(xh, wh),
                       {"validate": False}),
}


def flops(B, OC, IC):
    return 2 * B * OC * IC


def weight_bytes(B, OC, IC):
    return OC * IC * 4


CONFIGS = [
    (8, 2304, 768),       # 124M decode qkv GEMV
    (8, 768, 768),        # attproj
    (8, 3072, 768),       # fc
    (8, 51200, 768),      # lm_head (padded vocab)
    (1024, 2304, 768),    # prefill GEMM
    (1024, 51200, 768),   # prefill lm_head (full-T parity mode)
    (8, 4800, 1600),      # 1.5B qkv
]


def main(argv=None):
    a = parse_args(argv)
    return sweep(VERSIONS, make_args, CONFIGS,
                 ref_name="fp32_highest (parity)", flops_fn=flops,
                 bytes_fn=weight_bytes, iters=a.iters, device=a.device)


if __name__ == "__main__":
    main()
