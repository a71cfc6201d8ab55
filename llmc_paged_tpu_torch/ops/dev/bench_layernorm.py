"""LayerNorm kernel lab (dev/cuda/layernorm_forward.cu pattern), port of
llmc_paged_tpu/ops/dev/bench_layernorm.py.

v0 is the port's serving path, ``ops/layers.layernorm``: plain PyTorch,
a handful of kernels a call. v1 is the hand-written CUDA row kernel
``layernorm_rows`` (``csrc/layernorm.cu``, one warp a row), the
counterpart of the JAX lab's Pallas row-blocked kernel.

Run: python -m llmc_paged_tpu_torch.ops.dev.bench_layernorm [--device cpu]
     [--iters N]
"""

from __future__ import annotations

import ctypes

import torch

from llmc_paged_tpu_torch.ops._build import check_operand, entry, launch
from llmc_paged_tpu_torch.ops.dev.harness import parse_args, sweep
from llmc_paged_tpu_torch.ops.layers import LN_EPS, layernorm

# launches of the CUDA kernel (a plain int; reset by callers)
LAUNCHES = {"layernorm_rows": 0}
MAX_C = 2048                        # 64 values a lane (the .cu's instances)
_KIND = {torch.float32: 0, torch.bfloat16: 1}   # the .cu enum


def layernorm_rows(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the rows of x (R, C) f32/bf16 with w, b (C,) f32:
    statistics in f32, the result in x's dtype (the JAX lab's
    ``pallas_layernorm``). A CPU tensor takes the plain version
    (``ops/layers.layernorm``); a CUDA tensor launches the kernel or
    raises."""
    if x.device.type == "cpu":
        return layernorm(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"no layernorm_rows route for device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be (R, C), not {tuple(x.shape)}")
    R, C = x.shape
    if C > MAX_C:
        raise ValueError(f"C = {C} exceeds the kernel's {MAX_C}")
    check_operand("x", x, tuple(_KIND), (R, C), x.device)
    check_operand("w", w, (torch.float32,), (C,), x.device)
    check_operand("b", b, (torch.float32,), (C,), x.device)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    fn = entry("layernorm", "layernorm_rows",
               [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
               + [ctypes.c_float, ctypes.c_void_p])
    launch(fn, x.device, (_KIND[x.dtype], x.data_ptr(), w.data_ptr(),
                          b.data_ptr(), out.data_ptr(), R, C, LN_EPS),
           "layernorm_rows")
    LAUNCHES["layernorm_rows"] += 1
    return out


def make_args(R, C, device):
    g = torch.Generator(device=device).manual_seed(0)
    return tuple(torch.randn(*shape, generator=g, device=device)
                 for shape in ((R, C), (C,), (C,)))


VERSIONS = {
    "v0_torch_ops (plain)": layernorm,
    # f32 statistics on both sides: only the order of the sums differs
    "v1_cuda_warp_row": (layernorm_rows, {"atol": 1e-5, "rtol": 1e-5}),
}


def bytes_moved(R, C):
    return 2 * R * C * 4


CONFIGS = [
    (8, 768),        # decode step rows (124M)
    (1024, 768),     # one prefill row-batch
    (8192, 768),     # large prefill
    (256, 1600),     # 1.5B rows
]


def main(argv=None):
    a = parse_args(argv)
    return sweep(VERSIONS, make_args, CONFIGS,
                 ref_name="v0_torch_ops (plain)", bytes_fn=bytes_moved,
                 iters=a.iters, device=a.device)


if __name__ == "__main__":
    main()
