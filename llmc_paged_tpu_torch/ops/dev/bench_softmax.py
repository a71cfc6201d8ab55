"""Vocab-softmax kernel lab (dev/cuda/softmax_forward.cu pattern; the
reference's kernel5/kernel7 are online/register-tiled softmaxes over the
50257-wide logits row, train_gpt2.cu:208-263, :295-410), port of
llmc_paged_tpu/ops/dev/bench_softmax.py.

v0 is the plain version written out as max, exp and sum; v1 the
hand-written CUDA kernel ``softmax_rows`` (``csrc/softmax.cu``): one
block a row, the row held in shared memory, read once and written once.

Run: python -m llmc_paged_tpu_torch.ops.dev.bench_softmax [--device cpu]
     [--iters N]
"""

from __future__ import annotations

import ctypes

import torch

from llmc_paged_tpu_torch.ops._build import check_operand, entry, launch
from llmc_paged_tpu_torch.ops.dev.harness import parse_args, sweep

# launches of the CUDA kernel (a plain int; reset by callers)
LAUNCHES = {"softmax_rows": 0}
# the row in shared memory (f32) beside the kernel's 128 static bytes,
# within Hopper's 227 KB a block
MAX_V = (232448 - 128) // 4
_KIND = {torch.float32: 0, torch.bfloat16: 1}   # the .cu enum


def softmax_rows_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version: max, exp and sum over the last axis in f32, one
    rounding to x's dtype."""
    xf = x.float()
    e = torch.exp(xf - xf.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)


def softmax_rows(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the whole rows of x (B, V) f32/bf16, in f32, the
    result in x's dtype (the JAX lab's ``pallas_softmax_rows``). A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    if x.device.type == "cpu":
        return softmax_rows_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"no softmax_rows route for device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be (B, V), not {tuple(x.shape)}")
    B, V = x.shape
    if V > MAX_V:
        raise ValueError(f"V = {V} exceeds the kernel's shared memory "
                         f"({MAX_V} f32 values)")
    check_operand("x", x, tuple(_KIND), (B, V), x.device)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    fn = entry("softmax", "softmax_rows",
               [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p])
    launch(fn, x.device, (_KIND[x.dtype], x.data_ptr(), out.data_ptr(), B,
                          V), "softmax_rows")
    LAUNCHES["softmax_rows"] += 1
    return out


def make_args(B, V, device):
    g = torch.Generator(device=device).manual_seed(0)
    return (torch.randn(B, V, generator=g, device=device) * 4,)


VERSIONS = {
    "v0_max_exp_sum (plain)": softmax_rows_ref,
    # 1e-6 abs: a probability of a 50k-wide row is ~2e-5 on average, so
    # the harness's 1e-4 would pass a kernel that gets them all wrong
    "v1_cuda_row_in_smem": (softmax_rows, {"atol": 1e-6, "rtol": 1e-5}),
}


def bytes_moved(B, V):
    return 2 * B * V * 4


CONFIGS = [
    (8, 50304),    # decode logits rows (124M, 128-padded V)
    (64, 50304),
    (8, 51200),    # 2048-padded vocab
]


def main(argv=None):
    a = parse_args(argv)
    return sweep(VERSIONS, make_args, CONFIGS,
                 ref_name="v0_max_exp_sum (plain)", bytes_fn=bytes_moved,
                 iters=a.iters, device=a.device)


if __name__ == "__main__":
    main()
