"""Vocab-softmax kernel lab (dev/cuda/softmax_forward.cu pattern; the
reference's kernel5/kernel7 are online/register-tiled softmaxes over the
50257-wide logits row, train_gpt2.cu:208-263, :295-410), port of
llmc_paged_tpu/ops/dev/bench_softmax.py.

v0 is the plain version written out as max, exp and sum; v1 the
hand-written CUDA kernel ``softmax_rows`` (``csrc/softmax.cu``): a row
split over a thread-block cluster of ``cluster_size`` blocks, each slice
held in shared memory, read once and written once, the row's max and sum
exchanged through distributed shared memory (remote stores that complete
the receiver's mbarrier).

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
# within Hopper's 227 KB a block (a cluster of one block holds it whole)
MAX_V = (232448 - 128) // 4
# the largest cluster the kernel takes (Hopper's non-portable limit), and
# the largest the rule picks: at (8, 50304) a row over 8 blocks is faster
# than over 16 (PERF.md §6), the second exchange costing more than the
# halved slice saves
MAX_CLUSTER = 16
RULE_CLUSTER = 8
_KIND = {torch.float32: 0, torch.bfloat16: 1}   # the .cu enum


def cluster_size(B: int, sms: int, active_clusters) -> int:
    """The blocks a row is split over: the smallest power of two c with
    B * c >= ``sms`` (so that the rows fill the card), at most
    RULE_CLUSTER, halved while ``active_clusters(c)`` (how many clusters
    of c blocks the card holds at once) is below 1."""
    c = 1
    while c < RULE_CLUSTER and B * c < sms:
        c *= 2
    while c > 1 and active_clusters(c) < 1:
        c //= 2
    return c


def softmax_rows_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version: max, exp and sum over the last axis in f32, one
    rounding to x's dtype."""
    xf = x.float()
    e = torch.exp(xf - xf.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)


def softmax_rows(x: torch.Tensor, _cluster: int | None = None
                 ) -> torch.Tensor:
    """Softmax over the whole rows of x (B, V) f32/bf16, in f32, the
    result in x's dtype (the JAX lab's ``pallas_softmax_rows``). A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises. ``_cluster`` forces the cluster size (the card tests; the
    lab and its callers leave it to ``cluster_size``)."""
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
    c = _cluster
    if c is not None and (c < 1 or c > MAX_CLUSTER or c & (c - 1)):
        raise ValueError(f"cluster size {c} is not a power of two in "
                         f"[1, {MAX_CLUSTER}]")
    if c is None:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        c = cluster_size(B, sms,
                         lambda c: _active_clusters(x, out, V, c))
    fn = entry("softmax", "softmax_rows",
               [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    launch(fn, x.device, (_KIND[x.dtype], x.data_ptr(), out.data_ptr(), B,
                          V, c), "softmax_rows")
    LAUNCHES["softmax_rows"] += 1
    return out


def _active_clusters(x, out, V, c) -> int:
    """How many clusters of c blocks of the kernel that softmax_rows
    launches for (x, out) the card holds at once."""
    n = ctypes.c_int(0)
    fn = entry("softmax", "softmax_rows_clusters",
               [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    with torch.cuda.device(x.device):
        rc = fn(_KIND[x.dtype], x.data_ptr(), out.data_ptr(), V, c,
                ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"softmax_rows cluster query failed: CUDA error "
                           f"{rc}")
    return n.value


def make_args(B, V, device):
    g = torch.Generator(device=device).manual_seed(0)
    return (torch.randn(B, V, generator=g, device=device) * 4,)


VERSIONS = {
    "v0_max_exp_sum (plain)": softmax_rows_ref,
    # 1e-6 abs: a probability of a 50k-wide row is ~2e-5 on average, so
    # the harness's 1e-4 would pass a kernel that gets them all wrong
    "v1_cuda_cluster_row": (softmax_rows, {"atol": 1e-6, "rtol": 1e-5}),
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
