"""Paged-attention kernel lab (dev/cuda/attention_forward.cu pattern:
naive reference, then the optimized versions, validated and swept), port
of llmc_paged_tpu/ops/dev/bench_paged_attention.py.

The versions run the port's normalized wrappers: at ps 128 the
single-query parts kernel and a divide, at ps 32 the normalized grid
kernel; the int8 version quantizes the pools with the port's
``quantize_pages`` inside the timed call, as the JAX lab does, and is
timed only (it differs from the float reference by the quantization).

Run: python -m llmc_paged_tpu_torch.ops.dev.bench_paged_attention
     [--device cpu] [--iters N]
"""

from __future__ import annotations

import torch

from llmc_paged_tpu_torch.kv.layouts import quantize_pages
from llmc_paged_tpu_torch.ops.dev.harness import parse_args, sweep
from llmc_paged_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_quant,
    paged_decode_attention_ref,
)


def make_args(B, NH, HS, P, ps, pps, device):
    g = torch.Generator(device=device).manual_seed(0)
    q = torch.randn(B, NH, HS, generator=g, device=device)
    k = torch.randn(P, NH, HS, ps, generator=g, device=device)
    v = torch.randn(P, NH, HS, ps, generator=g, device=device)
    tables = torch.randperm(P, generator=g, device=device)[: B * pps]
    tables = tables.reshape(B, pps).to(torch.int32)
    lengths = torch.randint(ps, pps * ps + 1, (B,), generator=g,
                            device=device, dtype=torch.int32)
    return q, k, v, tables, lengths


def _quant(q, k, v, tables, lengths):
    kq, ks = quantize_pages(k)
    vq, vs = quantize_pages(v)
    return paged_decode_attention_quant(q, kq, vq, ks, vs, tables, lengths)


VERSIONS = {
    "v0_gather_ref (naive)": paged_decode_attention_ref,
    "v1_cuda_flash": paged_decode_attention,
    "v2_cuda_flash_int8kv": (_quant, {"validate": False}),
}


def kv_bytes(B, NH, HS, P, ps, pps):
    return 2 * B * NH * pps * ps * HS * 4


CONFIGS = [
    # ps=128 rows run the parts kernel (and a divide); the ps=32 row the
    # normalized grid kernel
    (8, 12, 64, 32, 128, 4),     # GPT-2 124M decode, 512-ctx
    (8, 12, 64, 64, 128, 8),     # 1024-ctx
    (16, 12, 64, 144, 128, 8),   # bigger batch
    (8, 25, 64, 32, 128, 4),     # 1.5B head count
    (8, 12, 64, 128, 32, 16),    # grid kernel (ps=32)
]


def main(argv=None):
    a = parse_args(argv)
    return sweep(VERSIONS, make_args, CONFIGS,
                 ref_name="v0_gather_ref (naive)", bytes_fn=kv_bytes,
                 iters=a.iters, device=a.device)


if __name__ == "__main__":
    main()
