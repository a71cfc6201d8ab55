"""Validation loss / perplexity of a checkpoint at a serving dtype (port
of llmc_paged_tpu/eval.py).

The user-facing version of the quality gates the test suite applies
(INT8 / bf16 loss delta vs fp32 <= 0.05 — the north-star perplexity gate):
the reference's val-loss loop (train_gpt2.c:1185-1195) exposed as a CLI
with a dtype switch. Runs on the card; ``LLMC_PLATFORM=cpu`` selects the
CPU.

    python -m llmc_paged_tpu_torch.eval --checkpoint gpt2.bin \
        --data val.bin --dtype int8 --batches 16
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from llmc_paged_tpu_torch import formats, platform_device
from llmc_paged_tpu_torch.models import gpt2
from llmc_paged_tpu_torch.ops.int8 import quantize_params
from llmc_paged_tpu_torch.utils.dataloader import DataLoader


@torch.no_grad()
def evaluate(cfg, params, loader: DataLoader, batches: int) -> float:
    """Mean NLL over `batches` batches (loader is reset first)."""
    loader.reset()
    losses = [float(gpt2.loss_fn(params, *loader.next_batch(), cfg))
              for _ in range(batches)]
    return float(np.mean(losses))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="llmc_paged_tpu_torch.eval")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--data", required=True, help="raw int32 token stream")
    ap.add_argument("--dtype", choices=["float32", "bfloat16", "int8"],
                    default="float32")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batches", type=int, default=8)
    args = ap.parse_args(argv)

    device = platform_device()
    cfg, params_np = formats.read_checkpoint(args.checkpoint)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    params = gpt2.to_device(params_np, cfg, dtype, device=device)
    if args.dtype == "int8":
        params = quantize_params(params)

    loader = DataLoader(args.data, args.batch, args.seq_len)
    loss = evaluate(cfg, params, loader, args.batches)
    print(f"dtype={args.dtype} val loss {loss:.6f} ppl {math.exp(loss):.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
