"""The training loop and its CLI (port of llmc_paged_tpu/train.py): the
capability of the reference's CPU trainers (train_gpt2.c main
:1148-1252 and the full-depth train_scratch.c), as a torch.autograd +
AdamW loop on one device.

Loop structure mirrors the reference main: every `val_every` steps a val
loss over `val_batches` batches (train_gpt2.c:1185-1195), every
`sample_every` steps an autoregressive sample (:1198-1230), otherwise a
timed AdamW step (:1233-1241, gpt2_update hyperparameters :922-948).
Checkpoints can be written back in the byte-exact reference format via
formats.write_checkpoint. Runs on the card; ``LLMC_PLATFORM=cpu`` selects
the CPU. fp32 products run as PyTorch's default leaves them, TF32 off
(the port's parity mode).

Data parallelism (``train(data_parallel=N)``, ``--data-parallel N``):
one process a rank in a torch.distributed group of N ranks (torchrun;
NCCL on the cards, gloo with ``LLMC_PLATFORM=cpu``), each on its rows
of every global batch, the gradients averaged by one all-reduce a step
(``parallel/sharding.py::make_dp_train_step``); only rank 0 logs and
saves.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from llmc_paged_tpu_torch import formats, platform_device, resolve_device
from llmc_paged_tpu_torch.config import GPT2Config
from llmc_paged_tpu_torch.eval import evaluate
from llmc_paged_tpu_torch.models import gpt2
from llmc_paged_tpu_torch.parallel import sharding
from llmc_paged_tpu_torch.sampler import Sampler
from llmc_paged_tpu_torch.tokenizer import Tokenizer
from llmc_paged_tpu_torch.utils.dataloader import DataLoader


def train(cfg: GPT2Config, params, train_loader: DataLoader,
          val_loader: Optional[DataLoader] = None, steps: int = 40,
          lr: float = 1e-4, weight_decay: float = 0.0,
          val_every: int = 10, val_batches: int = 5,
          sample_every: int = 20, sample_tokens: int = 16,
          tokenizer: Optional[Tokenizer] = None, seed: int = 1337,
          data_parallel: int = 1, log=print):
    """Run the training loop on the params' device; returns (params, list
    of per-step losses). The params returned are new leaf tensors: the
    caller's are left as they are.

    AdamW is ``optax.adamw``'s math (decoupled decay on every leaf, no
    parameter groups); torch decays p before the Adam step where optax
    folds lr·wd·p into the update, equal in exact arithmetic.

    ``data_parallel=N > 1`` runs in each rank of a process group of N
    ranks: rank 0's params are broadcast, each rank takes its rows of
    every batch, and only rank 0 calls ``log``."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    dev = params["wpe"].device
    opt = torch.optim.AdamW(params.values(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay)
    dp_step = None
    if data_parallel > 1:
        mesh = sharding.make_mesh(model=1, data=data_parallel)
        dp_step, shard_batch, replicate = sharding.make_dp_train_step(
            cfg, mesh, opt)
        replicate(params)
        if mesh.rank != 0:
            log = _quiet

    sampler = Sampler(seed)
    losses = []
    for step in range(steps):
        if val_loader is not None and step % val_every == 0:
            val_loss = evaluate(cfg, params, val_loader, val_batches)
            log(f"step {step}: val loss {val_loss:.6f}")
        if sample_every and step % sample_every == 0 and step > 0:
            toks = [50256 % cfg.vocab_size]  # GPT-2 EOT when vocab allows
            for _ in range(sample_tokens):
                ctx = toks[-cfg.max_seq_len:]
                logits = gpt2.forward(params, torch.tensor([ctx]), cfg)
                probs = torch.softmax(logits[0, -1].float(), dim=-1)
                toks.append(sampler.sample(probs.cpu().numpy()))
            text = tokenizer.decode_string(toks) if tokenizer else str(toks)
            log(f"step {step} sample: {text!r}")
        x, y = (torch.from_numpy(a).to(dev) for a in train_loader.next_batch())
        t0 = time.monotonic()
        if dp_step is not None:
            loss = float(dp_step(params, *shard_batch(x, y)))
        else:
            opt.zero_grad(set_to_none=True)
            loss = gpt2.loss_fn(params, x, y, cfg)
            loss.backward()
            opt.step()
            loss = float(loss.detach())
        losses.append(loss)
        log(f"step {step}: train loss {loss:.6f} "
            f"(took {(time.monotonic() - t0) * 1e3:.2f} ms)")
    return {k: v.detach() for k, v in params.items()}, losses


def _quiet(*_):
    pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="llmc_paged_tpu_torch.train")
    ap.add_argument("--checkpoint", default=None,
                    help="init from a model .bin; omit for from-scratch")
    ap.add_argument("--train-data", required=True)
    ap.add_argument("--val-data", default=None)
    ap.add_argument("--tokenizer", default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--weight-decay", type=float, default=0.0)
    ap.add_argument("--val-every", type=int, default=10)
    ap.add_argument("--sample-every", type=int, default=20)
    ap.add_argument("--data-parallel", type=int, default=1)
    ap.add_argument("--save", default=None,
                    help="write the trained model as a reference-format .bin")
    # from-scratch model shape (ignored with --checkpoint)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--channels", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=50257)
    ap.add_argument("--max-seq-len", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=1337)
    args = ap.parse_args(argv)
    plat = platform_device()
    rank = 0
    if args.data_parallel > 1:
        rank = sharding.join_ranks(ap, "--data-parallel", args.data_parallel,
                                   plat, "llmc_paged_tpu_torch.train")
        if plat is None:
            plat = f"cuda:{sharding.local_rank()}"
    device = resolve_device(plat)
    if args.checkpoint:
        cfg, params_np = formats.read_checkpoint(args.checkpoint)
        params = gpt2.to_device(params_np, cfg, device=device)
    else:
        cfg = GPT2Config(max_seq_len=args.max_seq_len, vocab_size=args.vocab,
                         num_layers=args.layers, num_heads=args.heads,
                         channels=args.channels)
        params = gpt2.init_params(
            cfg, torch.Generator(device).manual_seed(args.seed),
            device=device)

    train_loader = DataLoader(args.train_data, args.batch, args.seq_len)
    val_loader = DataLoader(args.val_data, args.batch, args.seq_len) \
        if args.val_data else None
    tok = Tokenizer.from_file(args.tokenizer) if args.tokenizer else None

    params, _ = train(cfg, params, train_loader, val_loader,
                      steps=args.steps, lr=args.lr,
                      weight_decay=args.weight_decay,
                      val_every=args.val_every,
                      sample_every=args.sample_every, tokenizer=tok,
                      seed=args.seed, data_parallel=args.data_parallel)

    if args.save and rank == 0:
        host = {k: v.cpu().numpy() for k, v in params.items()}
        formats.write_checkpoint(args.save, cfg, host, "float32")
        print(f"saved {args.save}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
