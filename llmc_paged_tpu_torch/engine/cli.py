"""Command-line entry point (port of llmc_paged_tpu/engine/cli.py): the
role of the reference's main() functions (infer.c:5-144,
cached_infer.c:911-1052, paged_infer.c:953-1101), with the same flags,
defaults and ``--json`` payload ``{"stats", "tokens"}`` as the JAX
package's CLI.

Example (paged decode, 8 concurrent sequences, prompts from a token file):
    python -m llmc_paged_tpu_torch.engine.cli \\
        --checkpoint model.bin --tokenizer tok.bin --data tokens.bin \\
        --mode paged --batch 8 --prompt-size 32 --max-new 50

Serving over HTTP instead (concurrent connections batch continuously):
    python -m llmc_paged_tpu_torch.engine.cli \
        --checkpoint model.bin --data tokens.bin --batch 8 \
        --device-sampling --top-k 40 --warmup --serve 8000

It runs on the card. ``LLMC_PLATFORM=cpu`` selects the CPU (the plain
PyTorch versions of the kernels); any other value raises. ``--profile
DIR`` writes a torch.profiler Chrome trace of the run to
DIR/trace.json (under ``--mesh-model``, rank r > 0 to
DIR/trace_rank{r}.json).

Tensor parallelism over N ranks (``--mesh-model N``): one process a rank
under torchrun, each on its card (``cuda:LOCAL_RANK``, NCCL) or, with
``LLMC_PLATFORM=cpu``, on the CPU (gloo); every rank runs the same
schedule and only rank 0 prints:
    torchrun --nproc-per-node 2 -m llmc_paged_tpu_torch.engine.cli \
        --checkpoint model.bin --data tokens.bin --batch 8 --mesh-model 2
With ``--serve PORT`` every rank serves (with ``--warmup``, each warms
up first): rank 0 binds the port and answers, the others follow it
(engine/http_server.py); stopping torchrun (SIGINT or SIGTERM) stops
every rank. A plain start with N > 1 exits naming the torchrun command.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from llmc_paged_tpu_torch import formats, platform_device
from llmc_paged_tpu_torch.config import EngineConfig, PageConfig
from llmc_paged_tpu_torch.engine.engine import InferenceEngine
from llmc_paged_tpu_torch.engine.scheduler import Request
from llmc_paged_tpu_torch.parallel.sharding import join_ranks
from llmc_paged_tpu_torch.sampler import Sampler
from llmc_paged_tpu_torch.tokenizer import Tokenizer


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="llmc_paged_tpu_torch",
                                description="paged GPT-2 inference on an "
                                            "NVIDIA GPU (PyTorch + CUDA)")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--data", required=True,
                   help="raw int32 token stream; prompts are slices of it "
                        "(the reference seeds prompts from the val set)")
    p.add_argument("--mode", choices=["none", "dense", "paged"],
                   default="paged")
    p.add_argument("--batch", type=int, default=1,
                   help="concurrent sequences (paged mode only)")
    p.add_argument("--prompt-size", type=int, default=32)
    p.add_argument("--max-new", type=int, default=50)
    p.add_argument("--window", type=int, default=None,
                   help="sliding-window size for reference-parity decode "
                        "(infer.c/cached_infer.c/paged_infer.c T)")
    p.add_argument("--page-size", type=int, default=32)
    p.add_argument("--num-pages", type=int, default=128)
    p.add_argument("--pages-per-seq", type=int, default=32)
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--top-k", type=int, default=None,
                   help="top-k sampling (train_gpt2.py generate semantics)")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--dtype", choices=["float32", "bfloat16", "int8"],
                   default="float32",
                   help="serving weight dtype (fp32 = exact parity)")
    p.add_argument("--kv-dtype", choices=["float32", "bfloat16", "int8"],
                   default=None,
                   help="KV page dtype (default: same as --dtype)")
    p.add_argument("--activation-dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="non-quantized-leaf dtype for --dtype int8")
    p.add_argument("--spec-k", type=int, default=0,
                   help="speculative decoding: verify K tokens per device "
                        "step (carried token + K-1 device n-gram drafts), "
                        "greedy-exact; 0 = off. Requires --greedy, no "
                        "--window")
    p.add_argument("--spec-ngram", type=int, default=3,
                   help="n-gram length for speculative drafting")
    p.add_argument("--prefix-cache", action="store_true",
                   help="content-addressed prefix caching: full prompt "
                        "pages shared across sequences, suffix-only "
                        "prefill. Requires no --window")
    p.add_argument("--stop-token", type=int, action="append", default=[],
                   metavar="ID",
                   help="stop generation after this token id appears "
                        "(kept as the last token; repeatable). Default: "
                        "run to --max-new, the reference's fixed-length "
                        "behavior")
    p.add_argument("--warmup", action="store_true",
                   help="with --serve: run every serving path once (the "
                        "CUDA kernels build, the allocator warms) BEFORE "
                        "binding the port, so no tenant pays for it")
    p.add_argument("--no-logprobs", action="store_true",
                   help="reject logprobs requests")
    p.add_argument("--max-pending", type=int, default=0, metavar="N",
                   help="backpressure: reject submissions (HTTP 503) "
                        "while N live requests are in flight; 0 = "
                        "unbounded")
    p.add_argument("--serve", type=int, default=0, metavar="PORT",
                   help="serve over HTTP on 127.0.0.1:PORT instead of "
                        "decoding --data prompts: POST /generate "
                        '{"prompt": [ids], "max_new_tokens": N}; '
                        "concurrent connections batch continuously")
    p.add_argument("--device-sampling", action="store_true",
                   help="sample on the device inside decode chunks (fast "
                        "non-greedy serving; not bit-parity with the C "
                        "xorshift sampler)")
    p.add_argument("--mesh-model", type=int, default=0,
                   help="tensor-parallel ways over heads (0 = off): one "
                        "process a rank under torchrun")
    p.add_argument("--no-kernel", action="store_true",
                   help="plain PyTorch attention instead of the CUDA "
                        "kernels")
    p.add_argument("--json", action="store_true",
                   help="emit machine-readable stats")
    p.add_argument("--log-every", type=int, default=0,
                   help="emit a structured scheduler-state line every N "
                        "iterations (print_state parity, machine-readable)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the run (CPU, and "
                        "CUDA on the card) to DIR/trace.json, a Chrome "
                        "trace (chrome://tracing, Perfetto); under "
                        "--mesh-model, rank r > 0 writes "
                        "DIR/trace_rank{r}.json")
    return p


def start_profile(device):
    """A started torch.profiler session over the CPU and, on the card,
    CUDA activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def stop_profile(prof, out_dir: str, rank: int = 0) -> str:
    """Stop ``prof`` and write its Chrome trace to out_dir/trace.json
    (rank r > 0 of a mesh: out_dir/trace_rank{r}.json); returns the
    path."""
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json" if rank == 0
                        else f"trace_rank{rank}.json")
    prof.export_chrome_trace(path)
    return path


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    device = platform_device()
    rank = (join_ranks(parser, "--mesh-model", args.mesh_model, device,
                       "llmc_paged_tpu_torch.engine.cli")
            if args.mesh_model else 0)
    cfg, params = formats.read_checkpoint(args.checkpoint)
    tok = Tokenizer.from_file(args.tokenizer) if args.tokenizer else None
    stream = formats.read_token_stream(args.data)

    page = PageConfig(page_size=args.page_size, num_pages=args.num_pages,
                      max_seqs=max(args.batch, 8),
                      pages_per_seq=args.pages_per_seq,
                      kv_dtype=args.kv_dtype or args.dtype,
                      prefix_cache=args.prefix_cache)
    econf = EngineConfig(cache_mode=args.mode, page=page,
                         param_dtype=args.dtype,
                         activation_dtype=args.activation_dtype,
                         max_batch=args.batch, seed=args.seed,
                         greedy=args.greedy, top_k=args.top_k,
                         temperature=args.temperature,
                         device_sampling=args.device_sampling,
                         spec_k=args.spec_k, spec_ngram=args.spec_ngram,
                         stop_tokens=tuple(args.stop_token),
                         serve_logprobs=not args.no_logprobs,
                         log_every=args.log_every,
                         mesh_shape={"model": args.mesh_model}
                         if args.mesh_model else None)
    engine = InferenceEngine(params, cfg, econf, device=device,
                             use_kernel=not args.no_kernel)

    if args.serve:
        from llmc_paged_tpu_torch.engine.http_server import serve_http
        if args.warmup:             # on every rank: its collectives pair
            t = engine.warmup(window=args.window)
            if rank == 0:
                print(f"warmup: {t}", flush=True)
        serve_http(engine, port=args.serve, tokenizer=tok,
                   max_pending=args.max_pending or None,
                   window=args.window)
        return 0

    def sampler():
        return Sampler(args.seed, args.greedy, top_k=args.top_k,
                       temperature=args.temperature)

    prof = start_profile(engine.device) if args.profile else None
    t0 = time.monotonic()
    try:
        if args.mode == "paged" and args.batch > 1:
            reqs = []
            for b in range(args.batch):
                lo = (b * args.prompt_size) % max(
                    1, len(stream) - args.prompt_size)
                prompt = stream[lo: lo + args.prompt_size].tolist()
                reqs.append(Request(rid=b, prompt=prompt,
                                    max_new_tokens=args.max_new))
            done = engine.run(reqs, window=args.window, sampler=sampler())
            outs = {r.rid: r.tokens for r in done}
        else:
            prompt = stream[: args.prompt_size].tolist()
            outs = {0: engine.generate(prompt, args.max_new,
                                       window=args.window,
                                       sampler=sampler())}
        stats = dict(engine.stats)
        dt = time.monotonic() - t0
    finally:
        # stop even on failure, so a --profile run debugging that very
        # failure still gets its trace
        if prof is not None:
            stop_profile(prof, args.profile, rank)

    if rank != 0:
        return 0            # every rank holds the same tokens
    stats.update(mode=args.mode, batch=args.batch, wall_s=dt,
                 total_new_tokens=args.max_new * len(outs))
    if args.json:
        print(json.dumps({"stats": stats,
                          "tokens": {k: v for k, v in sorted(outs.items())}}))
    else:
        for rid in sorted(outs):
            toks = outs[rid]
            text = tok.decode_string(toks) if tok else ""
            print(f"--- sequence {rid} ({len(toks)} tokens) ---")
            print(text if tok else toks)
        print(f"generated {stats['total_new_tokens']} tokens in {dt:.2f}s "
              f"({stats['total_new_tokens'] / dt:.1f} tok/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
