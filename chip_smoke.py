#!/usr/bin/env python3
"""Smoke run of the torch port (llmc_paged_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--parallel-only | --mellum-only]

Phases (any failed check raises, and the script exits non-zero):
  1. device: name, power limit, torch/CUDA versions; TF32 off;
  2. build: the nine CUDA kernel sources in the checkout, one nvcc per
     source, all started together, and beside them the native block
     manager's host library (csrc/block_manager.cpp, g++);
  3. kernels vs plain versions: the flash-decode parts kernel, the
     multi-query parts kernel and the normalized grid kernel against their
     plain PyTorch versions for
     f32, bf16 and int8 pools at the GPT-2 124M head shapes (q f32 over
     f32 pools, bf16 over bf16 and int8 pools as the headline sends it,
     and f32 over int8 pools), with ragged
     and zero lengths, window starts, ps=32, B*pps > 4096 and a long
     case (8 live pages of 128, lengths 900-1024); the multi-query kernel
     also at the spec-verify shape (KQ=4), KQ=1 and suffix shapes (KQ=32,
     and KQ=96 above the TPU kernel's 64); the grid
     kernel at the CLI's shape (B=8, ps=32, pps=32, P=128, lengths
     65-128), at the probe's 10 live pages of 32 and at ps 8, 16, 30
     (the scalar path) and 96 with zero, start >= length and windowed
     rows; times from CUDA events beside the bound, and the three
     kernels' beside their times before their redesign for Hopper; the
     grid kernel's 8-warp blocks timed against a 4-warp instance of the
     same template (built here);
  4. engine, headline config: GPT-2 124M (seeded random weights) served
     by InferenceEngine.run with int8 weights, int8 KV, bf16 activations,
     a bf16 prefill copy, page_size 128 and greedy 16-token chunks;
     8 requests of 128-token prompts, 128 new tokens each; no flash
     launch (T = 128 stays dense, as in the JAX package);
  5. fp32 engine, kernel route vs plain route: token streams, and the
     logits of one decode_step_paged on both routes;
  6. loaded queue: 16 mixed-length requests through 8 slots with a pool
     small enough to force preemption;
  7. speculative serving: the headline configuration with spec_k=4 and
     3-gram prompt lookup, 8 prompts that repeat a 32-token segment 4
     times, 128 new tokens each; multi-query launches = L x verify
     steps; at fp32 the spec engine against the plain engine;
  8. prefix caching: GPT-2 124M, pages_per_seq 4, 40 pages, 8 requests
     sharing a 256-token system prompt (2 full pages) with own 32-token
     suffixes, one engine run twice (int8 headline and fp32): run 2
     adopts 16 pages, multi-query launches = L x suffix prefills,
     fp32 streams against a no-prefix engine; one prefill_suffix_paged
     against prefill_paged;
  9. the CLI (engine/cli.py main, in process): a GPT-2 124M checkpoint
     (seeded random weights), a token stream and byte_fallback_table(50257)
     written to a temporary directory; the reference defaults (page size
     32, 128 pages, 32 pages a sequence, fp32, seed 1337) with 8 rows of
     64-token prompts, 64 new tokens, top-k 40 through the xorshift
     sampler; grid launches = L x single-token steps; the host top-k
     sampler timed alone; the fp32 streams against --no-kernel; again
     with --dtype int8 --activation-dtype bfloat16;
 10. modes: --mode none, dense and paged at --batch 1, fp32, greedy, 32
     new tokens: the three streams are identical;
 11. the kernel lab (llmc_paged_tpu_torch/ops/dev) in process: the sweeps
     of bench_int8_matmul (--set all), bench_layernorm, bench_softmax,
     bench_matmul, bench_paged_attention, bench_fusion, lab_flatwide and
     lab_full_pool, every validated version held against its reference;
     int8_matmul in both modes beside the serving int8 linear and the bf16
     dense product at every bench_int8_matmul shape;
     the launches of int8_matmul, layernorm_rows, softmax_rows,
     flatwide_parts and the two full-pool wrappers equal the calls the
     harness made (the full tables go to build/chip_smoke_lab.txt); then
     each of those kernels' time and its plain version's from the
     sweeps, at some of the lab's shapes, beside its bound and one
     PyTorch call of the same function (library_ms), flatwide beside the
     parts kernel (at the 124M and 1.5B head counts) and the full-pool
     kernel beside the grid kernel on the same tensors; the launch floor
     under the same timer (an empty kernel queued back to back), the
     softmax cluster size the rule picks at each lab shape, and softmax
     at clusters of 1, 4, 8 and 16 blocks at (8, 50304);
 12. the decode-step probe (ops/dev/probe_decode.py main, in process):
     every suite at --model 124m (the prefill at T 128, 256, 896 and
     1024, a dense line beside each flash one), then the GEMV and kernel
     suites at
     --model 1558m; one log line a suite with its seconds (the full
     tables go to build/chip_smoke_probe.txt); the paged-attention
     launches equal the calls the probe made; then one torch.profiler
     trace of the grid kernel's CLI-shape call from phase 3 against the
     timer, and the CLI's --profile on a tiny checkpoint (its Chrome
     trace holds CPU operator events and the card's parts kernels),
     read by ops/dev/dump_chunk_trace.read_trace (busy ms, idle share,
     top kernels, longest gaps); last, ops/dev/dump_chunk_trace at the
     JAX tool's defaults but chunks of 16 (124M, prompt 128, pool-mult
     4, B 8; the tool's 32 doubles the traces' time) in int8 and
     float32: the per-step and per-chunk census of operators
     on a pool plane, parts kernels in the trace = L x steps, and the
     chunk trace's idle share (profiler sessions come last, so that no
     host-timed phase follows one).
 13. (run after phase 10, before phases 11 and 12, so that no host-timed
     phase follows a profiler session) the serving front on the card:
     GPT-2 124M at full width, ps 128, max_batch 8, device sampling.
     An fp32 engine (TF32 off) served through HttpServingFront on
     127.0.0.1: greedy rows with logprobs, penalized greedy rows and a
     top_k=1 row give exactly the tokens of the engine's batch run();
     logprobs within 2e-3 of a dense forward's log_softmax; every token
     of a top-40 row at or above its position's 40th logit (-1e-3); the
     same seed twice gives the same streams; a stream cancelled by its
     client's disconnect is a prefix of its uncancelled stream and its
     pages free. The int8 headline engine (int8 weights and KV, bf16
     activations, top-k 40, temperature 0.8, chunks of 16): warmup(),
     then 8 concurrent HTTP requests of 128 + 128 tokens (greedy with
     logprobs, penalized, streams, per-request top_k/temperature):
     tok/s, p50 TTFT, launches = L x chained steps, no single step;
     host ms a chunk step of a batch run beside phase 4's greedy chain;
     0 synchronizing CUDA calls in one bare device-sampled link.
 14. (run after phase 13, before phases 11 and 12) the long-prompt bf16
     prefill through the flash kernel (csrc/flash_attention.cu): the
     kernel against its plain version (2^-7 |plain| + 2e-3) and the f32
     dense attention (2e-2) at (B, NH, T) = (1, 12, 256), (8, 12, 896),
     (8, 12, 1024), (8, 25, 896) and (2, 25, 1024), on contiguous heads
     and on the views of one qkv buffer (the output's (B, T, C) reshape a
     view), timed on both; on the qkv views, as the main path sends them,
     beside its plain version, the dense bf16 route, SDPA's flash backend
     (the yardstick, never called by the port) and its bound; what it compiles to (ops/dev/sass_report.py: registers, shared
     memory, spills; HGMMA > 0, HMMA = 0, UTMALDG > 0); its refusals;
     0 flash launches for an fp32 and a use_kernel=False prefill at
     T = 896; a GPT-2 124M prefill of 8 x 896 (bf16 weights, int8 pool)
     no further from the f32 prefill than the dense route is (x 1.25 +
     1e-3); the long-context engine (int8, bf16 prefill copy, pps 9,
     8 x (896 + 128), greedy) on three routes (the kernel route, a
     dense prefill beside the decode kernels, use_kernel=False): flash
     launches = L x prefill waves on the first, 0 on the others, TTFT,
     tok/s and the device ms of each prefill wave (CUDA events around
     prefill_paged); at 1558M a prefill of 8 x 896 (48 launches, ms a call on
     both routes) and the engine with 32 new tokens on the three routes.
 15. (run after phase 14, before phases 11 and 12) evaluation and
     single-device training (eval.py, train.py, utils/dataloader.py), a
     path with no hand-written kernel (every wrapper's launches stay 0):
     (a) the tiny config (L=2, NH=4, C=128, V=257, T=64, B=4), 5 AdamW
     steps on one batch on the card (fp32, TF32 off) and on the CPU from
     the same seeded params: losses within 1e-4, step-0 grads within
     rtol 1e-4 / atol 1e-6; (b) GPT-2 124M at full width, train() 6
     steps at B=4, T=1024 on one repeated batch (ms a step, tok/s, peak
     memory), then evaluate() in fp32, bf16 and int8 (|delta| <= 0.05);
     (c) the tiny config of tests/test_quant_trained.py (T=128, B=8)
     trained on SURVEY.md + docs/layernorm.md (byte tokens, encoded here
     as tools/prepro_text.py does) for 300 steps (+300 while val >= 3.2):
     val < 3.2 and the int8 and bf16 val losses within 0.05 of fp32;
     (d) python -m llmc_paged_tpu_torch.train from scratch on the card
     (--val-every, --sample-every, --save), then python -m
     llmc_paged_tpu_torch.eval on the saved checkpoint in three dtypes,
     the three processes at once.
 16. (run after phase 15, before phases 11 and 12) the native block
     manager (kv/native.py over csrc/block_manager.cpp) under the engine
     against the Python one, the managers' methods wrapped with a host
     clock on the instance: (a) the library's build seconds; (b) phase
     4's engine with native_manager False, True, True, False in turns:
     equal streams, tok/s, the t_* buckets and manager ms a step; (c)
     phase 9's settings (ps 32, fp32, seed 1337, top-k 40, host
     sampling), native against Python: equal streams, host and manager
     ms a step; (d) phase 6's preempting queue: equal streams,
     preemptions (> 0) and peak pages; (e) phase 8's prefix caching, a
     cold and an adopting run: equal streams and prefix stats on the
     native prefix manager; (f) native_manager=None builds native
     managers (kv.native.make_block_manager wrapped).
 17. (run after phase 16, before phases 11 and 12) tensor and data
     parallelism (llmc_paged_tpu_torch/parallel/): GPT-2 124M at full
     width, weights drawn on the CPU from one seeded torch.Generator in
     every process, served at phase 4's configuration (int8 weights and
     KV, ps 128, bf16 activations, bf16 prefill copy, 8 x (128 + 128),
     chunks of 16) by rank processes (parallel/mp_dryrun.RankPool; the
     kernels built in phase 2 load in each rank). (a) two ranks sharing
     the card over gloo (6 heads a rank); (b) where the machine has two
     cards or more, min(4, cards) ranks over NCCL, a card each (on one
     card it prints that it did not run). Each leg: the TP streams equal
     a single-rank engine's in this process, or part only at a near-tie:
     where the single-rank run's two top logits at that step lie within
     max(1e-4, twice the two runs' logit noise), the noise being the
     largest difference of their recorded top-two logits while their
     contexts were the same, itself within 0.017 on the decode steps
     and 0.032 on the prefill wave for the int8 headline (bf16 prefill
     copy, bf16-rounded activations; about twice the largest seen) and
     1e-4 at fp32 (margins and noise printed); p50_ttft_s, the prefill
     wave's device ms (CUDA events around prefill_paged), and each
     rank's weights on the card and peak allocated memory, beside one
     rank's; likewise an fp32 run (TF32 off, 32 new
     tokens), and fp32 spec_k=4 (4 repeated prompts) and prefix-cache
     (phase 8's prompts, two runs) runs against plain TP greedy; parts
     launches = L x decode steps on every rank, 2L + 1 all-reduces and
     one all-gather a forward; every rank's int8 and f32 parts kernels
     at its local heads against their plain versions (phase 3's
     tolerance); the TP prefill's row-parallel product (a bf16 GEMM with
     an f32 output) against the upcast product, timed; two DP AdamW
     steps on a 4 x 64 batch within 1e-5 of one rank's (fp32); host ms
     a decode step and tok/s for TP and one rank, and ms an all-reduce
     and an all-gather at the step's shapes (over gloo they pass through
     the host and say nothing of NCCL); each line beside the card's name
     and power limit.
 18. (run after phase 17, before phases 11 and 12) the serving front over
     TP ranks (engine/server.py's broadcast of the leader's arrivals,
     cancels and close; engine/http_server.py; the CLI's --serve
     --mesh-model) on phase 17's weights, through
     parallel/mp_dryrun.serve_run in rank processes, the leader (rank 0)
     answering HTTP clients in its own process: (a) two ranks sharing
     the card over gloo; (b) where the machine has two cards or more,
     min(4, cards) ranks over NCCL, and the CLI's --serve PORT
     --mesh-model 2 --warmup under torchrun (two concurrent POSTs beside
     the single-rank CLI's tokens, then SIGINT: every process gone
     within 30 s); on one card it prints that (b) did not run. Each leg:
     fp32 (TF32 off), 8 concurrent POSTs of 128 + 32 tokens equal the TP
     engine's batch run() in the same pool and every rank finished the
     same streams; a ninth client (96 new tokens) that disconnects after
     two stream lines is cancelled before its end, a prefix of its
     uncancelled stream, and every rank has all 28 pages free after the
     drain; the int8 headline at
     phase 13's engine settings without per-request overrides (int8
     weights and KV, bf16 activations and prefill copy, device sampling,
     top-k 40, temperature 0.8, chunks of 16): warmup() on every rank,
     then 8 concurrent requests of 128 + 128: client tok/s and p50 TTFT
     beside phase 13's, int8 parts launches = L x chained steps on every
     rank, the serving broadcasts' count, median host ms on the leader
     and share of a decode link's host ms. ``--parallel-only`` runs
     phases 1, 2, 17 and 18 alone.
 19. (run after phase 18, before phases 11 and 12, so that no host-timed
     phase follows a profiler session) the long-context engines
     (ops/dev/probe_longctx.py, probe_longrange.py) on one fp32 GPT-2
     1558M set (seeded random weights): long_ctx_engine at its defaults
     (int8 weights and KV, bf16 activations and prefill copy, ps 128,
     pps 9, chunks of 32, greedy; 8 x (896 + 128)), a warm run of 4
     tokens and two runs, the probe printing each run's full stats and
     t_* buckets: every row finishes, flash launches = L x prefill waves,
     int8 parts launches = L x chained steps (no single step) in each run,
     the device ms of each prefill wave; then probe_longrange's B=32 run
     (32 x (128 + 64), chunks of 32, int8; one warm-up, two runs): 32 rows
     of 64 tokens, tok/s, p50 TTFT.
 20. (run after phase 12) the long-context chunk cells, profiled as phase
     12's chunk suite: probe_longctx.main --skip-engine (GPT-2 124M int8
     decode chunk, prompt 128 and 896 x pool_mult 1, 4 and 16) and
     probe_longrange.main --skip-b32 (prompt 896: the plain parts path,
     the ring-depth line, the int8 parts kernel against its plain version
     at a 1152-page pool at phase 3's tolerance, pool_mult 16): int8 parts
     launches = L x steps on each kernel cell, 0 on the plain one; host
     and busy ms a step and idle share a cell, and the slopes in us a step
     per pool page and per live page.
 21. (run after phase 19, before phases 11 and 12) Mellum2-12B-A2.5B at
     its published widths (benchmarks/configs/mellum2-12b-a2.5b-bf16.json):
     the int8 multi-query parts wrapper at head_dim 128 at the code
     cell's shapes (256 rows, a tile of the 8 query heads of each of 4
     K/V heads, pages of 128, 72 a row), over a full layer's shuffled
     pool and a sliding layer's ring (table s*R + j mod R, lower bounds
     inside the window), against its plain version at phase 3's
     tolerance, with its time beside the live bytes' bound; then one
     engine link (bf16 weights drawn on the card, int8 KV, 16 rows of
     1100-2105-token prompts, 33 new tokens): 32 chained steps, all
     replayed as a CUDA graph, 28 int8 mq parts launches a step and no
     other, the ring's pages and the routed rows a layer.
Every kernel time is the lab harness's: CUDA events over launches queued
behind a sleep kernel, the median of 3 runs.
The line before the last is a JSON object {"kernels": [...]} (fifteen
wrappers); the last line is {"ok": true, "device": {...}}.

Exits non-zero, printing no result, without a GPU or outside a checkout
that holds the package.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (dense): HBM bytes/s and fp32 (non-tensor) ops/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
PEAK_BF16_OPS_S = 989e12      # tensor cores, dense
TOL_ABS, TOL_REL = 1e-4, 1e-4
KERNEL_SOURCE = "llmc_paged_tpu_torch/csrc/paged_attention.cu"
TPU_KERNEL = "llmc_paged_tpu/ops/paged_attention.py:248"
MQ_SOURCE = "llmc_paged_tpu_torch/csrc/paged_attention_mq.cu"
MQ_TPU_KERNEL = "llmc_paged_tpu/ops/paged_attention.py:481"
GRID_SOURCE = "llmc_paged_tpu_torch/csrc/paged_attention_grid.cu"
GRID_TPU_KERNEL = "llmc_paged_tpu/ops/paged_attention.py:750"
FLASH_SOURCE = "llmc_paged_tpu_torch/csrc/flash_attention.cu"
FLASH_TPU_KERNEL = "llmc_paged_tpu/ops/layers.py:86"
KERNELS = ("paged_attention", "paged_attention_mq", "paged_attention_grid",
           "int8_matmul", "layernorm", "softmax", "lab_flatwide",
           "lab_full_pool", "flash_attention")
CSRC = "llmc_paged_tpu_torch/csrc/"


def log(msg: str) -> None:
    print(msg, flush=True)


_PHASE = []     # (name, start) of the phase that runs


def phase(msg: str) -> None:
    """Log the seconds of the phase that ends here, then ``msg``, the
    header of the next one ("phase N: ..."; "done" ends the last)."""
    now = time.monotonic()
    if _PHASE:
        log(f"  ({_PHASE[-1][0]}: {now - _PHASE[-1][1]:.1f} s)")
    _PHASE.append((msg.split(":")[0], now))
    log(msg)


class Failed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise Failed(msg)


# ---- phase 3 helpers ---------------------------------------------------------

def make_case(torch, *, B, NH, HS, ps, pps, P, kv, qd, lengths, starts,
              seed, device, repeat_pages=False, KQ=None, distinct=None):
    """Random q (dtype ``qd``) and pool for one kernel case (seeded, made
    on the card); q is (B, KQ, NH, HS) for the multi-query kernel. With
    ``distinct``, table entries are random but the first ``distinct``
    columns (the live pages) name distinct pages, as an allocator's
    would."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    q = torch.randn(*((B, NH, HS) if KQ is None else (B, KQ, NH, HS)),
                    generator=g, device=device).to(
        {"f32": torch.float32, "bf16": torch.bfloat16}[qd])
    shape = (P, NH, HS, ps)
    if kv == "int8":
        k = torch.randint(-127, 128, shape, generator=g, device=device,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=g, device=device,
                          dtype=torch.int8)
        ks = 0.01 * torch.rand(P, NH, ps, generator=g, device=device) + 1e-3
        vs = 0.01 * torch.rand(P, NH, ps, generator=g, device=device) + 1e-3
        pool = (k, v, ks, vs)
    else:
        dt = {"f32": torch.float32, "bf16": torch.bfloat16}[kv]
        pool = (torch.randn(shape, generator=g, device=device).to(dt),
                torch.randn(shape, generator=g, device=device).to(dt))
    if repeat_pages or distinct:
        tables = torch.randint(0, P, (B, pps), generator=g, device=device,
                               dtype=torch.int32)
        if distinct:
            perm = torch.randperm(P, generator=g, device=device)
            tables[:, :distinct] = perm[: B * distinct].reshape(
                B, distinct).to(torch.int32)
    else:
        perm = torch.randperm(P, generator=g, device=device)[: B * pps]
        tables = perm.reshape(B, pps).to(torch.int32)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=device)
    starts = torch.tensor(starts, dtype=torch.int32, device=device)
    return q, pool, tables, lengths, starts


def wrapper_name(q, pool, grid=False):
    quant = "_quant" if len(pool) == 4 else ""
    if grid:
        return f"paged_decode_attention{quant}_grid"
    return (f"paged_decode_attention{quant}_parts"
            + ("_mq" if q.dim() == 4 else ""))


def run_parts(pa, q, pool, tables, lengths, starts, plain=False,
              grid=False):
    fn = getattr(pa, wrapper_name(q, pool, grid) + ("_ref" if plain else ""))
    return fn(q, *pool, tables, lengths, starts)


def grid_err(torch, got, ref):
    """max |Δ| of a normalized output and whether every element is within
    its tolerance: 1e-5 + 1e-5·|ref| for an f32 output (f32 sums in
    another order); for a bf16 output one bf16 ulp of |ref| (both compute
    in f32 and round once) plus 1e-6 (the f32 sums differ by ~1e-7 of
    the values they sum, more than a bf16 ulp of an output near 0)."""
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    if got.dtype == torch.bfloat16:
        tol = 1e-6 + torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(
            2.0 ** -126))) - 7)
    else:
        tol = 1e-5 + 1e-5 * r.abs()
    return float(err.max()), bool((err <= tol).all())


def max_err(torch, got, ref):
    """max |Δ| of acc, m and l, and whether every element is within its
    tolerance: TOL_ABS + TOL_REL·|ref| for m and l; for acc, an
    unnormalized sum over the row's probability mass, the relative part
    is taken of |acc| + l (its rounding grows with the mass it sums)."""
    (acc, m, l), (racc, rm, rl) = got, ref
    errs = [(acc - racc).abs(), (m - rm).abs(), (l - rl).abs()]
    tols = [TOL_ABS + TOL_REL * (racc.abs() + rl[..., None]),
            TOL_ABS + TOL_REL * rm.abs(), TOL_ABS + TOL_REL * rl.abs()]
    worst = [float(e.max()) for e in errs]
    ok = all(bool((e <= t).all()) for e, t in zip(errs, tols))
    return worst, ok


def device_ms(fn, iters=200):
    """Device time (ms) of one call by the kernel lab's timer
    (harness.benchmark): the launches queue behind a sleep kernel, so the
    card runs them back to back whatever the host's launch cost; CUDA
    events, the median of 3 runs."""
    from llmc_paged_tpu_torch.ops.dev.harness import benchmark
    return benchmark(fn, (), iters, device="cuda")


def sector_bytes(mask, itemsize):
    """Bytes of the 32-byte sectors of one contiguous run of len(mask)
    elements that hold an element marked in mask."""
    per = max(1, 32 // itemsize)
    return 32 * sum(any(mask[i:i + per]) for i in range(0, len(mask), per))


def parts_cost(q, pool, tables, lengths, starts, grid=False):
    """(bytes, f32 ops) the call must move and do for THESE inputs: K/V
    (and int8 scales) only for the valid tokens [start, len) of each row,
    counted in the 32-byte sectors of the (P, NH, HS, ps) layout that hold
    them (a page's tokens are contiguous in each (head, dim) row; a page
    named by several rows is read once); q at its dtype, the tables,
    lengths and starts read once, acc/m/l written once (with ``grid``,
    the normalized output at q's dtype); every query scores and sums
    every valid token."""
    B, NH, HS = q.shape[0], q.shape[-2], q.shape[-1]
    KQ = q.shape[1] if q.dim() == 4 else 1
    ps = pool[0].shape[3]
    rows = tables.tolist()
    live = {}                   # page id -> token slots read
    live_tokens = 0
    for b, (ln, st) in enumerate(zip(lengths.tolist(), starts.tolist())):
        if ln <= max(st, 0):
            continue
        live_tokens += ln - st
        for j in range(st // ps, (ln - 1) // ps + 1):
            mask = live.setdefault(rows[b][j], [False] * ps)
            for t in range(max(st, j * ps) - j * ps,
                           min(ln, (j + 1) * ps) - j * ps):
                mask[t] = True
    kv_bytes = sum(sector_bytes(m, pool[0].element_size())
                   for m in live.values()) * 2 * NH * HS
    if len(pool) == 4:
        kv_bytes += sum(sector_bytes(m, 4) for m in live.values()) * 2 * NH
    out_bytes = (q.numel() * q.element_size() if grid
                 else B * KQ * NH * (HS + 2) * 4)
    nbytes = (kv_bytes + q.numel() * q.element_size() + out_bytes
              + B * 4 * 2 + tables.numel() * 4)
    ops = KQ * live_tokens * NH * 4 * HS     # q·k and p·v, 2 ops per MAC
    return nbytes, ops


def time_case(torch, pa, q, pool, tables, lengths, starts, grid=False):
    """Kernel and plain device times (ms) and the bound of one case."""
    ms = device_ms(lambda: run_parts(pa, q, pool, tables, lengths, starts,
                                     grid=grid))
    plain = device_ms(lambda: run_parts(pa, q, pool, tables, lengths,
                                        starts, plain=True, grid=grid),
                      iters=20)
    nbytes, ops = parts_cost(q, pool, tables, lengths, starts, grid=grid)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_OPS_S * 1e3
    return dict(ms=ms, plain_ms=plain, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=ops)


HEADLINE_LENGTHS = [130, 150, 170, 190, 210, 230, 250, 255]
SQ_CASES = [
    # (name, kwargs); the single-query kernel
    ("headline", dict(B=8, ps=128, pps=3, P=28, lengths=HEADLINE_LENGTHS,
                      starts=[0] * 8)),
    ("ragged+zero+boundary", dict(B=8, ps=128, pps=3, P=28,
                                  lengths=[200, 0, 1, 128, 129, 255, 384, 77],
                                  starts=[0] * 8)),
    ("window", dict(B=8, ps=128, pps=3, P=28,
                    lengths=[384, 300, 256, 200, 384, 130, 5, 260],
                    starts=[256, 128, 200, 0, 129, 129, 7, 256])),
    ("ps32", dict(B=8, ps=32, pps=12, P=100,
                  lengths=[384, 0, 1, 32, 33, 100, 250, 383],
                  starts=[0, 0, 0, 0, 1, 40, 64, 300])),
    ("B*pps>4096", dict(B=8, ps=128, pps=520, P=64, repeat_pages=True,
                        lengths=[66560, 1, 0, 40000, 128, 129, 5000, 66559],
                        starts=[0, 0, 0, 39000, 0, 0, 4000, 60000])),
    # 8 live pages a row, as the probe's long-context serving call
    ("long", dict(B=8, ps=128, pps=8, P=72,
                  lengths=[900, 918, 936, 954, 972, 990, 1008, 1024],
                  starts=[0] * 8)),
]
MQ_CASES = [
    # the multi-query kernel: spec verify (KQ = spec_k = 4), KQ=1, the
    # phase-8 suffix (8 rows of 32 queries over a 256-token prefix), a
    # 96-query suffix (above the TPU kernel's 64)
    ("spec", dict(SQ_CASES[0][1], KQ=4)),
    ("KQ=1", dict(SQ_CASES[0][1], KQ=1)),
    ("ragged+zero+boundary", dict(SQ_CASES[1][1], KQ=4)),
    ("window", dict(SQ_CASES[2][1], KQ=4)),
    ("ps32", dict(SQ_CASES[3][1], KQ=4)),
    ("suffix32", dict(B=8, ps=128, pps=4, P=40, lengths=[256] * 8,
                      starts=[0] * 8, KQ=32)),
    ("suffix96", dict(B=8, ps=128, pps=4, P=40,
                      lengths=[256, 0, 128, 384, 1, 129, 300, 512],
                      starts=[0, 0, 0, 100, 0, 0, 0, 0], KQ=96)),
    ("B*pps>4096", dict(SQ_CASES[4][1], KQ=4)),
    ("long", dict(SQ_CASES[5][1], KQ=4)),
]
GRID_CASES = [
    # the normalized grid kernel: the CLI's decode shape (8 rows of a
    # 64-token prompt and up to 64 new tokens at ps=32), then other page
    # sizes with zero, start >= length (5/7, 17/17, 16/16) and windowed
    # rows
    ("cli", dict(B=8, ps=32, pps=32, P=128, distinct=4,
                 lengths=[65, 74, 83, 92, 101, 110, 119, 128],
                 starts=[0] * 8)),
    ("ps8", dict(B=8, ps=8, pps=16, P=160,
                 lengths=[128, 0, 5, 9, 64, 127, 1, 100],
                 starts=[0, 0, 7, 0, 30, 100, 0, 90])),
    ("ps16", dict(B=8, ps=16, pps=8, P=80,
                  lengths=[128, 100, 17, 0, 33, 64, 16, 128],
                  starts=[64, 20, 17, 0, 0, 63, 16, 0])),
    ("ps96", dict(B=8, ps=96, pps=4, P=40,
                  lengths=[384, 0, 96, 97, 200, 5, 383, 250],
                  starts=[0, 0, 0, 96, 100, 7, 300, 0])),
    # a page size that is not a multiple of 4 (the scalar path)
    ("ps30", dict(B=8, ps=30, pps=8, P=70,
                  lengths=[240, 0, 31, 100, 5, 239, 61, 180],
                  starts=[0, 0, 30, 45, 7, 200, 0, 33])),
    # the probe's `kernel` row: 10 live pages of 32 a row
    ("cli10", dict(B=8, ps=32, pps=10, P=88, lengths=[320] * 8,
                   starts=[0] * 8)),
]
# grid cases timed against a 4-warp instance of the template
GRID_WARP_CASES = ("cli", "cli10")
# (pool, q dtype) pairs: q as the main path sends it (f32 over the fp32
# engine's pool, bf16 over the headline int8 pool and over bf16 pools),
# and int8 under an f32 q (fp32 activations over an int8 pool)
POOLS = (("f32", "f32"), ("bf16", "bf16"), ("int8", "bf16"),
         ("int8", "f32"))
# (case, pool) pairs timed for the record, at the main path's q dtype:
# the JSON line takes the first case of each kernel; the suffix times go
# to the log
TIMED_CASES = {"headline", "spec", "suffix32", "long"}
TIMED_POOLS = {("f32", "f32"), ("int8", "bf16")}
# the kernels' times before their redesign for Hopper (warps walking whole
# pages in turn, scalar loads), µs a call, by (kernel, pool, case): this
# script's phase 3 on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md §6
# keeps them beside the new times); the other cases are newer than them
BEFORE_US = {("sq", "f32", "headline"): 20.85,
              ("sq", "int8", "headline"): 22.10,
              ("mq", "f32", "spec"): 24.92, ("mq", "int8", "spec"): 33.57,
              ("mq", "f32", "suffix32"): 63.21,
              ("mq", "int8", "suffix32"): 72.03,
              ("grid", "f32", "cli"): 9.03, ("grid", "int8", "cli"): 11.98}


def before(kind, kv, name, ms):
    """'(before the redesign: ...)' for a timed case."""
    was = BEFORE_US.get((kind, kv, name))
    return "(before the redesign: " + (
        f"{was:.2f} us, x{was / (ms * 1e3):.2f})" if was
        else "not measured)")


# the normalized template at 4 warps a block (the kept instance has 8),
# built by phase 3 from the checkout's header to time the two on the same
# tensors
GRID_W4_SRC = r'''
#include "paged_attention_parts.cuh"
extern "C" int grid_w4(int q_kind, int kv_kind, const void* q, const void* k,
                       const void* v, const void* ks, const void* vs,
                       const void* tables, const void* lengths,
                       const void* starts, void* out, int B, int NH, int HS,
                       int ps, int pps, float scale, void* stream) {
  if (HS != 64 || ps % parts::VEC) return (int)cudaErrorInvalidValue;
  return parts::dispatch_kinds(q_kind, kv_kind, [&](auto qt, auto kv,
                                                    auto quant) {
    using QT = typename decltype(qt)::type;
    using KV = typename decltype(kv)::type;
    parts::parts_kernel<QT, KV, decltype(quant)::value, 64, 1, 4, true>
        <<<dim3(B, NH), 128, 0, (cudaStream_t)stream>>>(
            (const QT*)q, (const KV*)k, (const KV*)v, (const float*)ks,
            (const float*)vs, (const int*)tables, (const int*)lengths,
            (const int*)starts, (QT*)out, nullptr, nullptr, 1, NH, ps, pps,
            scale, parts::Plane{});
    return (int)cudaGetLastError();
  });
}
'''


def build_grid_w4(pa):
    """Build GRID_W4_SRC into build/ and return a function that runs it
    as the grid wrapper would (same arguments, a fresh output)."""
    import ctypes
    import math
    import torch
    from llmc_paged_tpu_torch.ops import _build
    d = os.path.join(HERE, "build", "grid_w4")
    os.makedirs(d, exist_ok=True)
    src, so = os.path.join(d, "grid_w4.cu"), os.path.join(d, "libgrid_w4.so")
    with open(src, "w") as f:
        f.write(GRID_W4_SRC)
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                           _build.CSRC, "-o", so, src], capture_output=True,
                          text=True, timeout=600)
    check(proc.returncode == 0, f"nvcc grid_w4: {proc.stderr[-2000:]}")
    fn = ctypes.CDLL(so).grid_w4
    fn.argtypes, fn.restype = pa._kernel_fn("grid").argtypes, ctypes.c_int

    def run(q, pool, tables, lengths, starts):
        out = torch.empty_like(q)
        ks, vs = (p.data_ptr() for p in pool[2:]) if len(pool) == 4 else (
            None, None)
        B, NH, HS = q.shape
        _build.launch(fn, q.device, (
            pa._KIND[q.dtype], pa._KIND[pool[0].dtype], q.data_ptr(),
            pool[0].data_ptr(), pool[1].data_ptr(), ks, vs,
            tables.data_ptr(), lengths.data_ptr(), starts.data_ptr(),
            out.data_ptr(), B, NH, HS, pool[0].shape[3], tables.shape[1],
            1.0 / math.sqrt(HS)), "grid_w4")
        return out
    return run


def trace_grid(torch, pa, records, n=100):
    """Log the device kernels that n calls of the grid wrapper at the
    CLI's shape launch (phase 3's tensors), from one torch.profiler
    trace: their number, mean µs and names, beside the timer's µs a
    call."""
    for wrapper in ("paged_decode_attention_grid",
                    "paged_decode_attention_quant_grid"):
        rec = records[wrapper]
        kvq, args = rec.pop("traced")
        tr = trace_us(torch, lambda: run_parts(pa, *args, grid=True), n)
        log(f"  grid {kvq} cli, torch.profiler: " + (
            "no device activity (not measured)" if tr is None else
            f"{tr[0]} kernels in {n} calls, {tr[1]:.2f} us each (the "
            f"timer: {rec['ms'] * 1e3:.2f} us a call); {tr[2]}"))


def profile_cli(torch, pa):
    """The CLI's --profile on the card: a greedy batch on a tiny
    checkpoint; the Chrome trace it writes must hold CPU operator events
    and the card's parts kernels. Returns (CPU events, parts kernel
    events, parts launches, ops/dev/dump_chunk_trace.read_trace of the
    trace)."""
    from llmc_paged_tpu_torch.ops.dev.dump_chunk_trace import read_trace
    from llmc_paged_tpu_torch import formats
    from llmc_paged_tpu_torch.config import GPT2Config
    from llmc_paged_tpu_torch.engine import cli
    from llmc_paged_tpu_torch.models import gpt2
    cfg = GPT2Config.tiny(max_seq_len=256, vocab_size=512, channels=128,
                          num_heads=2)
    g = torch.Generator(device="cuda")
    g.manual_seed(10)
    params = gpt2.init_params(cfg, g)
    build = os.path.join(HERE, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as d:
        ckpt, data = os.path.join(d, "tiny.bin"), os.path.join(d, "tok.bin")
        formats.write_checkpoint(ckpt, cfg, {k: v.cpu().numpy()
                                             for k, v in params.items()})
        formats.write_token_stream(data, torch.randint(
            0, cfg.vocab_size, (400,), generator=g,
            device="cuda").int().cpu().numpy())
        reset_counts(pa)
        run_cli(cli, [f"--checkpoint={ckpt}", f"--data={data}", "--batch=2",
                      "--prompt-size=16", "--max-new=24", "--greedy",
                      "--pages-per-seq=8", f"--profile={d}/prof"])
        with open(os.path.join(d, "prof", "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        summary = read_trace(os.path.join(d, "prof", "trace.json"))
    cpu = sum(e.get("cat") == "cpu_op" for e in events)
    parts = sum(e.get("cat") == "kernel" and "parts_kernel" in e["name"]
                for e in events)
    launches = pa.LAUNCHES["paged_decode_attention_parts"]
    check(cpu > 0 and parts > 0 and launches > 0,
          f"cli --profile: {cpu} CPU operator events, {parts} parts kernel "
          f"events, {launches} parts launches in the trace's run")
    return cpu, parts, launches, summary


def trace_summary(r) -> str:
    """One log line of a read_trace record."""
    if r["idle_share"] is None:
        return "no device activity in the trace"
    top = ", ".join(f"{k['name'][:60]} x{k['count']} {k['ms']:.3f} ms"
                    for k in r["top_kernels"])
    gaps = ", ".join(f"{g['ms']:.3f} ms at {g['start_ms']:.3f} ms "
                     f"({g['op']})" for g in r["gaps"])
    return (f"busy {r['busy_ms']:.3f} ms of a {r['window_ms']:.3f} ms "
            f"window, idle share {r['idle_share']:.4f}, "
            f"{r['device_events']} device events; top kernels: {top}; "
            f"longest gaps: {gaps}")


CENSUS_CHUNK = 16        # the JAX tool's default is 32


def chunk_census(torch, cfg):
    """ops/dev/dump_chunk_trace at the JAX tool's defaults but chunks of
    CENSUS_CHUNK (124M, prompt 128, pool-mult 4, B 8), int8 and float32,
    on the card: the per-step and per-chunk table of pool operators,
    and the parts-kernel launches in each trace = L x its steps. A split
    that is not whole is logged with its raw counts, and a whole-plane
    copy on every step is logged: both are findings, not failures."""
    from llmc_paged_tpu_torch.ops.dev import dump_chunk_trace
    for dtype in ("int8", "float32"):
        lines, t0 = [], time.monotonic()
        rec = dump_chunk_trace.run(cfg, dtype, prompt=128, pool_mult=4,
                                   chunk=CENSUS_CHUNK, batch=8,
                                   device="cuda", report=lines.append,
                                   label="124m")
        for ln in lines:
            log("  " + ln)
        want = {s: cfg.num_layers * s
                for s in (CENSUS_CHUNK, 2 * CENSUS_CHUNK)}
        check(rec["parts_kernels"] == want,
              f"chunk trace {dtype}: parts kernels {rec['parts_kernels']} "
              f"in the traces, want L x steps {want}")
        whole = {k: v for k, v in rec["split"].items()
                 if k[0] == "whole plane" and v["step"]}
        log(f"  chunk {dtype} ({time.monotonic() - t0:.1f} s): split "
            f"{'whole' if rec['integral'] else 'NOT whole (raw counts above)'}"
            "; whole-plane operators every step: "
            + (json.dumps({":".join(k): v["step"] for k, v in whole.items()})
               if whole else "none") + f"; trace (S={CENSUS_CHUNK}): "
            + trace_summary(rec["summary"]))


def trace_us(torch, fn, n):
    """The device kernels that n calls of fn launch, from one
    torch.profiler trace: (launches, mean µs a kernel, names); None when
    the profiler reports no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    if not evs:
        return None
    us = sum(e.end_ns() - e.start_ns() for e in evs) / len(evs) / 1e3
    return len(evs), us, sorted({e.name()[:90] for e in evs})


def phase_kernels(torch, pa, device):
    """Kernels vs plain versions over the required cases; returns
    per-wrapper records for the JSON line (times at the main path's
    shapes: the headline decode shape, the spec-verify shape)."""
    NH, HS = 12, 64
    records = {}
    for kv, qd in POOLS:
        for ci, (name, kw) in enumerate(SQ_CASES + MQ_CASES):
            q, pool, tables, lengths, starts = make_case(
                torch, NH=NH, HS=HS, kv=kv, qd=qd, seed=100 + ci,
                device=device, **kw)
            wrapper = wrapper_name(q, pool)
            rec = records.setdefault(wrapper, {"max_abs_err": 0.0})
            got = run_parts(pa, q, pool, tables, lengths, starts)
            ref = run_parts(pa, q, pool, tables, lengths, starts, plain=True)
            torch.cuda.synchronize()
            errs, ok = max_err(torch, got, ref)
            err = max(errs)
            kind = "mq" if q.dim() == 4 else "sq"
            kvq = f"{kv}/q{qd}"
            log(f"  {kind} {kvq:10s} {name:22s} max|d| acc {errs[0]:.3e} m "
                f"{errs[1]:.3e} l {errs[2]:.3e} "
                f"{'ok' if ok else 'FAIL'}")
            check(ok, f"kernel vs plain mismatch: {kind} {kvq} {name}")
            check(all(bool(torch.isfinite(t).all()) for t in got),
                  f"non-finite kernel output: {kind} {kvq} {name}")
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            if name in TIMED_CASES and (kv, qd) in TIMED_POOLS:
                # the fp32 engine's pool for the float kernels, the
                # headline's int8 pool under bf16 q for the quant kernels
                t = time_case(torch, pa, q, pool, tables, lengths, starts)
                if "ms" not in rec:
                    rec.update(t, shape=name)
                log(f"  {kind} {kvq} {name} time: kernel "
                    f"{t['ms'] * 1e3:.2f} us "
                    + before(kind, kv, name, t["ms"])
                    + f", plain {t['plain_ms'] * 1e3:.2f} us, bound "
                    f"{t['bound_ms'] * 1e3:.3f} us by {t['bound_by']} "
                    f"({t['bytes']} B, {t['ops']} f32 ops)")
            del q, pool, got, ref
    # the grid kernel: every case timed; the JSON line takes the CLI
    # shape at the main path's q dtype (f32 over the fp32 CLI run's pool,
    # bf16 over the int8 run's)
    grid_w4 = build_grid_w4(pa)
    for kv, qd in POOLS:
        for ci, (name, kw) in enumerate(GRID_CASES):
            q, pool, tables, lengths, starts = make_case(
                torch, NH=NH, HS=HS, kv=kv, qd=qd, seed=200 + ci,
                device=device, **kw)
            wrapper = wrapper_name(q, pool, grid=True)
            rec = records.setdefault(wrapper, {"max_abs_err": 0.0})
            got = run_parts(pa, q, pool, tables, lengths, starts, grid=True)
            ref = run_parts(pa, q, pool, tables, lengths, starts, plain=True,
                            grid=True)
            torch.cuda.synchronize()
            err, ok = grid_err(torch, got, ref)
            masked = [b for b, (ln, st) in enumerate(zip(kw["lengths"],
                                                         kw["starts"]))
                      if st >= ln]
            zeros = all(bool((got[b] == 0).all()) for b in masked)
            kvq = f"{kv}/q{qd}"
            t = time_case(torch, pa, q, pool, tables, lengths, starts,
                          grid=True)
            log(f"  grid {kvq:10s} {name:6s} max|d| {err:.3e} "
                f"{'ok' if ok and zeros else 'FAIL'}; kernel "
                f"{t['ms'] * 1e3:.2f} us "
                + before("grid", kv, name, t["ms"])
                + f", plain {t['plain_ms'] * 1e3:.2f} "
                f"us, bound {t['bound_ms'] * 1e3:.3f} us by "
                f"{t['bound_by']} ({t['bytes']} B, {t['ops']} f32 ops)")
            check(ok and zeros and bool(torch.isfinite(got).all()),
                  f"grid kernel vs plain mismatch: {kvq} {name}")
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            if name in GRID_WARP_CASES and (kv, qd) in TIMED_POOLS:
                args = (q, pool, tables, lengths, starts)
                w4_err, w4_ok = grid_err(torch, grid_w4(*args), ref)
                check(w4_ok, f"4-warp grid instance vs plain: {kvq} {name}")
                w4 = device_ms(lambda: grid_w4(*args))
                log(f"  grid {kvq} {name}: 8 warps a block (kept) "
                    f"{t['ms'] * 1e3:.2f} us, 4 warps {w4 * 1e3:.2f} us "
                    f"(max|d| {w4_err:.3e})")
            if name == "cli" and (kv, qd) in TIMED_POOLS:
                # traced at the end (trace_grid), after the host-timed
                # phases, which a torch.profiler session could slow
                rec.update(t, shape=name, traced=(kvq, (q, pool, tables,
                                                        lengths, starts)))
            del q, pool, got, ref
    return records


# ---- phases 4-8 -----------------------------------------------------------

def prompts_for(torch, n, lengths, V, seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return [torch.randint(0, V, (ln,), generator=g, device=device).tolist()
            for ln in lengths[:n]]


def make_engine(params, cfg, *, kv_dtype, param_dtype, num_pages,
                use_kernel=True, device="cuda", pps=3, prefix=False,
                native_manager=None, **econf_kw):
    """An engine at ps 128, max_batch 8, chunks of 16; "int8" adds bf16
    activations and the bf16 prefill copy (the headline configuration).
    ``econf_kw`` overrides EngineConfig fields (greedy by default)."""
    from llmc_paged_tpu_torch.config import EngineConfig, PageConfig
    from llmc_paged_tpu_torch.engine.engine import InferenceEngine
    quant = param_dtype == "int8"
    page = PageConfig(page_size=128, num_pages=num_pages, max_seqs=8,
                      pages_per_seq=pps, kv_dtype=kv_dtype,
                      prefix_cache=prefix)
    econf = EngineConfig(**{**dict(
        cache_mode="paged", page=page, max_batch=8, greedy=True,
        decode_chunk=16, param_dtype=param_dtype,
        activation_dtype="bfloat16" if quant else "float32",
        prefill_param_dtype="bfloat16" if quant else None,
        spec_ngram=3), **econf_kw})
    return InferenceEngine(params, cfg, econf, device=device,
                           use_kernel=use_kernel,
                           native_manager=native_manager)


def serve(torch, params, cfg, *, prompts, new, kv_dtype, param_dtype,
          num_pages, use_kernel=True, max_new=None, device="cuda",
          engine=None, pps=3, spec_k=0, prefix=False, native_manager=None):
    from llmc_paged_tpu_torch.engine.scheduler import Request
    if engine is None:
        engine = make_engine(params, cfg, kv_dtype=kv_dtype,
                             param_dtype=param_dtype, num_pages=num_pages,
                             use_kernel=use_kernel, device=device, pps=pps,
                             prefix=prefix, spec_k=spec_k,
                             native_manager=native_manager)
    reqs = [Request(rid=i, prompt=list(p),
                    max_new_tokens=(max_new[i] if max_new else new))
            for i, p in enumerate(prompts)]
    done = engine.run(reqs)
    torch.cuda.synchronize()
    return engine, sorted(done, key=lambda r: r.rid)


def count_syncs(torch, fn):
    """Synchronizing CUDA calls made by fn(), counted by torch's sync
    debug mode: device→host copies, and host→device copies from pageable
    memory (a blocking copy waits for the stream to drain)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    where = collections.Counter(
        f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
        if "called a synchronizing CUDA operation" in str(w.message))
    return sum(where.values()), dict(where)


def reset_counts(pa):
    """Zero the launch counts of the serving path's wrappers: the paged
    attention kernels and the prefill's flash kernel."""
    from llmc_paged_tpu_torch.ops import flash_attention as fa
    for counts in (pa.LAUNCHES, fa.LAUNCHES):
        for k in counts:
            counts[k] = 0


def flash_launches():
    from llmc_paged_tpu_torch.ops import flash_attention as fa
    return fa.LAUNCHES["causal_attention_flash"]


def run_cli(cli, argv):
    """The port's CLI in process; returns its --json payload."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv + ["--json"])
    check(rc == 0, f"cli exited {rc}: {argv}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def phase_cli(torch, pa, params32, cfg, device):
    """Phases 9 and 10: the CLI at the reference defaults (sampled, fp32
    and int8) and its three modes. Returns the grid launches of the two
    sampled runs."""
    from llmc_paged_tpu_torch import formats
    from llmc_paged_tpu_torch.engine import cli
    from llmc_paged_tpu_torch.tokenizer import byte_fallback_table
    os.environ.pop("LLMC_PLATFORM", None)        # the CLI's card default
    L = cfg.num_layers
    build = os.path.join(HERE, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as d:
        t0 = time.monotonic()
        ckpt, data, tokf = (os.path.join(d, n) for n in
                            ("gpt2_124M.bin", "tokens.bin", "tok.bin"))
        formats.write_checkpoint(ckpt, cfg, {k: v.cpu().numpy()
                                             for k, v in params32.items()})
        g = torch.Generator(device=device)
        g.manual_seed(6)
        formats.write_token_stream(data, torch.randint(
            0, cfg.vocab_size, (8 * 64 + 64,), generator=g,
            device=device).int().cpu().numpy())
        formats.write_tokenizer_bin(tokf, byte_fallback_table(cfg.vocab_size))
        log(f"  wrote checkpoint, token stream, tokenizer in "
            f"{time.monotonic() - t0:.1f} s")
        base = [f"--checkpoint={ckpt}", f"--data={data}",
                f"--tokenizer={tokf}", "--mode=paged", "--page-size=32",
                "--num-pages=128", "--pages-per-seq=32", "--seed=1337"]
        sampled = base + ["--batch=8", "--prompt-size=64", "--max-new=64",
                          "--top-k=40"]
        launches, streams = {}, {}
        for tag, extra, key in (
                ("fp32", [], "paged_decode_attention_grid"),
                ("int8", ["--dtype=int8", "--activation-dtype=bfloat16"],
                 "paged_decode_attention_quant_grid")):
            reset_counts(pa)
            out = run_cli(cli, sampled + extra)
            la = dict(pa.LAUNCHES)
            st = out["stats"]
            toks = [out["tokens"][str(b)] for b in range(8)]
            check(len(toks) == 8 and all(len(t) == 128 for t in toks)
                  and all(0 <= x < cfg.vocab_size for t in toks for x in t),
                  f"cli {tag}: not 8 rows of 64 + 64 in-range tokens")
            steps = st["single_steps"]
            check(steps == st["decode_steps"] > 0 and la[key] == L * steps
                  and sum(la.values()) == la[key],
                  f"cli {tag}: {la} launches, want {key} = L x {steps} "
                  "single-token steps and nothing else")
            host_ms = 1e3 * (st["t_step_dispatch_s"]
                             + st["t_materialize_s"]) / steps
            log(f"  cli {tag}: decode_tok_per_s {st['decode_tok_per_s']:.1f}"
                f", p50_ttft_s {st['p50_ttft_s']:.4f}, single-token steps "
                f"{steps}, launches {key} {la[key]}, wall "
                f"{st['wall_s']:.3f} s, host per step {host_ms:.2f} ms "
                f"(dispatch {st['t_step_dispatch_s']} s, sample + fetch "
                f"{st['t_materialize_s']} s, prefill dispatch "
                f"{st['t_prefill_dispatch_s']} s)")
            launches[key], streams[tag] = la[key], toks
        # the host half of "sample + fetch": the engine's top-k row
        # sampler on 8 rows of card logits while the device is idle (the
        # rest of the bucket is the wait for the step's device work)
        from llmc_paged_tpu_torch.engine.engine import _sample_rows
        from llmc_paged_tpu_torch.sampler import Sampler
        g.manual_seed(7)
        logits = torch.randn(8, cfg.vocab_size, generator=g, device=device)
        sampler = Sampler(1337, top_k=40)
        _sample_rows(sampler, logits, 8)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(20):
            _sample_rows(sampler, logits, 8)
        log(f"  host sampling alone (8 rows, top-k 40, device idle): "
            f"{(time.monotonic() - t0) / 20 * 1e3:.2f} ms a step")
        plain = run_cli(cli, sampled + ["--no-kernel"])
        agree = 0
        for b in range(8):
            a, p = streams["fp32"][b], plain["tokens"][str(b)]
            check(a[64:80] == p[64:80],
                  f"cli fp32 row {b}: kernel and --no-kernel streams "
                  f"disagree in the first 16 tokens: {a[64:80]} vs "
                  f"{p[64:80]}")
            agree += a == p
        log(f"  cli fp32 vs --no-kernel: {agree}/8 streams identical over "
            "64 sampled tokens, all agree on the first 16")

        phase("phase 10: --mode none, dense, paged at --batch 1, fp32, greedy,"
              " 32 new tokens")
        modes = {}
        for mode in ("none", "dense", "paged"):
            t0 = time.monotonic()
            out = run_cli(cli, base + [f"--mode={mode}", "--batch=1",
                                       "--prompt-size=64", "--max-new=32",
                                       "--greedy"])
            modes[mode] = out["tokens"]["0"]
            log(f"  {mode}: {len(modes[mode])} tokens in "
                f"{time.monotonic() - t0:.2f} s (CLI call, checkpoint read "
                "included)")
        check(len(modes["paged"]) == 96
              and modes["none"] == modes["dense"] == modes["paged"],
              f"modes: the streams differ: {modes}")
        log("  none, dense and paged: identical 32-token streams")
    return launches


# ---- phase 21: Mellum 2 at the cell's shapes ---------------------------------

MELLUM_CONFIG = "benchmarks/configs/mellum2-12b-a2.5b-bf16.json"
MELLUM_ROWS, MELLUM_PPS = 256, 72       # the code cell's rows and pages a row


def mellum_kernel_cases(torch, pa, cfg, device):
    """The int8 multi-query parts wrapper at head_dim 128 as the code cell
    calls it, against its plain version on the same tensors at phase 3's
    tolerance: B = 256 rows of a query tile of G = 8 query heads over 4
    K/V heads, pages of 128, 72 a row; a full layer (the managed pool's
    18,436 pages, shuffled tables, lower bound 0) and a sliding layer (a
    ring of 9 pages a row, table s*R + j mod R, each row's lower bound
    inside the window as a chained step's is); lengths of a 2k-8k prompt
    and up to 1k served tokens, some rows idle (length 0)."""
    import random
    from llmc_paged_tpu_torch.models import mellum_paged
    B, NKV, G, HD, ps = (MELLUM_ROWS, cfg.num_kv_heads, cfg.group,
                         cfg.head_dim, 128)
    W = cfg.sliding_window
    R = mellum_paged.ring_pages(W, ps)
    rnd = random.Random(21)
    lengths = [0 if b % 37 == 5 else rnd.randint(2049, ps * MELLUM_PPS)
               for b in range(B)]
    for kind in ("full", "sliding"):
        sliding = kind == "sliding"
        starts = [max(0, n - W + 1 + rnd.randint(0, 31)) if sliding and n
                  else 0 for n in lengths]
        P = B * R if sliding else B * MELLUM_PPS + 4
        q, pool, tables, ln, st = make_case(
            torch, B=B, NH=NKV, HS=HD, ps=ps, pps=MELLUM_PPS, P=P,
            kv="int8", qd="bf16", lengths=lengths, starts=starts,
            seed=2100 + sliding, device=device, KQ=G,
            repeat_pages=sliding)
        if sliding:
            j = torch.arange(MELLUM_PPS, device=device)
            tables = (torch.arange(B, device=device)[:, None] * R
                      + j[None, :] % R).to(torch.int32)
        got = run_parts(pa, q, pool, tables, ln, st)
        ref = run_parts(pa, q, pool, tables, ln, st, plain=True)
        torch.cuda.synchronize()
        errs, ok = max_err(torch, got, ref)
        idle = [b for b, n in enumerate(lengths) if n == 0]
        empty = all(float(got[2][b].abs().max()) == 0.0 for b in idle)
        live = sum(n - s for n, s in zip(lengths, starts))
        nbytes = live * NKV * (2 * HD + 2 * 4)
        us = device_ms(lambda: run_parts(pa, q, pool, tables, ln, st),
                       iters=50) * 1e3
        log(f"  mq int8/qbf16 hd{HD} {kind:7s} B={B} KQ={G} NKV={NKV} "
            f"P={P}: max|d| acc {errs[0]:.3e} m {errs[1]:.3e} l "
            f"{errs[2]:.3e} {'ok' if ok and empty else 'FAIL'}; kernel "
            f"{us:.2f} us, bound {nbytes / PEAK_BYTES_S * 1e6:.2f} us "
            f"({nbytes} B of live K/V and scales)")
        check(ok and empty and all(bool(torch.isfinite(t).all())
                                   for t in got),
              f"mellum: hd{HD} int8 mq parts vs plain mismatch ({kind})")
        del q, pool, got, ref


def mellum_weights(torch, cfg, seed, device):
    """Mellum's weights in bf16 on the card, every matrix N(0, 0.02)
    drawn a slice at a time (one copy, no f32 twin), RMSNorm weights 1."""
    from llmc_paged_tpu_torch.models import mellum
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    out = {}
    for k, shp in mellum.param_shapes(cfg).items():
        t = torch.empty(shp, dtype=torch.bfloat16, device=device)
        if k in mellum.NORM_KEYS:
            t.fill_(1.0)
        else:
            flat = t.view(-1)
            for a in range(0, flat.numel(), 1 << 28):
                b = min(a + (1 << 28), flat.numel())
                flat[a:b] = torch.randn(b - a, generator=g,
                                        device=device).mul_(0.02)
        out[k] = t
    return out


def phase_mellum(torch, pa, device):
    """Phase 21: Mellum2-12B-A2.5B at its published widths
    (MELLUM_CONFIG): the hd128 int8 multi-query parts wrapper at the code
    cell's shapes against its plain version, then one engine link (the
    cell's serving: bf16 weights and activations, int8 KV pages of 128,
    72 a row, chains of 32, greedy) of 16 rows whose prompts outgrow the
    window: 33 new tokens a row, so 32 chained steps; the launch counts
    reset just before the run give 28 int8 mq parts launches a step and
    nothing else, every step replays as a CUDA graph."""
    from llmc_paged_tpu_torch.config import (EngineConfig, MellumConfig,
                                             PageConfig)
    from llmc_paged_tpu_torch.engine.engine import InferenceEngine
    from llmc_paged_tpu_torch.engine.scheduler import Request
    from llmc_paged_tpu_torch.models import mellum_paged
    with open(os.path.join(HERE, MELLUM_CONFIG)) as f:
        cfg = MellumConfig.from_hf(json.load(f))
    mellum_kernel_cases(torch, pa, cfg, device)
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    params = mellum_weights(torch, cfg, 23, device)
    B = 16
    page = PageConfig(page_size=128, num_pages=B * MELLUM_PPS + 4,
                      max_seqs=B, pages_per_seq=MELLUM_PPS, kv_dtype="int8")
    eng = InferenceEngine(params, cfg, EngineConfig(
        cache_mode="paged", page=page, param_dtype="bfloat16",
        activation_dtype="bfloat16", max_batch=B, greedy=True,
        decode_chunk=32), device=device)
    lengths = [1100 + 67 * b for b in range(B)]
    prompts = prompts_for(torch, B, lengths, cfg.vocab_size, 21, device)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=33)
            for i, p in enumerate(prompts)]
    log(f"  weights {sum(t.numel() for t in params.values()) / 1e9:.2f} B "
        f"parameters in bf16, engine built: {time.monotonic() - t0:.1f} s")
    reset_counts(pa)
    t0 = time.monotonic()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    st = eng.stats
    launches = {k: v for k, v in pa.LAUNCHES.items() if v}
    L = cfg.num_layers
    want = L * st["decode_steps"]
    counts = torch.tensor(st["moe_routed_tokens"])
    log(f"  {len(done)} rows of prompts {lengths[0]}-{lengths[-1]}, 33 new "
        f"tokens each: {wall:.2f} s (first run, graphs captured); decode "
        f"steps {st['decode_steps']}, graph steps "
        f"{st['decode_graph_steps']}, launches {launches}, flash launches "
        f"{flash_launches()}; kv_window_pages {st['kv_window_pages']}, "
        f"kv_full_pages_peak {st['kv_full_pages_peak']}; routed rows a "
        f"layer {int(counts[0].sum())}, largest expert over the mean "
        f"{float((counts.max(1).values / counts.float().mean(1)).max()):.2f}"
        f"; peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    check(len(done) == B and all(len(r.generated) == 33 for r in done)
          and all(0 <= t < cfg.vocab_size for r in done
                  for t in r.generated),
          "mellum: not every row finished with 33 tokens in range")
    check(st["decode_steps"] == 32 and st["decode_graph_steps"] == 32,
          f"mellum: {st['decode_steps']} decode steps, "
          f"{st['decode_graph_steps']} replayed as a graph; want 32 and 32")
    check(launches == {"paged_decode_attention_quant_parts_mq": want}
          and flash_launches() == 0,
          f"mellum: launches {launches}, want {want} int8 mq (L x "
          f"{st['decode_steps']} steps) and nothing else")
    check(st["kv_window_pages"] == B * mellum_paged.ring_pages(
        cfg.sliding_window, 128)
          and bool((counts.sum(1) == counts[0].sum()).all())
          and int(counts[0].sum()) == cfg.top_k * (
              sum(lengths) + B * st["decode_steps"]),
          "mellum: ring pages or routed rows off")
    del eng, params, done
    torch.cuda.empty_cache()


# ---- phase 13: the serving front ---------------------------------------------

def concurrently(fn, jobs):
    """fn(job) for every job, each on its own thread; results in order."""
    import threading
    out, errs = [None] * len(jobs), []

    def one(i, job):
        try:
            out[i] = fn(job)
        except BaseException as e:     # re-raised below
            errs.append(e)

    threads = [threading.Thread(target=one, args=(i, j))
               for i, j in enumerate(jobs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return out


def phase_serving(torch, pa, params32, cfg, device, greedy_host_ms):
    """Phase 13: ServingEngine and the HTTP front on the card, an fp32
    parity engine and the int8 headline engine under device sampling.
    Returns the headline's served numbers (client tok/s, the engine's
    decode_tok_per_s and p50_ttft_s) for phase 18."""
    from llmc_paged_tpu_torch.engine.http_server import HttpServingFront
    from llmc_paged_tpu_torch.engine.scheduler import Request
    from llmc_paged_tpu_torch.engine.server import ServingEngine
    from llmc_paged_tpu_torch.models import gpt2, gpt2_paged
    from llmc_paged_tpu_torch.parallel.mp_dryrun import (
        http_disconnect,
        http_post,
        http_stream,
    )
    L, V = cfg.num_layers, cfg.vocab_size
    prompts = prompts_for(torch, 8, [128] * 8, V, 8, device)
    NEW = 48
    # the parity requests: rows 0-3 greedy with logprobs, 4-5 penalized
    # greedy (5 with logprobs), 6 a top_k=1 draw of row 0's prompt, 7 a
    # top-40 draw at temperature 0.8 with logprobs
    rows = [dict(logprobs=True)] * 4 + [
        dict(frequency_penalty=0.5, presence_penalty=0.5),
        dict(frequency_penalty=1.0, logprobs=True),
        dict(greedy=False, top_k=1),
        dict(greedy=False, top_k=40, temperature=0.8, logprobs=True)]
    rows_prompts = prompts[:6] + [prompts[0], prompts[7]]

    def batch_run(eng, new=NEW, which=range(8)):
        done = eng.run([Request(rid=i, prompt=list(rows_prompts[i]),
                                max_new_tokens=new, **rows[i])
                        for i in which])
        torch.cuda.synchronize()
        return {r.rid: r for r in done}

    # ---- fp32 parity engine -------------------------------------------
    t0 = time.monotonic()
    e32 = make_engine(params32, cfg, kv_dtype="float32",
                      param_dtype="float32", num_pages=28, device=device,
                      device_sampling=True, stream_links=2)
    ref = batch_run(e32)
    again = batch_run(e32)
    check(all(again[i].generated == ref[i].generated for i in range(8)),
          "fp32 serving: the same seed gave other streams in a second run")
    check(ref[6].generated == ref[0].generated,
          f"fp32 serving: top_k=1 under device sampling "
          f"{ref[6].generated[:8]} != greedy {ref[0].generated[:8]}")
    check(ref[7].generated != ref[0].generated,
          "fp32 serving: the top-40 row equals the greedy row")
    log(f"  fp32 batch runs: {e32.stats['decode_steps']} decode steps, "
        f"single steps {e32.stats['single_steps']}, same seed -> same "
        f"streams, top_k=1 == greedy ({time.monotonic() - t0:.1f} s)")
    check(e32.stats["single_steps"] == 0,
          "fp32 serving: a device-sampled batch took single-token steps")
    with ServingEngine(e32) as srv, HttpServingFront(srv, "127.0.0.1",
                                                     0) as front:
        url = f"http://{front.host}:{front.port}/generate"
        t0 = time.monotonic()
        served = concurrently(lambda i: http_post(url, dict(
            prompt=rows_prompts[i], max_new_tokens=NEW, **rows[i])),
            list(range(8)))
        t_http = time.monotonic() - t0
        for i, (status, out, _) in enumerate(served):
            check(status == 200, f"fp32 http row {i}: status {status} {out}"
                  f" (serving loop: {srv._error!r})")
            check(len(out["generated"]) == NEW
                  and out["tokens"][:128] == rows_prompts[i],
                  f"fp32 http row {i}: not {NEW} tokens after its prompt")
        for i in range(7):
            check(served[i][1]["generated"] == ref[i].generated,
                  f"fp32 http row {i} {rows[i]}: tokens differ from the "
                  f"batch run: {served[i][1]['generated'][:12]} vs "
                  f"{ref[i].generated[:12]}")
        # logprobs and sampled tokens against one dense forward each
        lp_err, lp_http_err, slack = 0.0, 0.0, float("inf")
        for i in (0, 1, 2, 3, 5, 7):
            out = served[i][1]
            seq = out["tokens"]
            lg = gpt2.forward(e32.params, torch.tensor(
                [seq[:-1]], dtype=torch.int32), cfg)[0].double()
            want = torch.log_softmax(lg, -1)[127:].gather(
                1, torch.tensor(seq[128:], device=lg.device)[:, None])[:, 0]
            got = torch.tensor(out["logprobs"], dtype=torch.float64,
                               device=lg.device)
            lp_err = max(lp_err, float((got - want).abs().max()))
            if i != 7:
                lp_http_err = max(lp_http_err, max(
                    abs(a - b) for a, b in zip(out["logprobs"],
                                               ref[i].logprob_values)))
            else:
                kth = torch.topk(lg[127:], 40, dim=-1).values[:, -1]
                chosen = lg[127:].gather(1, torch.tensor(
                    seq[128:], device=lg.device)[:, None])[:, 0]
                slack = float((chosen - kth).min())
        log(f"  fp32 http: 8 concurrent requests in {t_http:.2f} s; rows 0-6 "
            f"(greedy with logprobs, penalized greedy, top_k=1) equal the "
            f"batch run; logprobs vs dense log_softmax max|d| {lp_err:.2e} "
            f"(tol 2e-3), vs the batch run {lp_http_err:.2e}; top-40 row: "
            f"min(logit - 40th logit) {slack:.3e} (tol -1e-3)")
        check(lp_err <= 2e-3, f"fp32 http: logprobs off by {lp_err}")
        check(slack >= -1e-3,
              f"fp32 http: a sampled token lies outside the top 40 ({slack})")
        # a stream cancelled by its client's disconnect
        long_new = 200
        got = http_disconnect(front.host, front.port, dict(
            prompt=rows_prompts[1], max_new_tokens=long_new))
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            st = srv.stats()
            if st["open_streams"] == 0 and st["running"] == 0:
                break
            time.sleep(0.01)
        check(st["open_streams"] == 0 and st["running"] == 0,
              f"disconnect: the stream was never cancelled: {st}")
        check(st["pages_free"] == 28,
              f"disconnect: {st['pages_free']} of 28 pages free after it")
    uncancelled = e32.run([Request(rid=0, prompt=list(rows_prompts[1]),
                                   max_new_tokens=long_new)])[0].generated
    check(0 < len(got) < long_new and got == uncancelled[: len(got)],
          f"disconnect: {len(got)} streamed tokens are not a prefix of the "
          "uncancelled stream")
    log(f"  fp32 disconnect: {len(got)} tokens streamed before the client "
        f"left, a prefix of the uncancelled {long_new}; pages free "
        f"{st['pages_free']}/28, decode tokens {st['decode_tokens']}")
    del e32

    # ---- int8 headline engine: warmup, then 8 concurrent requests -----
    eng = make_engine(params32, cfg, kv_dtype="int8", param_dtype="int8",
                      num_pages=28, device=device, device_sampling=True,
                      greedy=False, top_k=40, temperature=0.8)
    t0 = time.monotonic()
    warm = eng.warmup()
    t_warm = time.monotonic() - t0
    hprompts = prompts_for(torch, 8, [128] * 8, V, 9, device)
    kinds = [("greedy+logprobs", dict(greedy=True, logprobs=True)),
             ("greedy+logprobs", dict(greedy=True, logprobs=True)),
             ("penalties", dict(frequency_penalty=0.5,
                                presence_penalty=0.3)),
             ("penalties", dict(frequency_penalty=1.0)),
             ("stream", dict()), ("stream", dict()),
             ("top_k/temperature", dict(top_k=5, temperature=1.2)),
             ("top_k/temperature", dict(top_k=200, temperature=0.6))]
    HNEW = 128
    reset_counts(pa)
    with ServingEngine(eng) as srv, HttpServingFront(srv, "127.0.0.1",
                                                     0) as front:
        url = f"http://{front.host}:{front.port}/generate"

        def job(i):
            kind, kw = kinds[i]
            payload = dict(prompt=hprompts[i], max_new_tokens=HNEW, **kw)
            if kind == "stream":
                toks, t_first, final = http_stream(url, payload)
                return kind, toks, t_first, final
            status, out, secs = http_post(url, payload)
            check(status == 200, f"int8 http row {i}: {status} {out} "
                  f"(serving loop: {srv._error!r})")
            return kind, out["generated"], secs, out

        t0 = time.monotonic()
        results = concurrently(job, list(range(8)))
        t_http = time.monotonic() - t0
        live = srv.stats()
    st = dict(eng.stats)
    launches = dict(pa.LAUNCHES)
    for i, (kind, toks, secs, out) in enumerate(results):
        check(len(toks) == HNEW and all(0 <= t < V for t in toks),
              f"int8 http row {i} ({kind}): {len(toks)} tokens")
        if kind == "stream":
            check(out["done"] and out["generated"] == toks,
                  f"int8 http row {i}: the stream's lines do not "
                  "concatenate to its final tokens")
        if kind == "greedy+logprobs":
            lps = out["logprobs"]
            check(len(lps) == HNEW and all(v <= 0.0 and v == v for v in lps),
                  f"int8 http row {i}: logprobs not {HNEW} finite values "
                  "<= 0")
    want = L * st["decode_steps"]
    check(st["single_steps"] == 0 and st["decode_steps"] > 0
          and launches["paged_decode_attention_quant_parts"] == want,
          f"int8 http: {launches} launches and {st['single_steps']} single "
          f"steps, want L x {st['decode_steps']} chained decode steps")
    n_tok = sum(len(r[1]) for r in results)
    ttft_stream = sorted(r[2] for r in results if r[0] == "stream")
    log(f"  int8 headline: warmup {t_warm:.2f} s {warm}; 8 concurrent "
        f"requests (2 greedy+logprobs, 2 penalized, 2 streams, 2 top_k/"
        f"temperature), {HNEW} tokens each: {n_tok} tokens in "
        f"{t_http:.3f} s = {n_tok / t_http:.1f} tok/s client side, engine "
        f"decode_tok_per_s {st['decode_tok_per_s']:.1f}, p50_ttft_s "
        f"{st['p50_ttft_s']:.4f} (queue included), stream first lines "
        f"{', '.join(f'{t:.3f}' for t in ttft_stream)} s, decode steps "
        f"{st['decode_steps']}, single steps {st['single_steps']}, "
        f"launches {launches}, pages free after {live['pages_free']}")
    # host ms per chunk step of a device-sampled chain: one batch run of
    # the same 8 requests, beside phase 4's greedy chain
    done = eng.run([Request(rid=i, prompt=list(hprompts[i]),
                            max_new_tokens=HNEW, **kinds[i][1])
                    for i in range(8)])
    torch.cuda.synchronize()
    sb = eng.stats
    check(len(done) == 8 and sb["single_steps"] == 0,
          "int8 batch run: a device-sampled batch took single steps")
    log(f"  int8 batch run of the same requests: decode_tok_per_s "
        f"{sb['decode_tok_per_s']:.1f}, p50_ttft_s {sb['p50_ttft_s']:.4f}, "
        f"host per chunk step {host_ms_step(sb):.2f} ms (model.step over "
        f"{sb['decode_steps']} steps; chain dispatch "
        f"{sb['t_chain_dispatch_s']} s, materialize "
        f"{sb['t_materialize_s']} s); phase 4's greedy chain: "
        f"{greedy_host_ms:.2f} ms")
    # synchronizing calls in one bare device-sampled link: device
    # carries, host coordinates, per-row arrays, penalties and logprobs
    B8 = 8
    pool = eng._pool_cache
    tables = torch.arange(3 * B8, dtype=torch.int32).reshape(B8, 3)
    pos = 128 + torch.arange(16, dtype=torch.int32)[:, None].repeat(1, B8)
    pgs = tables.gather(1, (pos // 128).T.long()).T.contiguous()
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    dev_args = dict(
        first_tokens=torch.full((B8,), 7, device=device, dtype=torch.int32),
        temperature=torch.full((B8,), 0.8, device=device),
        k_arr=torch.full((B8,), 40, device=device, dtype=torch.int32),
        greedy_rows=torch.arange(B8, device=device) < 2,
        pen_counts=torch.zeros(B8, V, device=device, dtype=torch.int32),
        freq_pen=torch.full((B8,), 0.5, device=device),
        pres_pen=torch.full((B8,), 0.3, device=device))
    syncs, where = count_syncs(torch, lambda: gpt2_paged.decode_chunk_paged(
        eng.params, positions0=torch.full((B8,), 128, dtype=torch.int32),
        pages=pgs, slots=pos % 128, block_tables=tables, pool=pool,
        cfg=cfg, num_steps=16, window=cfg.max_seq_len, rng=gen, top_k=64,
        want_logprobs=True, **dev_args))
    log(f"  synchronizing CUDA calls in one bare device-sampled link (16 "
        f"steps, per-row top-k/temperature/greedy, penalties, logprobs): "
        f"{syncs} {json.dumps(where, sort_keys=True)}")
    check(syncs == 0, f"device-sampled link: {syncs} synchronizing calls")
    del pool
    return {"tok_s": n_tok / t_http, "decode_tok_per_s": st[
        "decode_tok_per_s"], "p50_ttft_s": st["p50_ttft_s"]}


# ---- phase 14: the long-prompt prefill ---------------------------------------

# (B, NH, T) the flash kernel is held against its plain version at: the
# smallest prefill that takes it, the 124M long-context wave (896) and a
# 1024-token one, and the 1558M head count; the JSON line takes FLASH_MAIN
FLASH_SHAPES = ((1, 12, 256), (8, 12, 896), (8, 12, 1024), (8, 25, 896),
                (2, 25, 1024))
FLASH_MAIN = (8, 12, 896)
LONG_PROMPT, LONG_NEW, LONG_NEW_1558M = 896, 128, 32


def flash_cost(B, NH, T, HS=64):
    """(bytes, operations) of one causal flash call: q, k, v read and out
    written once in bf16; the two products over the key/query pairs at or
    below the diagonal."""
    return 4 * B * NH * T * HS * 2, 4 * HS * B * NH * T * (T + 1) // 2


@contextlib.contextmanager
def counting_calls(torch, module, name):
    """Count the calls of module.name (the engine's prefill waves), with
    a pair of CUDA events around each: after the run, ``calls[1]`` holds
    them and ``device_ms_of`` turns them into the device ms of each call
    (it synchronizes)."""
    fn, calls = getattr(module, name), [0, []]   # count, [(start, end)]

    def counted(*a, **kw):
        calls[0] += 1
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = fn(*a, **kw)
        ev[1].record()
        calls[1].append(ev)
        return out

    setattr(module, name, counted)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def device_ms_of(torch, events):
    """Device ms between each (start, end) pair of CUDA events."""
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in events]


def qkv_views(torch, B, NH, T, g, device):
    """q, k, v as the model hands them over: the (B, NH, T, 64) views of
    one (B, T, 3 NH 64) qkv buffer, N(0, 1) bf16."""
    buf = torch.randn((B, T, 3 * NH * 64), generator=g,
                      device=device).bfloat16()
    return [x.reshape(B, T, NH, 64).transpose(1, 2)
            for x in buf.split(NH * 64, dim=-1)]


def flash_build_report(device):
    """What csrc/flash_attention.cu compiles to (ops/dev/sass_report.py:
    -Xptxas -v and cuobjdump): its registers, static and dynamic shared
    memory, spills, HGMMA, HMMA and UTMALDG counts; fails unless the
    kernel is on wgmma (HGMMA > 0, HMMA = 0) and TMA (UTMALDG > 0)."""
    import ctypes
    from llmc_paged_tpu_torch.ops import _build
    from llmc_paged_tpu_torch.ops.dev import sass_report
    recs = [r for r in sass_report.compile_report(_build.CSRC,
                                                  "flash_attention")
            if "flash_fwd_kernel" in r["demangled"]]
    check(len(recs) == 1, f"sass_report: {len(recs)} flash kernels")
    r = recs[0]
    dyn = ctypes.CDLL(_build.build("flash_attention")) \
        .causal_attention_flash_smem_bytes()
    log(f"  flash kernel: {r['registers']} registers, {r['smem']} B static "
        f"+ {dyn} B dynamic shared memory, spill {r['spill_stores']}/"
        f"{r['spill_loads']} B, HGMMA {r['hgmma']}, HMMA {r['hmma']}, "
        f"UTMALDG {r['utmaldg']}, {r['instructions']} instructions")
    check(r["hgmma"] > 0 and r["hmma"] == 0 and r["utmaldg"] > 0,
          "flash kernel: want HGMMA > 0, HMMA = 0 and UTMALDG > 0")


def flash_check(torch, q, k, v, what):
    """The flash kernel on q, k, v against its plain version (within
    2^-7 |plain| + 2e-3) and the f32 dense attention (within 2e-2).
    Returns (kernel output, plain output, max |kernel - plain|, max
    |kernel - f32 dense|)."""
    from llmc_paged_tpu_torch.ops import flash_attention as fa
    from llmc_paged_tpu_torch.ops.layers import causal_attention
    got = fa.causal_attention_flash(q, k, v)
    plain = fa.causal_attention_flash_ref(q, k, v)
    dense32 = causal_attention(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    d = (got.float() - plain.float()).abs()
    err, err32 = float(d.max()), float((got.float() - dense32).abs().max())
    check(bool((d <= 2.0 ** -7 * plain.float().abs() + 2e-3).all())
          and bool(torch.isfinite(got).all()),
          f"flash {what}: |kernel - plain| {err:.3e} above 2^-7 |plain| "
          "+ 2e-3")
    check(err32 <= 2e-2, f"flash {what}: {err32:.3e} from the f32 dense "
          "attention (tol 2e-2)")
    return got, plain, err, err32


def flash_kernel_checks(torch, device):
    """Item 1: the kernel against its plain version and the f32 dense
    attention at FLASH_SHAPES, on contiguous heads and on the qkv views
    the model hands over (the output's (B, T, C) reshape a view of it),
    its refusals, what it compiles to, and, on the qkv views, its time
    beside the plain version's, the dense bf16 route's, SDPA's flash
    backend (the yardstick) and the bound. Returns the FLASH_MAIN record,
    taken on the qkv views."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from llmc_paged_tpu_torch.ops import flash_attention as fa
    from llmc_paged_tpu_torch.ops.layers import causal_attention
    flash_build_report(device)
    g = torch.Generator(device=device)
    main = None
    for B, NH, T in FLASH_SHAPES:
        g.manual_seed(B * 1000 + NH * 10 + T)
        q, k, v = (torch.randn((B, NH, T, 64), generator=g, device=device)
                   .bfloat16() for _ in range(3))
        _, _, err, err32 = flash_check(torch, q, k, v, f"({B}, {NH}, {T})")
        cms = device_ms(lambda: fa.causal_attention_flash(q, k, v))
        log(f"  flash ({B}, {NH}, {T}) on contiguous heads: |kernel - "
            f"plain| {err:.3e}, |kernel - f32 dense| {err32:.3e}, "
            f"{cms * 1e3:.2f} us a call")
        del q, k, v
        # as the main path sends them: the views of one qkv buffer
        q, k, v = qkv_views(torch, B, NH, T, g, device)
        got, plain, err, err32 = flash_check(
            torch, q, k, v, f"({B}, {NH}, {T}) on qkv views")
        flat = got.transpose(1, 2).reshape(B, T, NH * 64)
        check(flat.data_ptr() == got.data_ptr() and flat.is_contiguous(),
              "flash: the output's (B, T, C) reshape is not a view")

        def sdpa():
            with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                return F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=True)

        lib_err = float((sdpa().float() - plain.float()).abs().max())
        ms = device_ms(lambda: fa.causal_attention_flash(q, k, v))
        plain_ms = device_ms(lambda: fa.causal_attention_flash_ref(q, k, v),
                             iters=5)
        dense_ms = device_ms(lambda: causal_attention(q, k, v), iters=20)
        lib_ms = device_ms(sdpa)
        nbytes, ops = flash_cost(B, NH, T)
        t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_BF16_OPS_S * 1e3
        rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        log(f"  flash ({B}, {NH}, {T}, 64) bf16 on qkv views: |kernel - "
            f"plain| {err:.3e}, |kernel - f32 dense| {err32:.3e}, |SDPA - "
            f"plain| {lib_err:.3e}; the output's (B, T, C) reshape is a "
            f"view; us a call: kernel {ms * 1e3:.2f}, plain "
            f"{plain_ms * 1e3:.2f}, dense bf16 {dense_ms * 1e3:.2f}, SDPA "
            f"flash {lib_ms * 1e3:.2f}, bound {rec['bound_ms'] * 1e3:.2f} by "
            f"{rec['bound_by']} ({nbytes} B at 3.35 TB/s "
            f"{t_bytes * 1e3:.2f} us, {ops} ops at 989 TFLOP/s "
            f"{t_ops * 1e3:.2f} us)")
        if (B, NH, T) == FLASH_MAIN:
            main = rec
        del q, k, v, got, plain, flat
    # refusals: no launch, no fallback
    before = flash_launches()
    q = torch.randn((2, 3, 384, 64), device=device).bfloat16()
    for what, args in (
            ("f32 q", (q.float(), q, q)),
            ("HS 128", (torch.cat([q, q], -1),) * 3),
            ("T 400", (torch.randn((2, 3, 400, 64), device=device)
                       .bfloat16(),) * 3),
            ("non-contiguous k", (q, q.transpose(2, 3).contiguous()
                                  .transpose(2, 3), q)),
            ("a token stride of 68", (q, torch.randn(
                (2, 3, 384, 68), device=device).bfloat16()[..., :64], q)),
            ("a base 8 bytes off", (q, torch.randn(
                (2, 384, 3 * 64 + 8), device=device).bfloat16()
                [..., 4:4 + 3 * 64].reshape(2, 384, 3, 64).transpose(1, 2),
                q))):
        try:
            fa.causal_attention_flash(*args)
        except (TypeError, ValueError):
            continue
        raise Failed(f"flash: {what} was not refused")
    check(flash_launches() == before, "flash: a refused call launched")
    log("  flash refuses f32 q, HS 128, T 400, a k whose last dim is not "
        "contiguous, a token stride of 68 elements and a base 8 bytes off")
    return main


def long_prefill(torch, params, cfg, xs, kv, use_kernel, device):
    """One prefill_paged of 8 x T prompts into a fresh pool of ``kv``
    pages (ps 128); returns the last positions' f32 logits."""
    from llmc_paged_tpu_torch.config import PageConfig
    from llmc_paged_tpu_torch.kv.layouts import init_pool, token_coords
    from llmc_paged_tpu_torch.models import gpt2_paged
    B, T = xs.shape
    pps = -(-T // 128)
    page = PageConfig(page_size=128, num_pages=B * pps + 4, max_seqs=B,
                      pages_per_seq=pps)
    tables = torch.arange(B * pps, dtype=torch.int32).reshape(B, pps)
    pos = torch.arange(T, dtype=torch.int32).repeat(B, 1)
    pg, sl = token_coords(tables, pos, 128, torch.ones(B, T, dtype=bool),
                          page.num_pages)
    pool = init_pool(cfg, page, dtype=kv, device=device)
    logits, _ = gpt2_paged.prefill_paged(
        params, xs, pg, sl, pool, cfg, last_pos=torch.full((B,), T - 1),
        use_kernel=use_kernel)
    return logits.float()


@contextlib.contextmanager
def dense_prefill():
    """The prefill attention kept dense whatever the rule says (the decode
    kernels untouched): the route before the flash kernel existed."""
    from llmc_paged_tpu_torch.ops import layers
    rule = layers.takes_flash
    layers.takes_flash = lambda q, use_kernel=True: False
    try:
        yield
    finally:
        layers.takes_flash = rule


# the long-context engine's routes: (label, use_kernel, dense prefill)
LONG_ROUTES = (("kernel route", True, False),
               ("dense prefill, decode kernels", True, True),
               ("use_kernel=False", False, False))


def log_prefill_times(torch, model, params, cfg, xs, device):
    """ms a prefill_paged call (bf16 weights, int8 pool) on the kernel
    route and the dense route, in turns (kernel, dense, dense, kernel),
    each by the probe's measure: one warm-up and 2 timed calls, host
    clock and CUDA events behind a sleep."""
    from llmc_paged_tpu_torch.ops.dev.probe_decode import measure
    cells = []
    for use_kernel in (True, False, False, True):
        t = measure(lambda: long_prefill(torch, params, cfg, xs, "int8",
                                         use_kernel, device),
                    torch.device(device), 2)
        cells.append(
            f"{'kernel' if use_kernel else 'dense'} {t['host_ms']:.2f} / "
            f"{t['device_ms']:.2f}"
            + ("" if t["covered"] else " (events not covered: an upper "
               "bound)"))
    B, T = xs.shape
    log(f"  {model} prefill {B} x {T}, bf16 weights + int8 pool, ms a call "
        f"(host clock / CUDA events behind a sleep), in turns: "
        + "; ".join(cells))


def long_engine(torch, pa, params32, cfg, prompts, new, device):
    """The long-context engine (int8 weights and KV, bf16 activations and
    prefill copy, ps 128, pps 9, 8 x 9 + 4 pages, chunks of 16, greedy)
    on each of LONG_ROUTES, a warm-up run before each; checks every
    request's length and the flash launches (L x prefill waves on the
    kernel route, none elsewhere); logs TTFT and tok/s. Returns the
    kernel route's flash launches."""
    from llmc_paged_tpu_torch.models import gpt2_paged
    kw = dict(kv_dtype="int8", param_dtype="int8", num_pages=8 * 9 + 4,
              pps=9)
    L = cfg.num_layers
    out = {}
    for label, use_kernel, dense in LONG_ROUTES:
        eng = make_engine(params32, cfg, use_kernel=use_kernel,
                          device=device, **kw)
        with dense_prefill() if dense else contextlib.nullcontext():
            serve(torch, params32, cfg, prompts=prompts, new=4, engine=eng,
                  **kw)                                 # warm-up
            reset_counts(pa)
            with counting_calls(torch, gpt2_paged,
                                "prefill_paged") as waves:
                eng, done = serve(torch, params32, cfg, prompts=prompts,
                                  new=new, engine=eng, **kw)
        st, fl, w = eng.stats, flash_launches(), waves[0]
        wave_ms = device_ms_of(torch, waves[1])
        out[label] = done
        del eng
        check(len(done) == 8 and all(len(r.generated) == new
                                     for r in done),
              f"long context ({label}): not every request finished with "
              f"{new} tokens")
        want = L * w if label == "kernel route" else 0
        check(w >= 1 and fl == want,
              f"long context ({label}): {fl} flash launches for {w} "
              f"prefill wave(s), want {want}")
        if label == "kernel route":
            launches = fl
        log(f"  {label}: p50_ttft_s {st['p50_ttft_s']:.4f}, "
            f"decode_tok_per_s {st['decode_tok_per_s']:.1f}, "
            f"t_prefill_dispatch_s {st['t_prefill_dispatch_s']}, wall "
            f"{st['wall_s']:.3f} s, flash launches {fl} ({w} prefill "
            "wave(s); device ms a wave, CUDA events around prefill_paged: "
            + ", ".join(f"{x:.2f}" for x in wave_ms) + ")")
    same = [sum(a.generated == b.generated
                for a, b in zip(out["kernel route"], out[label]))
            for label, _, _ in LONG_ROUTES[1:]]
    log(f"  streams equal to the kernel route's over {new} tokens: "
        f"{same[0]}/8 with a dense prefill, {same[1]}/8 with "
        "use_kernel=False (not required: bf16 rounds elsewhere, int8 KV "
        "moves by a step)")
    return launches


def phase_long_prefill(torch, pa, params32, cfg, device):
    """Phase 14: the long-prompt bf16 prefill through the flash kernel.
    Returns the kernel's JSON record (launches from the 124M
    long-context engine's kernel route)."""
    from llmc_paged_tpu_torch.config import GPT2Config
    from llmc_paged_tpu_torch.models import gpt2
    rec = flash_kernel_checks(torch, device)
    L, V = cfg.num_layers, cfg.vocab_size

    # 2-3. routing and accuracy of the whole 124M prefill at 8 x 896
    xs = torch.tensor(prompts_for(torch, 8, [LONG_PROMPT] * 8, V, 6,
                                  device), dtype=torch.int32)
    p_bf16 = gpt2.to_device(params32, cfg, torch.bfloat16, device)
    reset_counts(pa)
    ref = long_prefill(torch, params32, cfg, xs, "float32", True, device)
    check(flash_launches() == 0, f"fp32 prefill at T = {LONG_PROMPT}: "
          f"{flash_launches()} flash launches (want 0)")
    lk = long_prefill(torch, p_bf16, cfg, xs, "int8", True, device)
    check(flash_launches() == L, f"bf16 prefill at T = {LONG_PROMPT}: "
          f"{flash_launches()} flash launches (want L = {L})")
    ld = long_prefill(torch, p_bf16, cfg, xs, "int8", False, device)
    check(flash_launches() == L, "use_kernel=False bf16 prefill launched "
          "the flash kernel")
    torch.cuda.synchronize()
    dk = float((lk - ref).abs().max())
    dd = float((ld - ref).abs().max())
    agree_k = int((lk.argmax(-1) == ref.argmax(-1)).sum())
    agree_d = int((ld.argmax(-1) == ref.argmax(-1)).sum())
    log(f"  124M prefill 8 x {LONG_PROMPT}, bf16 weights + int8 pool, "
        f"last-position logits vs f32 weights + f32 pool: kernel route "
        f"max|d| {dk:.4e} ({agree_k}/8 argmax agree), dense route "
        f"{dd:.4e} ({agree_d}/8); flash launches: f32 0, kernel {L}, "
        "use_kernel=False 0")
    check(bool(torch.isfinite(lk).all()) and dk <= 1.25 * dd + 1e-3,
          f"124M prefill: the kernel route is {dk:.4e} from f32, the dense "
          f"route {dd:.4e} (want <= 1.25 x dense + 1e-3)")
    log_prefill_times(torch, "124M", p_bf16, cfg, xs, device)
    del ref, lk, ld, p_bf16

    # 4. the long-context engine at 124M on its three routes
    lprompts = prompts_for(torch, 8, [LONG_PROMPT] * 8, V, 7, device)
    rec["launches"] = long_engine(torch, pa, params32, cfg, lprompts,
                                  LONG_NEW, device)

    # 5. 1558M: one prefill on both routes, then the engine's three
    cfg15 = GPT2Config.gpt2_1558m()
    g = torch.Generator(device=device)
    g.manual_seed(0)
    p15 = gpt2.init_params(cfg15, g, device=device)
    p15b = gpt2.to_device(p15, cfg15, torch.bfloat16, device)
    xs15 = torch.tensor(prompts_for(torch, 8, [LONG_PROMPT] * 8,
                                    cfg15.vocab_size, 6, device),
                        dtype=torch.int32)
    reset_counts(pa)
    long_prefill(torch, p15b, cfg15, xs15, "int8", True, device)
    torch.cuda.synchronize()
    check(flash_launches() == cfg15.num_layers,
          f"1558M prefill: {flash_launches()} flash launches (want "
          f"{cfg15.num_layers})")
    log_prefill_times(torch, "1558M", p15b, cfg15, xs15, device)
    del p15b, xs15
    lprompts15 = prompts_for(torch, 8, [LONG_PROMPT] * 8, cfg15.vocab_size,
                             7, device)
    long_engine(torch, pa, p15, cfg15, lprompts15, LONG_NEW_1558M, device)
    del p15
    torch.cuda.empty_cache()
    return rec


# ---- phase 16: the native block manager ------------------------------------

# the manager methods the engine calls, timed on the instance
MANAGER_CALLS = ("append_tokens", "block_table_array", "free_prompt",
                 "seq_len", "num_free", "release_below", "truncate_to",
                 "match_prefix", "adopt", "register_prompt", "num_cached")


def timed_managers(engine):
    """Wrap the methods of every manager ``engine`` serves on (its
    _paged_state, on the instance) with a host clock. Returns a dict
    that accumulates seconds, calls and the managers' types; a manager
    kept across runs (prefix caching) is wrapped once."""
    acc = dict(s=0.0, calls=0, kinds=[])
    real = engine._paged_state

    def wrap(fn):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc["s"] += time.perf_counter() - t0
                acc["calls"] += 1
        return timed

    def paged_state():
        mgr, pool = real()
        acc["kinds"].append(type(mgr).__name__)
        if not getattr(mgr, "_timed", False):
            for name in MANAGER_CALLS:
                if hasattr(mgr, name):
                    setattr(mgr, name, wrap(getattr(mgr, name)))
            mgr._timed = True
        return mgr, pool

    engine._paged_state = paged_state
    return acc


def manager_run(torch, engine, acc, reqs_fn, steps_key="decode_steps",
                sampler=None):
    """One engine.run of reqs_fn()'s requests with the managers timed:
    (streams, stats, manager ms a step, manager calls a step)."""
    acc["s"], acc["calls"] = 0.0, 0
    done = engine.run(reqs_fn(), sampler=sampler)
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    st = dict(engine.stats)
    steps = max(1, st[steps_key])
    return ({r.rid: list(r.generated) for r in done}, st,
            1e3 * acc["s"] / steps, acc["calls"] / steps)


def phase_native_manager(torch, pa, params32, cfg, device):
    """Phase 16: the native block manager (csrc/block_manager.cpp) under
    the engine against the Python one, host-timed; returns nothing,
    raises on a disagreement."""
    from llmc_paged_tpu_torch.config import EngineConfig, PageConfig
    from llmc_paged_tpu_torch.engine.engine import InferenceEngine
    from llmc_paged_tpu_torch.engine.scheduler import Request
    from llmc_paged_tpu_torch.kv import native
    from llmc_paged_tpu_torch.ops import _build
    from llmc_paged_tpu_torch.sampler import Sampler
    L = cfg.num_layers
    # (a) the library (built in phase 2 with the host compiler)
    lib = _build.library_path("block_manager", host=True)
    native.load_library()
    log(f"  (a) native library {os.path.relpath(lib, HERE)}: built in "
        f"{_build.BUILD_SECONDS['block_manager']:.2f} s (g++ "
        f"{' '.join(_build.CXX_FLAGS)})")

    def reqs(prompts, new):
        return lambda: [Request(rid=i, prompt=list(p),
                                max_new_tokens=(new[i] if isinstance(
                                    new, list) else new))
                        for i, p in enumerate(prompts)]

    def line(tag, flag, st, mgr_ms, calls, steps_key="decode_steps"):
        steps = max(1, st[steps_key])
        host_ms = 1e3 * decode_host_s(st) / steps
        log(f"  {tag} {'native' if flag else 'python'}: decode_tok_per_s "
            f"{st['decode_tok_per_s']:.1f}, {steps_key} {st[steps_key]}, "
            f"host {host_ms:.3f} ms a step, manager {mgr_ms:.4f} ms a step "
            f"({calls:.1f} calls, {100 * mgr_ms / host_ms:.2f} % of the "
            f"host's), t_* " + json.dumps(
                {k: v for k, v in st.items() if k.startswith("t_")}))

    # (b) phase 4's engine: native False, True, True, False in turns
    prompts = prompts_for(torch, 8, [128] * 8, cfg.vocab_size, 1, device)
    engines = {}
    for flag in (False, True):
        eng = make_engine(params32, cfg, kv_dtype="int8", param_dtype="int8",
                          num_pages=28, native_manager=flag, device=device)
        acc = timed_managers(eng)
        manager_run(torch, eng, acc, reqs(prompts, 20))          # warm
        engines[flag] = (eng, acc)
    streams, steps = {}, 0
    reset_counts(pa)
    for flag in (False, True, True, False):
        eng, acc = engines[flag]
        out, st, mgr_ms, calls = manager_run(torch, eng, acc,
                                             reqs(prompts, 128))
        steps += st["decode_steps"]
        check(set(acc["kinds"]) == {"NativeBlockManager" if flag
                                    else "BlockManager"},
              f"(b) native_manager={flag} served on {set(acc['kinds'])}")
        check(all(len(v) == 128 for v in out.values()),
              "(b) not every request finished with 128 tokens")
        streams.setdefault(flag, out)
        check(out == streams[flag] == streams[False],
              f"(b) native_manager={flag}: streams differ")
        line("(b) headline", flag, st, mgr_ms, calls)
    check(pa.LAUNCHES["paged_decode_attention_quant_parts"] == L * steps,
          f"(b) {pa.LAUNCHES} launches, want L x {steps} decode steps of "
          "the four runs")
    del engines

    # (c) phase 9's engine settings: ps 32, fp32, seed 1337, top-k 40,
    # host sampling (every step a single-token step)
    cprompts = prompts_for(torch, 8, [64] * 8, cfg.vocab_size, 6, device)
    page = PageConfig(page_size=32, num_pages=128, max_seqs=8,
                      pages_per_seq=32, kv_dtype="float32")
    econf = EngineConfig(cache_mode="paged", page=page, max_batch=8,
                         seed=1337, greedy=False, top_k=40)
    cli_streams = {}
    for flag in (False, True):
        eng = InferenceEngine(params32, cfg, econf, device=device,
                              native_manager=flag)
        acc = timed_managers(eng)
        out, st, mgr_ms, calls = manager_run(
            torch, eng, acc, reqs(cprompts, 64), "single_steps",
            sampler=Sampler(1337, top_k=40))
        check(st["single_steps"] > 0 and all(len(v) == 64
                                             for v in out.values()),
              f"(c) native_manager={flag}: {st['single_steps']} single "
              "steps, or a short stream")
        cli_streams[flag] = out
        line("(c) cli settings", flag, st, mgr_ms, calls, "single_steps")
    check(cli_streams[True] == cli_streams[False],
          "(c) native and python streams differ")

    # (d) a pool small enough to preempt: phase 6's loaded queue
    lens = [30, 200, 60, 150, 100, 250, 20, 180, 90, 220, 40, 130, 70, 240,
            10, 160]
    news = [100, 60, 120, 80, 40, 90, 110, 50, 70, 30, 120, 100, 60, 80,
            120, 40]
    qprompts = prompts_for(torch, 16, lens, cfg.vocab_size, 2, device)
    qruns = {}
    for flag in (False, True):
        eng = make_engine(params32, cfg, kv_dtype="int8", param_dtype="int8",
                          num_pages=10, native_manager=flag, device=device)
        acc = timed_managers(eng)
        out, st, mgr_ms, calls = manager_run(torch, eng, acc,
                                             reqs(qprompts, news))
        qruns[flag] = (out, st["preemptions"], st["peak_pages_used"])
        line(f"(d) preempting queue (preemptions {st['preemptions']})", flag,
             st, mgr_ms, calls)
    check(qruns[True] == qruns[False] and qruns[True][1] > 0,
          f"(d) streams/preemptions/peak pages differ or no preemption: "
          f"{qruns[True][1:]} vs {qruns[False][1:]}")

    # (e) phase 8's prefix caching, cold then adopting, on the native
    # prefix manager against the Python one
    sys_prompt = prompts_for(torch, 1, [256], cfg.vocab_size, 4, device)[0]
    tails = prompts_for(torch, 8, [32] * 8, cfg.vocab_size, 5, device)
    pprompts = [sys_prompt + t for t in tails]
    prefix_keys = ("prefix_hit_tokens", "prefix_hit_pages",
                   "prefix_pages_registered", "prefix_cached_pages",
                   "suffix_prefills")
    pruns = {}
    for flag in (False, True):
        eng = make_engine(params32, cfg, kv_dtype="int8", param_dtype="int8",
                          num_pages=40, pps=4, prefix=True,
                          native_manager=flag, device=device)
        acc = timed_managers(eng)
        pruns[flag] = []
        for run in (1, 2):
            out, st, mgr_ms, calls = manager_run(torch, eng, acc,
                                                 reqs(pprompts, 64))
            pruns[flag].append((out, {k: st[k] for k in prefix_keys}))
            line(f"(e) prefix run {run} ({pruns[flag][-1][1]})", flag, st,
                 mgr_ms, calls)
        check(set(acc["kinds"]) == {"NativePrefixCachingBlockManager"
                                    if flag else
                                    "PrefixCachingBlockManager"},
              f"(e) native_manager={flag} served on {set(acc['kinds'])}")
    check(pruns[True] == pruns[False]
          and pruns[True][1][1]["prefix_hit_pages"] == 16,
          "(e) native prefix runs differ from the python ones, or run 2 "
          "adopted no 16 pages")

    # (f) the default (native_manager=None) builds native managers
    made = []
    real = native.make_block_manager

    def spy(*a, **kw):
        mgr = real(*a, **kw)
        made.append(type(mgr).__name__)
        return mgr

    native.make_block_manager = spy
    try:
        serve(torch, params32, cfg, prompts=prompts, new=16, kv_dtype="int8",
              param_dtype="int8", num_pages=28, device=device)
        serve(torch, params32, cfg, prompts=pprompts, new=16,
              kv_dtype="int8", param_dtype="int8", num_pages=40, pps=4,
              prefix=True, device=device)
    finally:
        native.make_block_manager = real
    check(made == ["NativeBlockManager", "NativePrefixCachingBlockManager"],
          f"(f) the default engine built {made}")
    log(f"  (f) native_manager=None built {made}")


# ---- phase 17: tensor and data parallelism -----------------------------------

PAR_SEED = 17              # the weights every rank and the parent draw
PAR_TASKS = "llmc_paged_tpu_torch.parallel.mp_dryrun:"
NEAR_TIE = 1e-4            # the top-2 logit gap where two streams may part
# the largest TP-vs-one-rank logit difference before a parting, on the
# decode steps and on the prefill wave: fp32 sums in another order; for
# the int8 headline, with its bf16 prefill copy and bf16-rounded
# activations, about twice the largest seen on an H100 (decode 8.48e-3
# over gloo, 7.06e-3 over NCCL; prefill 1.562e-2 on both)
NOISE_CAP = {"float32": {"decode": 1e-4, "prefill": 1e-4},
             "int8": {"decode": 0.017, "prefill": 0.032}}


def sync(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def rank_kernels(heads):
    """Rank target (imported by name in each rank process): this rank's
    single- and multi-query parts kernels, int8 pool under bf16 q and f32
    pool under f32 q, at the headline decode and spec-verify shapes with
    ``heads`` heads, against their plain versions at phase 3's tolerance;
    [(wrapper, [max |Δ| of acc, m, l], ok)]."""
    import torch

    from llmc_paged_tpu_torch.ops import paged_attention as pa
    from llmc_paged_tpu_torch.parallel.mp_dryrun import rank_device
    dev = rank_device()
    out = []
    for (kv, qd), (_, case) in ((pq, c) for pq in (("int8", "bf16"),
                                                   ("f32", "f32"))
                                for c in (SQ_CASES[0], MQ_CASES[0])):
        q, pool, tables, lengths, starts = make_case(
            torch, NH=heads, HS=64, kv=kv, qd=qd, seed=1700, device=dev,
            **case)
        got = run_parts(pa, q, pool, tables, lengths, starts)
        ref = run_parts(pa, q, pool, tables, lengths, starts, plain=True)
        sync(torch, dev)
        errs, ok = max_err(torch, got, ref)
        ok = ok and all(bool(torch.isfinite(t).all()) for t in got)
        out.append((wrapper_name(q, pool), errs, ok))
    return out


def rank_collectives(rows, width, gather_width, iters=100):
    """Rank target: host ms of one all-reduce of (rows, width) f32 and of
    one all-gather of (rows, gather_width) f32 blocks over all ranks, on
    this rank's device, each the mean of ``iters`` calls that end in a
    synchronize (the TP decode step's shapes: the residual and the
    vocab shard of the logits)."""
    import torch
    import torch.distributed as dist

    from llmc_paged_tpu_torch.parallel.mp_dryrun import rank_device
    dev = rank_device()
    x = torch.ones(rows, width, device=dev)
    block = torch.ones(rows, gather_width, device=dev)
    buf = torch.empty(dist.get_world_size(), rows, gather_width, device=dev)

    def timed(fn):
        fn()
        sync(torch, dev)
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync(torch, dev)
        return (time.perf_counter() - t0) / iters * 1e3

    return (timed(lambda: dist.all_reduce(x)),
            timed(lambda: dist.all_gather(list(buf.unbind(0)), block)))


def first_parting(a, b):
    """[(rid, k)]: each row whose generated streams part, and the index of
    the first generated token where they do."""
    out = []
    for rid in sorted(a):
        ga, gb = a[rid], b[rid]
        k = next((i for i, (x, y) in enumerate(zip(ga, gb)) if x != y), None)
        if k is not None or len(ga) != len(gb):
            out.append((rid, k if k is not None else min(len(ga), len(gb))))
    return out


def check_streams(what, got, want, top2, card, top2_got=None, cap=None):
    """``got`` equals ``want`` (generated tokens by rid), or each row parts
    only at a near-tie: the two top logits of the ``want`` run (``top2``:
    one (B, 2) array a logits call, the prefill wave, then each chunk
    step, every row in lockstep) within a bound at that step. The bound
    is NEAR_TIE or, where both runs were recorded, twice their measured
    logit noise if that is larger: the largest difference of the two
    runs' top-1 and top-2 logits over the decode steps before each row
    parts (the prefill's for a parting at the first token), where both
    runs had the same context (sorted values move no more than the
    logits do, and a pick can flip only where the gap is below twice
    the logits' difference). The noise of each kind must stay within
    ``cap`` ({"decode": x, "prefill": y}). Prints every parting, its gap
    and the noise, then checks."""
    parts = first_parting(got, want)
    noise = {"decode": 0.0, "prefill": 0.0}
    if top2_got is not None:
        stop = dict(parts)
        for rid in got:
            k = stop.get(rid, min(len(top2), len(top2_got)))
            for j, (a, b) in enumerate(zip(top2[:k], top2_got[:k])):
                kind = "prefill" if j == 0 else "decode"
                noise[kind] = max(noise[kind], float(abs(a[rid] - b[rid])
                                                     .max()))
    gaps = []
    for rid, k in parts:
        gap = float(top2[k][rid, 0] - top2[k][rid, 1])
        bound = max(NEAR_TIE, 2 * noise["prefill" if k == 0 else "decode"])
        gaps.append((rid, k, gap, bound))
    log(f"  {what}: {len(got) - len(parts)}/{len(got)} streams identical"
        + "".join(f"; row {rid} parts at generated token {k}, top-2 gap "
                  f"{gap:.3e}" for rid, k, gap, _ in gaps)
        + (f"; logit noise before parting: decode steps "
           f"{noise['decode']:.3e}, prefill {noise['prefill']:.3e}"
           if top2_got is not None else "")
        + f" [{card}]")
    if top2_got is not None:
        for kind, v in noise.items():
            check(v <= cap[kind],
                  f"{what}: the runs' {kind} logits differ by {v:.3e} > "
                  f"{cap[kind]:g} where their contexts are the same")
    for rid, k, gap, bound in gaps:
        check(gap <= bound,
              f"{what}: row {rid} parts at generated token {k} where the "
              f"top-2 logit gap is {gap:.3e} > {bound:.3e}")


def generated(streams, reqs):
    return {r["rid"]: streams[r["rid"]][len(r["prompt"]):] for r in reqs}


def single_run(torch, params, cfg, reqs, device, record=False, **kw):
    """The parent's single-rank engine on ``device`` over ``reqs``: (the
    engine, its generated streams, top-2 records of a recorded run)."""
    from llmc_paged_tpu_torch.engine.scheduler import Request
    from llmc_paged_tpu_torch.parallel.mp_dryrun import TopTwo
    eng = make_engine(params, cfg, device=device, **kw)
    top2 = None
    if record:
        top2 = eng._model = TopTwo(eng._model)
    done = eng.run([Request(**r) for r in reqs])
    sync(torch, device)
    return eng, {r.rid: list(r.generated) for r in done}, (
        top2.calls if top2 else None)


def prefill_wave_ms(torch, eng, reqs, reps=3):
    """Device ms of the prefill wave of ``reqs`` on ``eng`` (CUDA events
    around gpt2_paged.prefill_paged; the requests cut to one new token),
    the median of ``reps`` runs after a warm one."""
    from llmc_paged_tpu_torch.engine.scheduler import Request
    from llmc_paged_tpu_torch.models import gpt2_paged

    def run():
        eng.run([Request(**dict(r, max_new_tokens=1)) for r in reqs])
    run()
    with counting_calls(torch, gpt2_paged, "prefill_paged") as calls:
        for _ in range(reps):
            run()
    ms = device_ms_of(torch, calls[1])
    check(len(ms) == reps, f"prefill waves: {len(ms)} in {reps} runs")
    return sorted(ms)[reps // 2]


def rank_prefill_ms(seed, cfg, econf, reqs):
    """Rank target: ``prefill_wave_ms`` of an engine on this rank's card,
    on the weights drawn from ``seed`` on the CPU."""
    import torch

    from llmc_paged_tpu_torch.engine.engine import InferenceEngine
    from llmc_paged_tpu_torch.models import gpt2
    from llmc_paged_tpu_torch.parallel.mp_dryrun import rank_device
    params = gpt2.init_params(cfg, torch.Generator().manual_seed(seed),
                              device="cpu")
    eng = InferenceEngine(params, cfg, econf, device=rank_device())
    return prefill_wave_ms(torch, eng, reqs)


def host_ms_step(st):
    """Host ms to enqueue one decode step: the chained steps' model.step
    span where the run chained, else the single-token steps' dispatch."""
    step = st["spans"].get("model.step")
    if step:
        return 1e3 * step["s"] / step["n"]
    return 1e3 * st["t_step_dispatch_s"] / max(1, st["single_steps"])


def decode_host_s(st):
    """Host seconds of a run's decode, each counted once: its links' and
    single steps' own dispatch, the chained steps' enqueue and every
    blocking device-to-host fetch."""
    return (st["t_chain_dispatch_s"] + st["t_step_dispatch_s"]
            + st["spans"].get("model.step", {}).get("s", 0.0)
            + st["t_materialize_s"])


def par_requests(prompts, new):
    return [dict(rid=i, prompt=list(p), max_new_tokens=new)
            for i, p in enumerate(prompts)]


def par_econf(kv_dtype, param_dtype, num_pages, pps=3, mesh=None, **kw):
    """phase 4's EngineConfig (make_engine's) with ``mesh_shape``."""
    from llmc_paged_tpu_torch.config import EngineConfig, PageConfig
    quant = param_dtype == "int8"
    return EngineConfig(
        cache_mode="paged", page=PageConfig(
            page_size=128, num_pages=num_pages, max_seqs=8,
            pages_per_seq=pps, kv_dtype=kv_dtype,
            prefix_cache=kw.pop("prefix", False)),
        max_batch=8, greedy=True, decode_chunk=16, param_dtype=param_dtype,
        activation_dtype="bfloat16" if quant else "float32",
        prefill_param_dtype="bfloat16" if quant else None, spec_ngram=3,
        mesh_shape=mesh, **kw)


def phase_parallel(torch, pa, card):
    """Phase 17 (module docstring): the single-rank references in this
    process on the card, then leg (a), two ranks sharing the card over
    gloo, and leg (b), NCCL over min(4, cards) cards where there are two
    or more."""
    import numpy as np

    from llmc_paged_tpu_torch.config import GPT2Config
    from llmc_paged_tpu_torch.engine.scheduler import Request
    from llmc_paged_tpu_torch.models import gpt2
    from llmc_paged_tpu_torch.parallel.mp_dryrun import TopTwo, weight_bytes
    device = "cuda"
    cfg = GPT2Config.gpt2_124m()
    params = gpt2.init_params(cfg, torch.Generator().manual_seed(PAR_SEED),
                              device="cpu")
    prompts = prompts_for(torch, 8, [128] * 8, cfg.vocab_size, 1, device)
    segs = prompts_for(torch, 4, [32] * 4, cfg.vocab_size, 3, device)
    sys_prompt = prompts_for(torch, 1, [256], cfg.vocab_size, 4, device)[0]
    tails = prompts_for(torch, 8, [32] * 8, cfg.vocab_size, 5, device)
    runs = {
        # name: (requests, engine keywords)
        "int8": (par_requests(prompts, 128),
                 dict(kv_dtype="int8", param_dtype="int8", num_pages=28)),
        "fp32": (par_requests(prompts, 32),
                 dict(kv_dtype="float32", param_dtype="float32",
                      num_pages=28)),
        # fp32, so that the spec and prefix paths part from plain greedy
        # only by sums in another order
        "spec-plain": (par_requests([s * 4 for s in segs], 32),
                       dict(kv_dtype="float32", param_dtype="float32",
                            num_pages=28)),
        "prefix-plain": (par_requests([sys_prompt + t for t in tails], 32),
                         dict(kv_dtype="float32", param_dtype="float32",
                              num_pages=40, pps=4)),
    }
    # the single-rank references (a timed int8 run after a warm one, and a
    # recorded run of each configuration)
    t0 = time.monotonic()
    ref = {}
    reqs, kw = runs["int8"]
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng, gen, _ = single_run(torch, params, cfg, reqs, device, **kw)
    # the timed run records its logits' top two, as the TP run does (a
    # device->host copy a step)
    top2 = eng._model = TopTwo(eng._model)
    done = eng.run([Request(**r) for r in reqs])
    sync(torch, device)
    single_st = dict(eng.stats)
    single_st["weight_bytes"] = weight_bytes(eng)
    single_st["peak_bytes"] = torch.cuda.max_memory_allocated() - held
    ref["int8"] = ({r.rid: list(r.generated) for r in done}, top2.calls)
    eng._model = top2.inner
    single_st["prefill_ms"] = prefill_wave_ms(torch, eng, reqs)
    del eng
    for name, (reqs, kw) in runs.items():
        if name != "int8":
            ref[name] = single_run(torch, params, cfg, reqs, device,
                                   record=True, **kw)[1:]
    check(ref["int8"][0] == gen, "single rank: a second run parted from "
          "the first (the engine is not deterministic)")
    log(f"  single rank ({device}): int8 decode_tok_per_s "
        f"{single_st['decode_tok_per_s']:.1f}, {host_ms_step(single_st):.2f} "
        f"host ms a decode step ({single_st['decode_steps']} steps), "
        f"p50_ttft_s {single_st['p50_ttft_s']:.4f} (the prefill wave and "
        f"the first chunk), a prefill wave {single_st['prefill_ms']:.2f} "
        f"device ms; weights "
        f"{mib(single_st['weight_bytes'])} MiB on the card, peak "
        f"{mib(single_st['peak_bytes'])} MiB above what the process held; "
        f"references {time.monotonic() - t0:.1f} s [{card}]")
    # the DP reference: two AdamW steps on the whole batch, fp32
    rng = np.random.default_rng(PAR_SEED)
    x = rng.integers(0, cfg.vocab_size, (4, 64)).astype(np.int64)
    y = rng.integers(0, cfg.vocab_size, (4, 64)).astype(np.int64)
    leaves = {k: v.requires_grad_(True) for k, v in
              gpt2.to_device(params, cfg, device=device).items()}
    opt = torch.optim.AdamW(leaves.values(), lr=1e-4, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=0.0)
    dp_want = []
    for _ in range(2):
        opt.zero_grad(set_to_none=True)
        loss = gpt2.loss_fn(leaves, x, y, cfg)
        loss.backward()
        opt.step()
        dp_want.append(float(loss.detach()))
    del leaves, opt

    n_cards = torch.cuda.device_count()
    legs = [("a", 2, "gloo", "cuda:0")]
    if n_cards >= 2:
        legs.append(("b", min(4, n_cards), "nccl", "cuda"))
    else:
        log(f"  (b) NCCL across cards: not run ({n_cards} card; NCCL takes "
            f"one rank a card) [{card}]")
    for n in sorted({n for _, n, _, _ in legs}):
        local_head_times(torch, pa, cfg.num_heads // n, device, card)
        row_parallel_product(torch, cfg, n, card)
    for leg, n, backend, dev in legs:
        parallel_leg(torch, cfg, runs, ref, single_st, dp_want, (x, y), leg,
                     n, backend, dev, card)


def local_head_times(torch, pa, heads, device, card):
    """The parts kernels at a TP rank's head count: the headline decode
    shape (int8 pool under bf16 q, f32 under f32) and the spec-verify
    shape, each beside its plain version and its bound (phase 3's
    timer and cost model)."""
    for (kv, qd), (name, case) in ((pq, c) for pq in (("int8", "bf16"),
                                                      ("f32", "f32"))
                                   for c in (SQ_CASES[0], MQ_CASES[0])):
        args = make_case(torch, NH=heads, HS=64, kv=kv, qd=qd, seed=1701,
                         device=device, **case)
        t = time_case(torch, pa, *args)
        log(f"  parts kernel at {heads} heads, {kv}/q{qd} {name} "
            f"(B=8, NH={heads}, HS=64): kernel {t['ms'] * 1e3:.2f} us, "
            f"plain {t['plain_ms'] * 1e3:.2f} us, bound "
            f"{t['bound_ms'] * 1e3:.3f} us by {t['bound_by']} [{card}]")


def row_parallel_product(torch, cfg, ranks, card):
    """The TP prefill's row-parallel product (fcproj, the bf16 prefill
    copy, 8 x 128 rows) on the card: sharding._f32_product, a bf16 GEMM
    with an f32 output, against the f32 product of the upcast operands
    (phase 3's tolerance), timed beside that upcast route and beside one
    device's bf16 linear of the whole width (device ms, the lab timer)."""
    from llmc_paged_tpu_torch.ops import layers
    from llmc_paged_tpu_torch.parallel.sharding import _f32_product
    g = torch.Generator(device="cuda").manual_seed(1702)
    C, rows = cfg.channels, 8 * 128
    x = torch.randn(rows, 4 * C, device="cuda", generator=g).bfloat16()
    w = (0.02 * torch.randn(C, 4 * C, device="cuda", generator=g)).bfloat16()
    xs, ws = x[:, : 4 * C // ranks], w[:, : 4 * C // ranks].contiguous()
    got = _f32_product(xs, ws)
    ref = torch.matmul(xs.float(), ws.t().float())
    err = float((got - ref).abs().max())
    check(bool(((got - ref).abs() <= TOL_ABS + TOL_REL * ref.abs()).all()),
          f"row-parallel product: bf16 GEMM with f32 output vs the upcast "
          f"product: max|d| {err:.3e}")
    ms = device_ms(lambda: _f32_product(xs, ws))
    up = device_ms(lambda: torch.matmul(xs.float(), ws.t().float()))
    one = device_ms(lambda: layers.linear(x, w))
    log(f"  row-parallel fcproj product at {ranks} ranks ({rows}, "
        f"{4 * C // ranks}) x ({C}, {4 * C // ranks}) bf16: f32 output "
        f"{ms * 1e3:.2f} us (max|d| {err:.3e} from the upcast product, "
        f"{up * 1e3:.2f} us); one device's bf16 linear ({rows}, {4 * C}) "
        f"{one * 1e3:.2f} us [{card}]")


def mib(n):
    return f"{n / 2**20:.1f}"


def parallel_leg(torch, cfg, runs, ref, single_st, dp_want, xy, leg, n,
                 backend, dev, card):
    """One leg of phase 17: ``n`` rank processes over ``backend``, each on
    ``dev`` ("cuda:0": all on one card; "cuda": a card a rank)."""
    from llmc_paged_tpu_torch.parallel.mp_dryrun import RankPool
    L = cfg.num_layers
    heads = cfg.num_heads // n
    what = (f"({leg}) {n} ranks over {backend}"
            + (" sharing one card" if dev == "cuda:0" else ", a card each"))
    t0 = time.monotonic()
    with RankPool(n, backend, dev, timeout_s=600) as pool:
        pool.run(PAR_TASKS + "rank_device")       # every rank has joined
        t_start = time.monotonic() - t0
        mesh = {"model": n}
        # the int8 headline: a short warm run, then a timed run that
        # records its logits' top two
        reqs, kw = runs["int8"]
        res = pool.run(PAR_TASKS + "engine_run", PAR_SEED, cfg,
                       par_econf(mesh=mesh, **kw), reqs, record=True,
                       warm_new=20)
        for r in res[1:]:
            check([x["streams"] for x in r] == [x["streams"]
                                                for x in res[0]],
                  f"{what}: ranks' streams differ")
        timed = rec = res[0][0]
        st = timed["stats"]
        check(all(len(g) == 128 for g in generated(timed["streams"], reqs)
                  .values()), f"{what}: not every row made 128 tokens")
        check_streams(f"{what}: int8 TP vs single-rank streams",
                      generated(timed["streams"], reqs), ref["int8"][0],
                      ref["int8"][1], card, rec["top2"], NOISE_CAP["int8"])
        launches = [r[0]["launches"] for r in res]
        want = L * st["decode_steps"]
        check(all(lc["paged_decode_attention_quant_parts"] == want
                  for lc in launches),
              f"{what}: int8 parts launches {launches}, want L x "
              f"{st['decode_steps']} on every rank")
        coll = timed["collectives"]
        forwards = coll["all_gather"]
        check(coll["all_reduce"] == (2 * L + 1) * forwards,
              f"{what}: collectives {coll}, want 2L + 1 all-reduces a "
              f"forward ({forwards} forwards)")
        log(f"  {what}: int8 TP decode_tok_per_s "
            f"{st['decode_tok_per_s']:.1f} (single rank "
            f"{single_st['decode_tok_per_s']:.1f}), "
            f"{host_ms_step(st):.2f} host ms a decode step (single "
            f"{host_ms_step(single_st):.2f}); p50_ttft_s "
            f"{st['p50_ttft_s']:.4f} (single {single_st['p50_ttft_s']:.4f}); "
            f"{2 * L + 1} all-reduces and 1 "
            f"all-gather a step ({coll['all_reduce']} and {forwards} in "
            f"{forwards} forwards); launches on rank 0 "
            f"{ {k: v for k, v in launches[0].items() if v} } at {heads} "
            f"heads a rank [{card}]")
        log(f"  {what}: int8 weights on the card a rank (MiB): "
            + ", ".join(mib(r[0]["weight_bytes"]) for r in res)
            + f" (single rank {mib(single_st['weight_bytes'])}); peak "
            "allocated a rank process (MiB): "
            + ", ".join(mib(r[0]["peak_bytes"]) for r in res)
            + f" (single rank {mib(single_st['peak_bytes'])} above what its "
            f"process held) [{card}]")
        waves = pool.run("chip_smoke:rank_prefill_ms", PAR_SEED, cfg,
                         par_econf(mesh=mesh, **kw), reqs)
        log(f"  {what}: the int8 prefill wave of 8 x 128 (bf16 prefill "
            f"copy), device ms (CUDA events around prefill_paged, median "
            f"of 3) a rank: " + ", ".join(f"{w:.2f}" for w in waves)
            + f" (single rank {single_st['prefill_ms']:.2f}) [{card}]")
        # fp32 parity, TF32 off
        reqs, kw = runs["fp32"]
        res = pool.run(PAR_TASKS + "engine_run", PAR_SEED, cfg,
                       par_econf(mesh=mesh, **kw), reqs, record=True)
        r0 = res[0][0]
        check(all(r[0]["streams"] == r0["streams"] for r in res),
              f"{what}: fp32 ranks' streams differ")
        check_streams(f"{what}: fp32 TP vs single-rank streams",
                      generated(r0["streams"], reqs), ref["fp32"][0],
                      ref["fp32"][1], card, r0["top2"],
                      NOISE_CAP["float32"])
        check(r0["launches"]["paged_decode_attention_parts"]
              == L * r0["stats"]["decode_steps"],
              f"{what}: fp32 parts launches {r0['launches']}")
        log(f"  {what}: fp32 run: decode_tok_per_s "
            f"{r0['stats']['decode_tok_per_s']:.1f}, decode steps "
            f"{r0['stats']['decode_steps']}, launches on rank 0 "
            f"{ {k: v for k, v in r0['launches'].items() if v} } [{card}]")
        # spec_k=4 and prefix caching against TP plain greedy
        for name, extra, runs_n in (("spec-plain", dict(spec_k=4), 1),
                                    ("prefix-plain", dict(prefix=True), 2)):
            reqs, kw = runs[name]
            plain = pool.run(PAR_TASKS + "engine_run", PAR_SEED, cfg,
                             par_econf(mesh=mesh, **kw), reqs,
                             record=True)[0][0]
            opt = pool.run(PAR_TASKS + "engine_run", PAR_SEED, cfg,
                           par_econf(mesh=mesh, **kw, **extra), reqs,
                           runs=runs_n)[0][-1]
            label = name.split("-")[0]
            check_streams(f"{what}: {label} TP vs plain TP streams",
                          generated(opt["streams"], reqs),
                          generated(plain["streams"], reqs), plain["top2"],
                          card)
            check_streams(f"{what}: plain TP vs single-rank streams "
                          f"({label} prompts)",
                          generated(plain["streams"], reqs), ref[name][0],
                          ref[name][1], card, plain["top2"],
                          NOISE_CAP["float32"])
            ost = opt["stats"]
            mq = opt["launches"]["paged_decode_attention_parts_mq"]
            if label == "spec":
                check(ost["verify_steps"] > 0
                      and mq == L * ost["verify_steps"],
                      f"{what}: spec mq launches {mq}, verify steps "
                      f"{ost['verify_steps']}")
            else:
                check(ost["prefix_hit_pages"] == 16
                      and mq == L * ost["suffix_prefills"],
                      f"{what}: prefix run 2 hit pages "
                      f"{ost['prefix_hit_pages']}, mq launches {mq}, "
                      f"suffix prefills {ost['suffix_prefills']}")
            log(f"  {what}: {label} run: decode_tok_per_s "
                f"{ost['decode_tok_per_s']:.1f}, verify steps "
                f"{ost['verify_steps']}, suffix prefills "
                f"{ost['suffix_prefills']}, mq launches {mq} [{card}]")
        # each rank's parts kernels at its local heads
        for rank, checks in enumerate(pool.run("chip_smoke:rank_kernels",
                                               heads)):
            for wrapper, errs, ok in checks:
                check(ok, f"{what}: rank {rank} {wrapper} at {heads} heads "
                          f"disagrees with its plain version: {errs}")
        log(f"  {what}: every rank's int8 and f32 single- and multi-query "
            f"parts kernels at {heads} heads match their plain versions "
            f"(tol {TOL_ABS:g} + {TOL_REL:g}*|ref|) [{card}]")
        # one DP AdamW step (and a second) against one rank, fp32
        losses = pool.run(PAR_TASKS + "dp_losses", PAR_SEED, cfg, *xy,
                          steps=2)
        for rank, got in enumerate(losses):
            d = max(abs(a - b) for a, b in zip(got, dp_want))
            check(d <= 1e-5, f"{what}: rank {rank} DP losses {got} vs one "
                             f"rank {dp_want}: |d| {d:.3e} > 1e-5")
        log(f"  {what}: DP AdamW on a 4 x 64 batch, losses {losses[0]} vs "
            f"one rank {dp_want} (|d| <= 1e-5) [{card}]")
        ar, ag = pool.run("chip_smoke:rank_collectives", 8, cfg.channels,
                          cfg.padded_vocab_size // n)[0]
        log(f"  {what}: {ar:.3f} ms an all-reduce of (8, {cfg.channels}) "
            f"f32, {ag:.3f} ms an all-gather of (8, "
            f"{cfg.padded_vocab_size // n}) f32 blocks (host clock, "
            f"synchronized; {backend}"
            + (": through the host, not NCCL's" if backend == "gloo" else "")
            + f"); rank start {t_start:.1f} s [{card}]")


# ---- phase 18: the serving front over TP ranks -------------------------------

SERVE_TASK = PAR_TASKS + "serve_run"
PHASE_21 = ("phase 21: Mellum2-12B-A2.5B at its published widths: the hd128 "
            "int8 multi-query parts at the code cell's shapes, one engine "
            "link")
PHASE_18 = ("phase 18: the serving front over TP ranks (ServingEngine, "
            "HttpServingFront, --serve --mesh-model), GPT-2 124M at full "
            "width")


def phase_tp_serving(torch, card, single=None):
    """Phase 18 (module docstring): ServingEngine, HttpServingFront and
    the CLI's --serve over TP ranks, on phase 17's weights (PAR_SEED).
    ``single``: phase 13's single-rank numbers (None when it did not
    run)."""
    import dataclasses

    from llmc_paged_tpu_torch.config import GPT2Config
    cfg = GPT2Config.gpt2_124m()
    V = cfg.vocab_size
    prompts = prompts_for(torch, 8, [128] * 8, V, 1, "cuda")   # phase 17's
    # the fp32 rows, and a ninth with row 1's prompt whose client leaves
    # (the front sees it gone at its second write after the two lines
    # read, so the engine makes about 3 links of 16 more)
    f32 = (par_requests(prompts, 32)
           + [dict(rid=8, prompt=list(prompts[1]), max_new_tokens=96)])
    int8 = par_requests(prompts_for(torch, 8, [128] * 8, V, 9, "cuda"),
                        128)                                   # phase 13's
    n_cards = torch.cuda.device_count()
    legs = [("a", 2, "gloo", "cuda:0")]
    if n_cards >= 2:
        legs.append(("b", min(4, n_cards), "nccl", "cuda"))
    else:
        log(f"  (b) NCCL across cards and the CLI under torchrun: not run "
            f"({n_cards} card; NCCL takes one rank a card) [{card}]")
    for leg, n, backend, dev in legs:
        mesh = {"model": n}
        econf32 = par_econf("float32", "float32", 28, mesh=mesh,
                            stream_links=1)
        # phase 13's headline settings, without per-request overrides
        econf8 = dataclasses.replace(
            par_econf("int8", "int8", 28, mesh=mesh), greedy=False,
            device_sampling=True, top_k=40, temperature=0.8)
        tp_serving_leg(cfg, f32, int8, econf32, econf8, single, leg, n,
                       backend, dev, card)
    if n_cards >= 2:
        tp_cli_serve(torch, cfg, card)


def same_on_every_rank(what, res, key):
    for rank, r in enumerate(res[1:], 1):
        check(r[key] == res[0][key], f"{what}: rank {rank}'s {key} differ "
                                     "from rank 0's")


def tp_serving_leg(cfg, f32, int8, econf32, econf8, single, leg, n,
                   backend, dev, card):
    """One leg of phase 18: ``n`` rank processes over ``backend`` on
    ``dev``, the leader (rank 0) answering HTTP clients in its process."""
    from llmc_paged_tpu_torch.parallel.mp_dryrun import RankPool
    L = cfg.num_layers
    what = (f"({leg}) {n} ranks over {backend}"
            + (" sharing one card" if dev == "cuda:0" else ", a card each"))
    t0 = time.monotonic()
    with RankPool(n, backend, dev, timeout_s=600) as pool:
        pool.run(PAR_TASKS + "rank_device")       # every rank has joined
        t_start = time.monotonic() - t0
        # 1-2. fp32: 8 concurrent POSTs and a ninth client who leaves
        t1 = time.monotonic()
        res = pool.run(SERVE_TASK, PAR_SEED, cfg, econf32, f32,
                       client="http", cancel_running=8)
        lead = res[0]
        batch, served = lead["batch"], lead["served"]
        for i in range(8):
            check(served[i]["tokens"] == batch[i],
                  f"{what}: fp32 served row {i} parts from the TP batch "
                  f"run: {served[i]['tokens'][128:140]} vs "
                  f"{batch[i][128:140]}")
        same_on_every_rank(f"{what}: fp32", res, "finished")
        # the front numbers its requests itself: find the cancelled one
        got = served[8]["tokens"]
        cut = [t for t, cancelled in lead["finished"].values() if cancelled]
        made = len(cut[0]) - 128 if len(cut) == 1 else None
        check(served[8]["cancelled"] and made is not None
              and 128 < len(got) <= len(cut[0]) < len(batch[8])
              and cut[0] == batch[8][: len(cut[0])],
              f"{what}: the disconnected stream ({len(got) - 128} tokens "
              f"streamed, {made} made) is not a cancelled prefix of its "
              "uncancelled stream")
        free = [r["live"]["pages_free"] for r in res]
        check(free == [28] * n, f"{what}: pages free after the drain "
                                f"{free}, want 28 on every rank")
        log(f"  {what}: fp32, 8 concurrent HTTP requests of 128 + 32 "
            f"tokens: every row equals the TP batch run, every rank "
            f"finished the same streams; a client that left after "
            f"{len(got) - 128} streamed tokens: cancelled at {made} of 96, "
            f"a prefix of its uncancelled stream; pages free after the "
            f"drain {free}; broadcasts {lead['live']['broadcasts']} "
            f"({time.monotonic() - t1:.1f} s) [{card}]")
        # 3. the int8 headline: warmup on every rank, then 8 concurrent
        # requests of 128 + 128
        res = pool.run(SERVE_TASK, PAR_SEED, cfg, econf8, int8,
                       client="http", batch=False, warmup=True)
        lead = res[0]
        st, live = lead["stats"], lead["live"]
        same_on_every_rank(f"{what}: int8", res, "finished")
        n_tok = sum(len(s["tokens"]) - 128 for s in lead["served"].values())
        check(n_tok == 8 * 128 and all(
            0 <= t < cfg.vocab_size for s in lead["served"].values()
            for t in s["tokens"]), f"{what}: int8: {n_tok} tokens")
        launches = [r["launches"]["paged_decode_attention_quant_parts"]
                    for r in res]
        steps = [r["stats"]["decode_steps"] for r in res]
        check(all(lc == L * k and r["stats"]["single_steps"] == 0
                  for lc, k, r in zip(launches, steps, res)),
              f"{what}: int8 parts launches {launches}, want L x chained "
              f"steps {steps} on every rank")
        link_ms = host_ms_step(st) * econf8.decode_chunk
        bcast = live["broadcast_ms_p50"]
        ref = ("phase 13 (one rank, with per-request overrides): "
               f"{single['tok_s']:.1f} tok/s client side, engine "
               f"{single['decode_tok_per_s']:.1f}, p50_ttft_s "
               f"{single['p50_ttft_s']:.4f}" if single else
               "phase 13 did not run")
        log(f"  {what}: int8 headline served (warmup on every rank, 8 "
            f"concurrent HTTP requests of 128 + 128): {n_tok} tokens in "
            f"{lead['wall_s']:.3f} s = {n_tok / lead['wall_s']:.1f} tok/s "
            f"client side, engine decode_tok_per_s "
            f"{st['decode_tok_per_s']:.1f}, p50_ttft_s "
            f"{st['p50_ttft_s']:.4f} (queue included); {ref} [{card}]")
        log(f"  {what}: int8 parts launches a rank {launches} = L x "
            f"{steps[0]} chained decode steps, single steps 0; serving "
            f"broadcasts {[r['live']['broadcasts'] for r in res]} a rank, "
            f"median {bcast:.3f} host ms on the leader, "
            f"{100 * bcast / link_ms:.2f} % of a decode link's "
            f"{link_ms:.2f} host ms (16 steps at {host_ms_step(st):.2f}); "
            f"rank start {t_start:.1f} s [{card}]")


def tp_cli_serve(torch, cfg, card):
    """Leg (b)'s CLI: ``--serve PORT --mesh-model 2 --warmup`` under
    torchrun over NCCL (fp32, greedy) on a checkpoint of phase 17's
    weights; two concurrent POSTs beside the in-process single-rank
    CLI's tokens for the same prompts (fp32 TP sums in another order, so
    the first 8 tokens must agree and the rest is counted); SIGINT to
    torchrun stops every process within 30 s."""
    import signal
    import socket

    import numpy as np

    from llmc_paged_tpu_torch import formats
    from llmc_paged_tpu_torch.engine import cli
    from llmc_paged_tpu_torch.models import gpt2
    from llmc_paged_tpu_torch.parallel.mp_dryrun import http_post
    params = gpt2.init_params(cfg, torch.Generator().manual_seed(PAR_SEED),
                              device="cpu")
    build = os.path.join(HERE, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as d:
        ckpt, data = (os.path.join(d, n) for n in ("gpt2_124M.bin",
                                                   "tokens.bin"))
        formats.write_checkpoint(ckpt, cfg, {k: v.numpy()
                                             for k, v in params.items()})
        formats.write_token_stream(data, np.random.default_rng(PAR_SEED)
                                   .integers(0, cfg.vocab_size, 4096)
                                   .astype(np.int32))
        argv = [f"--checkpoint={ckpt}", f"--data={data}", "--greedy",
                "--batch=2", "--page-size=128", "--num-pages=8",
                "--pages-per-seq=2"]
        want = run_cli(cli, argv + ["--prompt-size=64",
                                    "--max-new=32"])["tokens"]
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        out, err = os.path.join(d, "out.txt"), os.path.join(d, "err.txt")
        t0 = time.monotonic()
        with open(out, "w") as fo, open(err, "w") as fe:
            proc = subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc-per-node", "2", "-m",
                 "llmc_paged_tpu_torch.engine.cli"] + argv
                + [f"--serve={port}", "--mesh-model=2", "--warmup"],
                stdout=fo, stderr=fe, cwd=d,
                env=dict(os.environ, PYTHONPATH=HERE))
        try:
            while "serving on" not in open(out).read():
                check(proc.poll() is None and time.monotonic() - t0 < 300,
                      "cli --serve --mesh-model 2: no serving line: "
                      + open(err).read()[-3000:])
                time.sleep(0.2)
            t_up = time.monotonic() - t0
            rids = sorted(want)
            replies = concurrently(lambda rid: http_post(
                f"http://127.0.0.1:{port}/generate",
                dict(prompt=want[rid][:64], max_new_tokens=32)), rids)
            agree = 0
            for rid, (status, reply, _) in zip(rids, replies):
                got = reply.get("tokens", [])
                check(status == 200 and len(got) == 96
                      and got[:72] == want[rid][:72],
                      f"cli --serve --mesh-model 2: request {rid} {status}: "
                      f"{got[64:72]} vs one rank's {want[rid][64:72]}")
                agree += got == want[rid]
            t1 = time.monotonic()
            proc.send_signal(signal.SIGINT)
            proc.wait(timeout=30)
            t_stop = time.monotonic() - t1
            check("forcefully" not in open(err).read(),
                  "cli --serve --mesh-model 2: torchrun killed a rank")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    log(f"  (b) the CLI --serve --mesh-model 2 --warmup under torchrun over "
        f"NCCL (fp32, greedy): up in {t_up:.1f} s; 2 concurrent POSTs of "
        f"64 + 32 tokens: {agree}/2 equal to one rank's CLI, all agree on "
        f"the first 8; SIGINT to torchrun: every process gone in "
        f"{t_stop:.1f} s [{card}]")


# ---- phases 19 and 20: the long-context probes --------------------------------

# the matrix's (prompt, pool_mult) cells, then probe_longrange's plain-parts
# and pool_mult 16 cells, as (name, prompt, pool_mult)
LONG_CELLS = ([("int8", p, m) for p in (128, 896) for m in (1, 4, 16)]
              + [("int8-xlaattn", 896, 1), ("int8", 896, 16)])


def phase_long_engines(torch, pa, device, card):
    """Phase 19: probe_longctx.long_ctx_engine at its defaults, then
    probe_longrange's B=32 run, on one fp32 GPT-2 1558M set. Checks every
    run's rows, flash launches = L x prefill waves and int8 parts
    launches = L x chained steps (the probe counts each run's launches)."""
    from llmc_paged_tpu_torch.models import gpt2_paged
    from llmc_paged_tpu_torch.ops.dev import probe_longctx, probe_longrange
    from llmc_paged_tpu_torch.ops.dev import serving_runs as SR
    cfg = SR.model_cfg("1558m")
    L = cfg.num_layers
    params = SR.device_params(cfg, device)
    reset_counts(pa)
    with counting_calls(torch, gpt2_paged, "prefill_paged") as waves:
        recs = probe_longctx.long_ctx_engine(params=params, device=device)
    wave_ms = device_ms_of(torch, waves[1])
    flash = sum(r["launches"].get("causal_attention_flash", 0) for r in recs)
    check(waves[0] >= len(recs) and flash == L * waves[0],
          f"long_ctx: {flash} flash launches for {waves[0]} prefill waves "
          f"(want L x waves, a wave a run at least)")
    for r in recs:
        st, n = r["stats"], r["config"][2]
        parts = r["launches"].get("paged_decode_attention_quant_parts", 0)
        check(r["generated"] == [n] * 8,
              f"long_ctx {r['tag']}: rows of {r['generated']} tokens, want "
              f"8 x {n}")
        check(parts == L * st["decode_steps"] and st["decode_steps"] > 0
              and (r["tag"] == "warm" or st["single_steps"] == 0),
              f"long_ctx {r['tag']}: {r['launches']} launches, "
              f"{st['single_steps']} single steps, want L x "
              f"{st['decode_steps']} chained steps")
        log(f"  long_ctx {r['tag']}: 8 x ({r['config'][1]} + {n}), wall "
            f"{r['wall_s']:.3f} s, decode_tok_per_s {r['tok_s']:.1f} "
            f"({r['ms_step']:.2f} ms a step), p50_ttft_s "
            f"{st['p50_ttft_s']:.4f}, int8 parts launches {parts} = L x "
            f"{st['decode_steps']} chained steps, flash "
            f"{r['launches'].get('causal_attention_flash', 0)} [{card}]")
    log(f"  long_ctx: {waves[0]} prefill waves, flash launches {flash} = L x "
        "waves; device ms a wave (CUDA events around prefill_paged): "
        + ", ".join(f"{x:.2f}" for x in wave_ms))
    reset_counts(pa)
    rec = probe_longrange.m1558_b32(params=params, device=device)
    st = rec["stats"]
    check(rec["batch"] == 32 and rec["new_tokens"] == 64
          and st["decode_tokens"] == 32 * 63,
          f"m1558_b32: {rec['batch']} rows, {st['decode_tokens']} decode "
          "tokens (want 32 rows of 64 tokens: 32 x 63 after the prefill's)")
    log(f"  m1558_b32: 32 x (128 + 64), chunks of 32, int8: tok/s "
        f"{rec['tok_s']} (runs {rec['runs']}), p50_ttft_s "
        f"{rec['p50_ttft_s']}, decode weights "
        f"{mib(st['param_bytes'])} MiB; launches over its 3 runs "
        f"{ {k: v for k, v in pa.LAUNCHES.items() if v} } [{card}]")
    del params
    torch.cuda.empty_cache()


def phase_long_cells(torch, pa, card):
    """Phase 20: probe_longctx's chunk matrix and probe_longrange's cells
    and scale check (their main(), --skip-engine and --skip-b32). Checks
    the eight cells, int8 parts launches = L x steps on each kernel cell
    and 0 on the plain-parts cell, and the P=1152 check's record (the
    check itself raises at phase 3's tolerance). Logs the slopes of a
    step's busy and host ms against the pool's pages and the live
    pages."""
    from llmc_paged_tpu_torch.ops.dev import probe_longctx, probe_longrange
    from llmc_paged_tpu_torch.ops.dev.serving_runs import model_cfg
    L = model_cfg("124m").num_layers
    reset_counts(pa)
    recs = (probe_longctx.main(["--skip-engine"])
            + probe_longrange.main(["--skip-b32"]))
    cells = [r for r in recs if r["suite"] == "chunk"]
    got = [(r["name"], r["config"][2], r["config"][3]) for r in cells]
    check(got == LONG_CELLS and all(r["config"][:2] == (8, 128)
                                    for r in cells),
          f"long cells: {got}, want {LONG_CELLS} at B=8, ps 128")
    key = "paged_decode_attention_quant_parts"
    for r in cells:
        want = {} if r["name"].endswith("-xlaattn") else {key: L * r["units"]}
        check(r["launches"] == want == r["kernels"],
              f"long cell {r['name']} prompt {r['config'][2]} pool_mult "
              f"{r['config'][3]}: launches {r['launches']}, want {want}")
    (scale,) = [r for r in recs if r["suite"] == "scale_check"]
    check(scale["P"] == 1152 and scale["kernels"] == {key: 1},
          f"scale check: {scale}")
    total = sum(r["kernels"].get(key, 0) for r in recs)
    check(pa.LAUNCHES[key] == total, f"long cells: {pa.LAUNCHES[key]} "
          f"launches, the records count {total}")
    ms, pages = {}, {}
    for (name, prompt, mult), r in zip(LONG_CELLS, cells):
        ms[name, prompt, mult] = (r["busy_ms"], r["host_ms"])
        pages[prompt, mult] = r["num_pages"]
        log(f"  cell prompt {prompt} pool_mult {mult} ("
            f"{r['num_pages']} pages), ms a step host/device/busy: "
            f"{probe_summary(r)}; launches {r['launches']}")
    log(f"  scale check at P=1152: acc/m/l max diff "
        f"{[f'{d:.3e}' for d in scale['diffs']]}")
    # us a step per page of the pool (pool_mult 1 -> 16 at one prompt) and
    # per live page (prompt 128 -> 896 at pool_mult 1: 8 rows x 6 more
    # committed pages), on busy and on host ms
    for i, what in enumerate(("busy", "host")):
        if any(v[i] is None for v in ms.values()):
            log(f"  {what} ms: not measured")
            continue
        pool = [(ms["int8", p, 16][i] - ms["int8", p, 1][i]) * 1e3
                / (pages[p, 16] - pages[p, 1]) for p in (128, 896)]
        live = (ms["int8", 896, 1][i] - ms["int8", 128, 1][i]) * 1e3 / 48
        log(f"  {what}: {pool[0]:.4f} / {pool[1]:.4f} us a step per pool "
            f"page (prompt 128 / 896), {live:.3f} us a step per live page "
            f"({live / L:.4f} a layer call); the plain parts at 896: "
            f"{ms['int8-xlaattn', 896, 1][i]:.3f} ms against the kernel's "
            f"{ms['int8', 896, 1][i]:.3f} [{card}]")


# ---- phase 11: the kernel lab ------------------------------------------------

# timed calls a run of the lab's sweeps (their default is 50)
LAB_ITERS = 20
# configurations each lab kernel's time is logged at, beside its bound
# and its library call; the JSON line takes the last
INT8_TIMED = ((8, 2304, 768), (256, 3072, 768), (8, 51200, 768))
FLATWIDE_HEADLINE = (8, 12, 64, 28, 128, 3)     # phase 3's decode shape
FLATWIDE_1558M = (8, 25, 64, 28, 128, 3)        # the 1.5B head count
# the softmax cluster sizes timed against each other at (8, 50304) (the
# rule picks 8 there)
SOFTMAX_CLUSTERS = (1, 4, 8, 16)
# the 124M decode shape over a 12-layer stacked pool (lab_full_pool)
FULL_POOL_HEADLINE = (8, 12, 64, 12, 28, 128, 3)
LabKernel = collections.namedtuple(
    "LabKernel", "source replaces module version plain timed")
# the lab's wrappers, by LAUNCHES key: the source, the TPU kernel it
# replaces, the lab module and version that launch it, and the version
# in that module that is its plain version
LAB_KERNELS = {
    "int8_matmul_bf16": LabKernel(
        "int8_matmul.cu", "llmc_paged_tpu/ops/int8.py:75",
        "bench_int8_matmul", "v1_cuda_fused", "int8_linear (port)",
        INT8_TIMED),
    "int8_matmul_fp32": LabKernel(
        "int8_matmul.cu", "llmc_paged_tpu/ops/int8.py:75",
        "bench_int8_matmul", "v1_cuda_fp32exact", "v0_dequant_ref (naive)",
        INT8_TIMED),
    "layernorm_rows": LabKernel(
        "layernorm.cu", "llmc_paged_tpu/ops/dev/bench_layernorm.py:26",
        "bench_layernorm", "v1_cuda_warp_row", "v0_torch_ops (plain)",
        ((8, 768), (8192, 768))),
    "softmax_rows": LabKernel(
        "softmax.cu", "llmc_paged_tpu/ops/dev/bench_softmax.py:27",
        "bench_softmax", "v1_cuda_cluster_row", "v0_max_exp_sum (plain)",
        ((64, 50304), (8, 51200), (8, 50304))),
    "flatwide_parts": LabKernel(
        "lab_flatwide.cu", "llmc_paged_tpu/ops/dev/lab_flatwide.py:57",
        "lab_flatwide", "v2_cuda_flatwide", "v0_gather_ref (naive)",
        (FLATWIDE_1558M + ("f32",), FLATWIDE_HEADLINE + ("f32",))),
    "flatwide_quant_parts": LabKernel(
        "lab_flatwide.cu", "llmc_paged_tpu/ops/dev/lab_flatwide.py:57",
        "lab_flatwide", "v2_cuda_flatwide", "v0_gather_ref (naive)",
        (FLATWIDE_1558M + ("int8",), FLATWIDE_HEADLINE + ("int8",))),
    "paged_decode_attention_full": LabKernel(
        "lab_full_pool.cu", "llmc_paged_tpu/ops/dev/lab_full_pool.py:65",
        "lab_full_pool", "v2_cuda_full_pool", "v0_gather_ref (naive)",
        (FULL_POOL_HEADLINE + ("f32",),)),
    "paged_decode_attention_quant_full": LabKernel(
        "lab_full_pool.cu", "llmc_paged_tpu/ops/dev/lab_full_pool.py:185",
        "lab_full_pool", "v2_cuda_full_pool", "v0_gather_ref (naive)",
        (FULL_POOL_HEADLINE + ("int8",),)),
}
# lab modules whose two wrappers one version launches, told apart by the
# pool of the configuration (its last field)
BY_POOL = ("lab_flatwide", "lab_full_pool")


def lab_key(module, rec):
    """The LAUNCHES key of the wrapper a sweep record's version launches
    (in BY_POOL modules, by the pool of its configuration), or None."""
    for key, k in LAB_KERNELS.items():
        if ((k.module, k.version) == (module, rec["name"])
                and (module not in BY_POOL
                     or rec["config"][-1] == k.timed[0][-1])):
            return key
    return None


def lab_counts():
    """The LAUNCHES dicts of the lab wrappers' modules."""
    from llmc_paged_tpu_torch.ops import int8
    from llmc_paged_tpu_torch.ops.dev import (bench_layernorm, bench_softmax,
                                              lab_flatwide, lab_full_pool)
    return (int8.LAUNCHES, bench_layernorm.LAUNCHES, bench_softmax.LAUNCHES,
            lab_flatwide.LAUNCHES, lab_full_pool.LAUNCHES)


def phase_lab_sweeps():
    """Every lab module's entry point in process on the card (its sweep:
    each validated version against its reference, then timed). Returns
    the lab wrappers' launches, checked equal to the calls the harness
    made to the versions that launch them, and each module's records."""
    from llmc_paged_tpu_torch.ops.dev import (
        bench_fusion, bench_int8_matmul, bench_layernorm, bench_matmul,
        bench_paged_attention, bench_softmax, lab_flatwide, lab_full_pool)
    counts = lab_counts()
    for c in counts:
        for k in c:
            c[k] = 0
    want = dict.fromkeys(LAB_KERNELS, 0)
    records = {}
    out_dir = os.path.join(HERE, "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_lab.txt"), "w") as f:
        for mod, argv in ((bench_int8_matmul, ["--set", "all"]),
                          (bench_layernorm, []), (bench_softmax, []),
                          (bench_matmul, []), (bench_paged_attention, []),
                          (bench_fusion, []), (lab_flatwide, []),
                          (lab_full_pool, [])):
            name = mod.__name__.rsplit(".", 1)[-1]
            t0 = time.monotonic()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                records[name] = mod.main(argv + ["--iters", str(LAB_ITERS)])
            f.write(f"== {name} {' '.join(argv)}\n{buf.getvalue()}")
            valid = [r for r in records[name] if r["validated"]]
            log(f"  {name}: {len(records[name])} runs, {len(valid)} validated"
                f" (max|d| "
                f"{max((r['max_abs_err'] for r in valid), default=0):.3e}), "
                f"{time.monotonic() - t0:.1f} s; us a call:")
            by_cfg = {}
            for r in records[name]:
                by_cfg.setdefault(r["config"], []).append(
                    f"{r['name'].split(' ')[0]} {r['ms'] * 1e3:.2f}")
                key = lab_key(name, r)
                if key:
                    check(r["validated"], f"{name} {r['name']} {r['config']}"
                          " was not validated")
                    want[key] += r["calls"]
            for cfg, cells in by_cfg.items():
                log(f"    {cfg}: {', '.join(cells)}")
    log_int8_lab(records["bench_int8_matmul"])
    got = {k: v for c in counts for k, v in c.items()}
    check(got == want, f"lab launches {got} != the harness's calls {want}")
    check(all(v > 0 for v in got.values()), f"a lab kernel never ran: {got}")
    return got, records


def log_int8_lab(recs):
    """int8_matmul in both modes beside the serving int8 linear (a plain
    product over the weight dequantized every call) and the bf16 dense
    product, at every bench_int8_matmul shape: us a call."""
    names = (("bf16 mode", "v1_cuda_fused"), ("fp32 mode", "v1_cuda_fp32exact"),
             ("int8_linear (port)", "int8_linear (port)"),
             ("bf16 dense", "bf16_matmul (serving)"))
    ms = {(r["name"], r["config"]): r["ms"] for r in recs}
    log("  int8_matmul beside the serving int8 linear, us a call:")
    for cfg in dict.fromkeys(r["config"] for r in recs):
        log(f"    {cfg}: " + ", ".join(
            f"{label} {ms[(v, cfg)] * 1e3:.2f}" for label, v in names))


def lab_cost(torch, key, cfg, device):
    """(bytes, operations, peak operations/s) of one call of a lab kernel
    on the sweep's inputs at ``cfg`` (made again from the module's seed),
    and one PyTorch call of the same function with its name (None for
    flatwide and the full-pool kernel: no PyTorch call reads K/V through
    a block table). int8_matmul's operations are bf16 products on the
    tensor cores, three a product in the fp32-exact mode (x split into
    three bf16 terms). The full-pool kernel's bound is the grid kernel's
    on the plane it reads, plus the layer index."""
    from llmc_paged_tpu_torch.ops import int8 as Q
    from llmc_paged_tpu_torch.ops.dev import bench_int8_matmul
    from llmc_paged_tpu_torch.ops.dev import bench_layernorm as LN
    from llmc_paged_tpu_torch.ops.dev import bench_softmax as SM
    from llmc_paged_tpu_torch.ops.dev import lab_flatwide as FW
    from llmc_paged_tpu_torch.ops.dev import lab_full_pool as FP
    from llmc_paged_tpu_torch.ops.layers import LN_EPS
    if key.startswith("int8_matmul"):
        B, OC, IC = cfg
        x, wq, s = bench_int8_matmul.make_args(B, OC, IC, device)[:3]
        xb, sb = x.bfloat16(), s.bfloat16()
        library = lambda: torch.ops.aten._weight_int8pack_mm(xb, wq, sb)
        try:
            library()
            torch.cuda.synchronize()
            lib_name = "torch.ops.aten._weight_int8pack_mm at bf16"
        except (RuntimeError, NotImplementedError) as e:
            wdq = Q.dequantize(wq, s).bfloat16()
            library = lambda: torch.matmul(xb, wdq.t())
            lib_name = ("bf16 torch.matmul over a pre-dequantized weight "
                        f"(_weight_int8pack_mm: {str(e).splitlines()[0]})")
        # the tensor cores' bf16 rate: the fp32-exact mode's fastest exact
        # route is three bf16 products (x split into three bf16 terms)
        terms = 1 if key.endswith("bf16") else 3
        return (OC * IC + B * IC * 4 + B * OC * 4 + OC * 4,
                terms * 2 * B * OC * IC, PEAK_BF16_OPS_S, library, lib_name)
    if key == "layernorm_rows":
        R, C = cfg
        x, w, b = LN.make_args(R, C, device)
        return (2 * R * C * 4 + 2 * C * 4, 8 * R * C, PEAK_F32_OPS_S,
                lambda: torch.nn.functional.layer_norm(x, (C,), w, b, LN_EPS),
                "torch.nn.functional.layer_norm")
    if key == "softmax_rows":
        B, V = cfg
        (x,) = SM.make_args(B, V, device)
        return (2 * B * V * 4, 5 * B * V, PEAK_F32_OPS_S,
                lambda: torch.softmax(x, dim=-1), "torch.softmax")
    if key.endswith("_full"):
        q, k, v, scales, layer, _, tables, lengths, starts = FP.make_args(
            *cfg, device=device)
        plane = tuple(t[layer] for t in (k, v) + tuple(scales or ()))
        nbytes, ops = parts_cost(q, plane, tables, lengths, starts,
                                 grid=True)
        return nbytes + 4, ops, PEAK_F32_OPS_S, None, None
    q, k, v, scales, tables, lengths, starts = FW.make_args(*cfg,
                                                            device=device)
    nbytes, ops = parts_cost(q, (k, v) + tuple(scales or ()), tables,
                             lengths, starts)
    return nbytes, ops, PEAK_F32_OPS_S, None, None


def phase_lab_times(torch, records, device):
    """Each lab kernel's time and its plain version's at the logged
    configurations, from the sweeps' records, beside the bound for those
    inputs and one PyTorch call of the same function (timed here);
    flatwide beside the parts kernel and the full-pool kernel beside the
    grid kernel on the plane, which the sweeps ran on the same tensors.
    Returns per-wrapper records for the JSON line."""
    out = {}
    for key, k in LAB_KERNELS.items():
        recs = records[k.module]
        err = max(r["max_abs_err"] for r in recs if lab_key(k.module, r)
                  == key)

        def ms_of(version, cfg):
            return next(r["ms"] for r in recs
                        if (r["name"], r["config"]) == (version, cfg))

        for cfg in k.timed:
            nbytes, ops, peak, library, lib_name = lab_cost(torch, key, cfg,
                                                            device)
            t_bytes = nbytes / PEAK_BYTES_S * 1e3
            t_ops = ops / peak * 1e3
            t = dict(ms=ms_of(k.version, cfg),
                     plain_ms=ms_of(k.plain, cfg), max_abs_err=err,
                     library_ms=None if library is None
                     else device_ms(library),
                     bound_ms=max(t_bytes, t_ops),
                     bound_by="bytes" if t_bytes >= t_ops else "operations")
            lib = ("none" if library is None
                   else f"{t['library_ms'] * 1e3:.2f} us ({lib_name})")
            other = {"lab_flatwide": ("the parts kernel",
                                      "v1_cuda_online_parts"),
                     "lab_full_pool": ("the grid kernel on the plane",
                                       "v1_cuda_grid_on_plane")}.get(k.module)
            beside = ("" if other is None else
                      f", {other[0]} on the same tensors "
                      f"{ms_of(other[1], cfg) * 1e3:.2f} us")
            log(f"  {key} {cfg}: kernel {t['ms'] * 1e3:.2f} us, plain "
                f"{t['plain_ms'] * 1e3:.2f} us, library {lib}, bound "
                f"{t['bound_ms'] * 1e3:.3f} us by {t['bound_by']} "
                f"({nbytes} B, {ops} ops){beside}")
            out[key] = t
    log_lab_floor_and_clusters(torch, device)
    return out


def log_lab_floor_and_clusters(torch, device):
    """The launch floor under the lab's timer (an empty sleep kernel,
    queued back to back behind the timer's sleep as every lab call is),
    the cluster size softmax_rows picks at each bench_softmax shape, and
    its time at SOFTMAX_CLUSTERS at (8, 50304), each held against the
    plain version at the lab's tolerance."""
    from llmc_paged_tpu_torch.ops.dev import bench_softmax as SM
    from llmc_paged_tpu_torch.ops.dev.harness import benchmark
    floor = benchmark(torch.cuda._sleep, (0,), iters=LAB_ITERS,
                      device=device)
    log(f"  launch floor (torch.cuda._sleep(0), the lab's timer): "
        f"{floor * 1e3:.2f} us a call")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B, V in SM.CONFIGS:
        (x,) = SM.make_args(B, V, device)
        out = torch.empty_like(x)
        c = SM.cluster_size(B, sms,
                            lambda c: SM._active_clusters(x, out, V, c))
        log(f"  softmax_rows ({B}, {V}) f32: the rule picks {c} block(s) a "
            f"row ({B * c} blocks, {sms} SMs)")
    (x,) = SM.make_args(8, 50304, device)
    ref = SM.softmax_rows_ref(x)
    cells = []
    for c in SOFTMAX_CLUSTERS:
        got = SM.softmax_rows(x, _cluster=c)
        check(bool(((got - ref).abs() <= 1e-6 + 1e-5 * ref.abs()).all()),
              f"softmax_rows at cluster {c} disagrees with its plain version")
        ms = benchmark(lambda: SM.softmax_rows(x, _cluster=c), (),
                       iters=LAB_ITERS, device=device)
        cells.append(f"c={c} {ms * 1e3:.2f} us")
    log(f"  softmax_rows (8, 50304) f32 by cluster size: {', '.join(cells)}")


# ---- phase 12: the decode-step probe ------------------------------------------

PROBE_RUNS = (["--model", "124m", "--prefill-lengths", "128,256,896,1024"],
              ["--model", "1558m", "--skip",
               "matmul,prefill,attention,chunk,unrolled"])


def probe_summary(r) -> str:
    """One record of the probe, short: its time a unit (a call or a
    step) and, for a step, host / device / busy and the idle share."""
    if r["suite"] == "gemv":
        return (f"{r['name'].split(' ')[0]} {r['config'][3]}/"
                f"{r['config'][4]} {r['ms'] * 1e3:.1f} us")
    if r["suite"] in ("kernel", "kserve"):
        return f"{r['name']} {r['ms'] * 1e3:.1f} us"
    dev = ("-" if r["device_ms"] is None else
           f"{r['device_ms']:.3f}{'' if r['covered'] else ' (not covered)'}")
    busy = "-" if r["busy_ms"] is None else f"{r['busy_ms']:.3f}"
    idle = ("-" if r["idle_share"] is None
            else f"{r['idle_share']:.3f}")
    name = (f"{r['name']} T={r['config'][1]}" if r["suite"] == "prefill"
            else r["name"])
    return f"{name} {r['host_ms']:.3f}/{dev}/{busy} idle {idle}"


def phase_probe(pa) -> list:
    """probe_decode.main in process: all suites at 124M (the prefill at
    T 128, 256, 896 and 1024), the GEMV and kernel suites at 1558M. Logs
    one line a suite; checks that the paged-attention and flash launches
    equal the calls the probe's records count. Returns the records."""
    from llmc_paged_tpu_torch.ops.dev import probe_decode
    reset_counts(pa)
    records = []
    with open(os.path.join(HERE, "build", "chip_smoke_probe.txt"), "w") as f:
        for argv in PROBE_RUNS:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                recs = probe_decode.main(argv)
            f.write(f"== probe_decode {' '.join(argv)}\n{buf.getvalue()}")
            for suite in dict.fromkeys(r["suite"] for r in recs):
                rs = [r for r in recs if r["suite"] == suite]
                unit = ("ms a step host/device/busy"
                        if suite not in ("gemv", "kernel", "kserve")
                        else "a call")
                log(f"  {argv[1]} {suite} ({rs[0]['suite_s']:.1f} s; "
                    f"{unit}): " + "; ".join(map(probe_summary, rs)))
            records += recs
    want = collections.Counter()
    for r in records:
        want.update(r["kernels"])
    got = {k: v for k, v in pa.LAUNCHES.items() if v}
    if flash_launches():
        got["causal_attention_flash"] = flash_launches()
    check(got == dict(want) and sum(want.values()) > 0,
          f"probe launches {got} != the calls its records count "
          f"{dict(want)}")
    log(f"  probe launches {got} (= the calls the probe made)")
    return records


# ---- phase 15: evaluation and training --------------------------------------

TRAIN_DOCS = ("SURVEY.md", os.path.join("docs", "layernorm.md"))
EOT_BYTE, VAL_TOKENS = 256, 8192
# the trained-weights gate of tests/test_quant_trained.py:53-57
DOCS_CFG = dict(max_seq_len=128, vocab_size=257, num_layers=2, num_heads=4,
                channels=128)
DOCS_B, DOCS_LEG, DOCS_VAL_MAX = 8, 300, 3.2
QUALITY_GATE = 0.05      # |int8 - fp32| and |bf16 - fp32| val loss
# part (a): card against CPU at the tiny size
PARITY_CFG = dict(max_seq_len=64, vocab_size=257, num_layers=2, num_heads=4,
                  channels=128)
PARITY_B, PARITY_STEPS = 4, 5
# part (b): GPT-2 124M at full width
WIDE_B, WIDE_T, WIDE_STEPS, WIDE_EVAL_BATCHES = 4, 1024, 6, 4


def docs_corpus(root=HERE):
    """(train, val) int32 token streams of the repo's own text, as
    ``tools/prepro_text.py --encoder byte --val-tokens 8192`` makes them
    from SURVEY.md and docs/layernorm.md joined by a blank line: each
    non-blank "\\n\\n" document after EOT 256, as UTF-8 bytes; the first
    8192 tokens are the val split."""
    import numpy as np
    text = "\n\n".join(open(os.path.join(root, d), encoding="utf-8").read()
                       for d in TRAIN_DOCS)
    toks = []
    for doc in text.split("\n\n"):
        if doc.strip():
            toks.append(EOT_BYTE)
            toks.extend(doc.encode("utf-8"))
    toks = np.asarray(toks, dtype=np.int32)
    return toks[VAL_TOKENS:], toks[:VAL_TOKENS]


def fixed_batch_loader(torch, path, B, T, V, seed):
    """A DataLoader over a seeded stream of B*T+1 tokens: it wraps every
    batch, so each step sees the same (x, y)."""
    from llmc_paged_tpu_torch import formats
    from llmc_paged_tpu_torch.utils.dataloader import DataLoader
    g = torch.Generator().manual_seed(seed)
    formats.write_token_stream(
        path, torch.randint(0, V, (B * T + 1,), generator=g).numpy())
    return DataLoader(path, B, T)


def step_ms(lines):
    """The host ms of each training step from train()'s log lines."""
    return [float(s.rsplit("(took ", 1)[1].split(" ms")[0]) for s in lines
            if ": train loss " in s]


def train_parity(torch, tmp, device):
    """(a) 5 AdamW steps of the tiny config on one fixed batch, fp32 with
    TF32 off on the card and on the CPU from the same seeded params:
    losses within 1e-4 a step, step-0 gradients within rtol 1e-4 and
    atol 1e-6 a leaf."""
    from llmc_paged_tpu_torch.config import GPT2Config
    from llmc_paged_tpu_torch.models import gpt2
    from llmc_paged_tpu_torch.train import train
    check(not torch.backends.cuda.matmul.allow_tf32,
          "train parity: TF32 is on")
    cfg = GPT2Config.tiny(**PARITY_CFG)
    loader = fixed_batch_loader(torch, os.path.join(tmp, "fixed.bin"),
                                PARITY_B, cfg.max_seq_len, cfg.vocab_size, 1)
    p_cpu = gpt2.init_params(cfg, torch.Generator().manual_seed(2),
                             device="cpu")
    p_dev = gpt2.to_device(p_cpu, cfg, device=device)
    x, y = loader.next_batch()
    _, g_cpu = gpt2.grad_fn(p_cpu, x, y, cfg)
    _, g_dev = gpt2.grad_fn(p_dev, x, y, cfg)
    bad = [k for k in g_cpu if not torch.allclose(
        g_dev[k].cpu(), g_cpu[k], rtol=1e-4, atol=1e-6)]
    gerr = max(float((g_dev[k].cpu() - g_cpu[k]).abs().max()) for k in g_cpu)
    check(not bad, f"train parity: step-0 grads differ on {bad}")
    runs = {}
    for name, p in (("cpu", p_cpu), ("card", p_dev)):
        loader.reset()
        runs[name] = train(cfg, p, loader, steps=PARITY_STEPS,
                           sample_every=0, log=lambda *_: None)[1]
    d = max(abs(a - b) for a, b in zip(runs["cpu"], runs["card"]))
    log(f"  (a) tiny L=2 C=128 V=257 B={PARITY_B} T={cfg.max_seq_len}: "
        f"{PARITY_STEPS} AdamW steps, card {[round(v, 6) for v in runs['card']]}"
        f", |card - cpu| max {d:.3e} (tol 1e-4); step-0 grads max|d| "
        f"{gerr:.3e} (rtol 1e-4, atol 1e-6)")
    check(d <= 1e-4 and runs["card"][-1] < runs["card"][0],
          f"train parity: losses {runs}")


def train_wide(torch, params32, cfg, tmp):
    """(b) GPT-2 124M at full width: train() on one repeated batch of
    4 x 1024, then evaluate() in fp32, bf16 and int8."""
    import numpy as np
    from llmc_paged_tpu_torch import formats
    from llmc_paged_tpu_torch.eval import evaluate
    from llmc_paged_tpu_torch.models import gpt2
    from llmc_paged_tpu_torch.ops.int8 import quantize_params
    from llmc_paged_tpu_torch.train import train
    from llmc_paged_tpu_torch.utils.dataloader import DataLoader
    loader = fixed_batch_loader(torch, os.path.join(tmp, "wide.bin"),
                                WIDE_B, WIDE_T, cfg.vocab_size, 3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    lines = []
    params, losses = train(cfg, params32, loader, steps=WIDE_STEPS,
                           sample_every=0, log=lines.append)
    peak = torch.cuda.max_memory_allocated()
    ms = float(np.median(step_ms(lines)[1:]))
    log(f"  (b) 124M B={WIDE_B} T={WIDE_T}: losses "
        f"{[round(v, 4) for v in losses]}; {ms:.2f} ms a step (median of "
        f"steps 2-{WIDE_STEPS}, host clock; all {step_ms(lines)}), "
        f"{WIDE_B * WIDE_T / ms * 1e3:.0f} training tok/s; peak "
        f"{peak / 2**30:.2f} GiB allocated ({(peak - base) / 2**30:.2f} "
        f"GiB above the {base / 2**30:.2f} held before)")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"124M training: losses {losses}")
    g = torch.Generator().manual_seed(4)
    val = os.path.join(tmp, "wide_val.bin")
    formats.write_token_stream(val, torch.randint(
        0, cfg.vocab_size, (WIDE_EVAL_BATCHES * WIDE_B * WIDE_T + 1,),
        generator=g).numpy())
    val_loader = DataLoader(val, WIDE_B, WIDE_T)
    evals = {}
    for dt in ("float32", "bfloat16", "int8"):
        p = (gpt2.to_device(params, cfg, torch.bfloat16,
                            device=params["wpe"].device)
             if dt == "bfloat16" else quantize_params(params)
             if dt == "int8" else params)
        evaluate(cfg, p, val_loader, 1)                    # warm-up
        t0 = time.monotonic()
        loss = evaluate(cfg, p, val_loader, WIDE_EVAL_BATCHES)
        evals[dt] = (loss, (time.monotonic() - t0) * 1e3 / WIDE_EVAL_BATCHES)
        del p
    log("  (b) 124M evaluate(), 4 batches of 4 x 1024: " + ", ".join(
        f"{dt} {l:.6f} ({t:.2f} ms a batch)" for dt, (l, t) in evals.items()))
    for dt in ("bfloat16", "int8"):
        d = abs(evals[dt][0] - evals["float32"][0])
        check(d <= QUALITY_GATE, f"124M eval: |{dt} - fp32| = {d:.4f}")


def train_docs(torch, tmp, device):
    """(c) The tiny config trained on the repo's own text: val < 3.2 and
    the int8 and bf16 val losses within 0.05 of fp32 on held-out text."""
    from llmc_paged_tpu_torch import formats
    from llmc_paged_tpu_torch.config import GPT2Config
    from llmc_paged_tpu_torch.eval import evaluate
    from llmc_paged_tpu_torch.models import gpt2
    from llmc_paged_tpu_torch.ops.int8 import quantize_params
    from llmc_paged_tpu_torch.train import train
    from llmc_paged_tpu_torch.utils.dataloader import DataLoader
    train_toks, val_toks = docs_corpus()
    paths = {k: os.path.join(tmp, f"docs_{k}.bin") for k in ("train", "val")}
    formats.write_token_stream(paths["train"], train_toks)
    formats.write_token_stream(paths["val"], val_toks)
    cfg = GPT2Config.tiny(**DOCS_CFG)
    T = cfg.max_seq_len
    train_loader = DataLoader(paths["train"], DOCS_B, T)
    val_loader = DataLoader(paths["val"], DOCS_B, T)
    params = gpt2.init_params(cfg, torch.Generator(device).manual_seed(7),
                              device=device)
    loss0 = evaluate(cfg, params, val_loader, 4)
    t0 = time.monotonic()
    steps = 0
    for _ in range(2):
        params, _ = train(cfg, params, train_loader, steps=DOCS_LEG,
                          lr=1e-3, weight_decay=0.1, sample_every=0,
                          log=lambda *_: None)
        steps += DOCS_LEG
        if evaluate(cfg, params, val_loader, 4) < DOCS_VAL_MAX:
            break
    secs = time.monotonic() - t0
    evals = {"float32": evaluate(cfg, params, val_loader, 4),
             "bfloat16": evaluate(cfg, gpt2.to_device(
                 params, cfg, torch.bfloat16, device=device), val_loader, 4),
             "int8": evaluate(cfg, quantize_params(params), val_loader, 4)}
    log(f"  (c) tiny L=2 C=128 V=257 on SURVEY.md + docs/layernorm.md "
        f"({len(train_toks)} train, {len(val_toks)} val bytes): {steps} "
        f"steps at lr 1e-3, wd 0.1 in {secs:.2f} s; val loss init "
        f"{loss0:.6f}, fp32 {evals['float32']:.6f}, bf16 "
        f"{evals['bfloat16']:.6f} ({evals['bfloat16'] - evals['float32']:+.6f}"
        f"), int8 {evals['int8']:.6f} "
        f"({evals['int8'] - evals['float32']:+.6f})")
    check(evals["float32"] < DOCS_VAL_MAX,
          f"docs training: val loss {evals['float32']} >= {DOCS_VAL_MAX}")
    for dt in ("bfloat16", "int8"):
        d = abs(evals[dt] - evals["float32"])
        check(d <= QUALITY_GATE, f"docs eval: |{dt} - fp32| = {d:.4f}")
    return paths


def run_entry_points(jobs):
    """``python -m`` entry points of the port with LLMC_PLATFORM unset
    (so they run on the card), all at once: ``jobs`` is [(argv, want)];
    each must exit 0 and print its ``want``. Returns each one's stdout
    lines."""
    env = {k: v for k, v in os.environ.items() if k != "LLMC_PLATFORM"}
    env["PYTHONPATH"] = HERE
    t0 = time.monotonic()
    procs = [subprocess.Popen([sys.executable, "-m"] + argv, cwd=HERE,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for argv, _ in jobs]
    out = []
    try:
        for p, (argv, want) in zip(procs, jobs):
            stdout, stderr = p.communicate(timeout=300)
            check(p.returncode == 0 and want in stdout,
                  f"{argv[0]} exited {p.returncode}: {stderr[-2000:]}")
            lines = stdout.strip().splitlines()
            log(f"  (d) python -m {argv[0]} ({time.monotonic() - t0:.1f} "
                f"s): {lines[-1]}")
            out.append(lines)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def entry_points(tmp, paths):
    """(d) The train CLI from scratch on the card, with --val-every,
    --sample-every and --save, then the eval CLI on the saved checkpoint
    in the three dtypes, at once."""
    from llmc_paged_tpu_torch import formats
    from llmc_paged_tpu_torch.tokenizer import byte_fallback_table
    tok = os.path.join(tmp, "docs_tokenizer.bin")
    formats.write_tokenizer_bin(tok, byte_fallback_table(DOCS_CFG[
        "vocab_size"]))
    save = os.path.join(tmp, "trained.bin")
    [lines] = run_entry_points([(
        ["llmc_paged_tpu_torch.train", "--train-data", paths["train"],
         "--val-data", paths["val"], "--tokenizer", tok, "--steps", "6",
         "--batch", "8", "--seq-len", "128", "--layers", "2", "--heads",
         "4", "--channels", "128", "--vocab", "257", "--max-seq-len", "128",
         "--lr", "1e-3", "--val-every", "3", "--sample-every", "5", "--save",
         save], "saved ")])
    check(sum(": val loss " in s for s in lines) == 2
          and sum(": train loss " in s for s in lines) == 6
          and any(" sample: " in s for s in lines),
          f"train CLI: log lines {lines}")
    for s in lines:
        if ": val loss " in s or " sample: " in s:
            log(f"      {s}")
    run_entry_points([(["llmc_paged_tpu_torch.eval", "--checkpoint", save,
                        "--data", paths["val"], "--dtype", dt, "--batch",
                        "8", "--seq-len", "128", "--batches", "4"],
                       f"dtype={dt} val loss ")
                      for dt in ("float32", "bfloat16", "int8")])


def phase_training(torch, pa, params32, cfg, device):
    """Phase 15: evaluation and single-device training on the card. No
    hand-written kernel lies on this path (the forward is dense, the int8
    linear plain): every wrapper's launches stay 0 in process."""
    from llmc_paged_tpu_torch.ops import int8
    reset_counts(pa)
    for k in int8.LAUNCHES:
        int8.LAUNCHES[k] = 0
    with tempfile.TemporaryDirectory() as tmp:
        train_parity(torch, tmp, device)
        train_wide(torch, params32, cfg, tmp)
        paths = train_docs(torch, tmp, device)
        launched = {k: v for d in (pa.LAUNCHES, int8.LAUNCHES)
                    for k, v in d.items() if v}
        check(not launched and flash_launches() == 0,
              f"training/eval path launched {launched}, flash "
              f"{flash_launches()}")
        entry_points(tmp, paths)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="smoke run of the torch port "
                                             "on the card (module docstring)")
    ap.add_argument("--parallel-only", action="store_true",
                    help="phases 1, 2, 17 and 18 alone (e.g. on four "
                         "cards, where both add their NCCL legs)")
    ap.add_argument("--mellum-only", action="store_true",
                    help="phases 1, 2 and 21 alone (Mellum 2 at its "
                         "published widths)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from llmc_paged_tpu_torch.config import GPT2Config, PageConfig
    from llmc_paged_tpu_torch.kv.layouts import init_pool, token_coords
    from llmc_paged_tpu_torch.models import gpt2, gpt2_paged
    from llmc_paged_tpu_torch.ops import _build
    from llmc_paged_tpu_torch.ops import paged_attention as pa

    device = "cuda"
    t_start = time.monotonic()
    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    log(f"device: {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    card = smi.stdout.strip().splitlines()[0]
    log(card)                                   # name, power limit
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    # 2. build (the CUDA kernels, and the native block manager's host
    # library beside them)
    t0 = time.monotonic()
    host = threading.Thread(target=_build.build, args=("block_manager",),
                            kwargs=dict(host=True))
    host.start()
    _build.build_all(KERNELS)
    host.join()
    _build.load("block_manager", host=True)
    log(f"build: {time.monotonic() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in _build.BUILD_SECONDS.items())})")
    if args.parallel_only:
        phase("phase 17: tensor and data parallelism (parallel/), GPT-2 124M "
              "at full width over rank processes")
        phase_parallel(torch, pa, card)
        phase(PHASE_18)
        phase_tp_serving(torch, card)
        phase("done")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    if args.mellum_only:
        phase(PHASE_21)
        phase_mellum(torch, pa, device)
        phase("done")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # 3. kernel vs plain
    phase(f"phase 3: kernels vs plain versions (tol {TOL_ABS:g} + "
          f"{TOL_REL:g}*|ref|; acc: + {TOL_REL:g}*(|acc|+l))")
    records = phase_kernels(torch, pa, device)

    # 4. headline engine (the main path)
    phase("phase 4: GPT-2 124M, int8 weights + int8 KV, bf16 activations")
    cfg = GPT2Config.gpt2_124m()
    g = torch.Generator(device=device)
    g.manual_seed(0)
    t0 = time.monotonic()
    params32 = gpt2.init_params(cfg, g, device=device)
    prompts = prompts_for(torch, 8, [128] * 8, cfg.vocab_size, 1, device)
    eng, _ = serve(torch, params32, cfg, prompts=prompts, new=20,
                   kv_dtype="int8", param_dtype="int8", num_pages=8 * 3 + 4)
    log(f"  init + warm-up run {time.monotonic() - t0:.1f} s")
    reset_counts(pa)
    eng, done = serve(torch, params32, cfg, prompts=prompts, new=128,
                      kv_dtype="int8", param_dtype="int8", num_pages=28,
                      engine=eng)
    launches_main = dict(pa.LAUNCHES)
    check(flash_launches() == 0,
          f"headline: {flash_launches()} flash launches at T = 128 (the "
          "rule keeps it dense)")
    st = eng.stats
    check(len(done) == 8 and all(len(r.generated) == 128 for r in done),
          "headline: not every request finished with 128 tokens")
    check(all(0 <= t < cfg.vocab_size for r in done for t in r.generated),
          "headline: token id out of range")
    L = cfg.num_layers
    want = L * st["decode_steps"]
    check(launches_main["paged_decode_attention_quant_parts"] == want
          and launches_main["paged_decode_attention_quant_parts_mq"] == 0,
          f"headline: {launches_main} launches, want {want} int8 "
          f"(L x {st['decode_steps']} decode steps) and no mq launch")
    greedy_host_ms = host_ms_step(st)
    log(f"  decode_tok_per_s {st['decode_tok_per_s']:.1f}, p50_ttft_s "
        f"{st['p50_ttft_s']:.4f}, decode steps {st['decode_steps']}, "
        f"launches {launches_main}, wall {st['wall_s']:.3f} s (host: "
        f"prefill dispatch {st['t_prefill_dispatch_s']} s, chain dispatch "
        f"{st['t_chain_dispatch_s']} s, materialize "
        f"{st['t_materialize_s']} s; model.step {greedy_host_ms:.2f} ms a "
        "chained step)")

    # 5. fp32 engine: kernel route vs plain route
    phase("phase 5: fp32 engine, kernel route vs plain route")
    reset_counts(pa)
    eng_k, done_k = serve(torch, params32, cfg, prompts=prompts, new=32,
                          kv_dtype="float32", param_dtype="float32",
                          num_pages=28)
    launches_f32 = dict(pa.LAUNCHES)
    want = cfg.num_layers * eng_k.stats["decode_steps"]
    check(launches_f32["paged_decode_attention_parts"] == want,
          f"fp32: {launches_f32} launches, want {want} float")
    eng_p, done_p = serve(torch, params32, cfg, prompts=prompts, new=32,
                          kv_dtype="float32", param_dtype="float32",
                          num_pages=28, use_kernel=False)
    for a, b in zip(done_k, done_p):
        check(len(a.generated) == len(b.generated) == 32,
              f"fp32: stream lengths {len(a.generated)} vs "
              f"{len(b.generated)}")
        check(a.generated[:8] == b.generated[:8],
              f"fp32: streams disagree in the first 8 tokens: "
              f"{a.generated[:8]} vs {b.generated[:8]}")
    agree = sum(a.generated == b.generated for a, b in zip(done_k, done_p))
    log(f"  streams: {agree}/8 identical over 32 tokens, all agree on the "
        f"first 8")
    # one decode_step_paged on both routes, over a freshly prefilled pool
    page = PageConfig(page_size=128, num_pages=28, max_seqs=8,
                      pages_per_seq=3)
    pool = init_pool(cfg, page, dtype="float32", device=device)
    tables = torch.arange(24, dtype=torch.int32).reshape(8, 3)
    xs = torch.tensor(prompts, dtype=torch.int32)
    pos = torch.arange(128, dtype=torch.int32).repeat(8, 1)
    pg, sl = token_coords(tables, pos, 128, torch.ones(8, 128, dtype=bool),
                          28)
    params_f32 = eng_k.params
    _, pool = gpt2_paged.prefill_paged(params_f32, xs, pg, sl, pool, cfg)
    step = dict(tokens=torch.tensor([r.generated[0] for r in done_k],
                                    dtype=torch.int32),
                positions=torch.full((8,), 128, dtype=torch.int32),
                page=tables[:, 1].clone(), slot=torch.zeros(8, dtype=torch.int32),
                block_tables=tables,
                lengths=torch.full((8,), 129, dtype=torch.int32))
    lk, _ = gpt2_paged.decode_step_paged(params_f32, pool=pool, cfg=cfg,
                                         use_kernel=True, **step)
    lp, _ = gpt2_paged.decode_step_paged(params_f32, pool=pool, cfg=cfg,
                                         use_kernel=False, **step)
    d = float((lk - lp).abs().max())
    log(f"  decode_step_paged logits, kernel vs plain: max|d| {d:.3e} "
        f"(tol 1e-3)")
    check(d <= 1e-3 and bool(torch.isfinite(lk).all()),
          "fp32: decode_step_paged logits disagree")

    # 6. loaded queue
    phase("phase 6: loaded queue, 16 requests through 8 slots")
    lens = [30, 200, 60, 150, 100, 250, 20, 180, 90, 220, 40, 130, 70, 240,
            10, 160]
    news = [100, 60, 120, 80, 40, 90, 110, 50, 70, 30, 120, 100, 60, 80,
            120, 40]
    qprompts = prompts_for(torch, 16, lens, cfg.vocab_size, 2, device)
    eng_q, done_q = serve(torch, params32, cfg, prompts=qprompts, new=0,
                          max_new=news, kv_dtype="int8", param_dtype="int8",
                          num_pages=10)
    check(len(done_q) == 16 and all(len(r.generated) == n
                                    for r, n in zip(done_q, news)),
          "loaded queue: not every request completed")
    check(eng_q.stats["preemptions"] >= 1, "loaded queue: no preemption")
    log(f"  preemptions {eng_q.stats['preemptions']}, peak pages "
        f"{eng_q.stats['peak_pages_used']}, decode_tok_per_s "
        f"{eng_q.stats['decode_tok_per_s']:.1f}")

    # 7. speculative serving (the main path of the multi-query kernel)
    phase("phase 7: speculative decode, spec_k=4, 3-gram prompt lookup, "
          "headline configuration")
    segs = prompts_for(torch, 8, [32] * 8, cfg.vocab_size, 3, device)
    sprompts = [seg * 4 for seg in segs]
    spec = dict(kv_dtype="int8", param_dtype="int8", num_pages=28, spec_k=4)
    eng_s, _ = serve(torch, params32, cfg, prompts=sprompts, new=20, **spec)
    reset_counts(pa)
    eng_s, done_s = serve(torch, params32, cfg, prompts=sprompts, new=128,
                          engine=eng_s, **spec)
    launches_spec = dict(pa.LAUNCHES)
    st = eng_s.stats
    check(len(done_s) == 8 and all(len(r.generated) == 128 for r in done_s),
          "spec: not every request finished with 128 tokens")
    check(all(0 <= t < cfg.vocab_size for r in done_s for t in r.generated),
          "spec: token id out of range")
    check(st["verify_steps"] > 0
          and launches_spec["paged_decode_attention_quant_parts_mq"]
          == L * st["verify_steps"]
          and launches_spec["paged_decode_attention_quant_parts"]
          == L * (st["decode_steps"] - st["verify_steps"]),
          f"spec: {launches_spec} launches, want L x {st['verify_steps']} "
          f"verify steps (mq) and L x the other "
          f"{st['decode_steps'] - st['verify_steps']} steps")
    log(f"  decode_tok_per_s {st['decode_tok_per_s']:.1f}, "
        f"spec_tok_per_step {st['spec_tok_per_step']}, p50_ttft_s "
        f"{st['p50_ttft_s']:.4f}, verify steps {st['verify_steps']}, "
        f"decode steps {st['decode_steps']}, launches {launches_spec}, "
        f"wall {st['wall_s']:.3f} s (host: chain dispatch "
        f"{st['t_chain_dispatch_s']} s, materialize "
        f"{st['t_materialize_s']} s)")
    # synchronizing calls: one engine run of the spec chain (by line, so
    # the chain's links show apart from admission and prefill), then one
    # bare speculative link (device carries, host block tables) and one
    # plain chunk link, both S=16 steps over the int8 pool
    syncs_run, where_run = count_syncs(torch, lambda: serve(
        torch, params32, cfg, prompts=sprompts, new=32, engine=eng_s,
        **spec))
    links_run = eng_s.stats["verify_steps"] // 16
    log(f"  synchronizing CUDA calls in one engine run (8 requests, 32 new "
        f"tokens, {links_run} speculative links): {syncs_run}, by line "
        f"{json.dumps(where_run, sort_keys=True)}")
    pool_s, B8 = eng_s._pool_cache, 8
    tables = torch.arange(3 * B8, dtype=torch.int32).reshape(B8, 3)
    carry = dict(first_tokens=torch.full((B8,), 7, device=device,
                                         dtype=torch.int32),
                 positions0=torch.full((B8,), 128, device=device,
                                       dtype=torch.int32),
                 hist=torch.zeros(B8, 385, device=device, dtype=torch.int32))
    syncs_spec, _ = count_syncs(torch, lambda: gpt2_paged.decode_chunk_spec(
        eng_s.params, pool=pool_s, block_tables=tables, cfg=cfg,
        num_steps=16, spec_k=4, ngram=3, active=[True] * B8, **carry))
    pos = 128 + torch.arange(16, dtype=torch.int32)[:, None].repeat(1, B8)
    pgs = tables.gather(1, (pos // 128).T.long()).T.contiguous()
    syncs_plain, _ = count_syncs(torch, lambda: gpt2_paged.decode_chunk_paged(
        eng_s.params, carry["first_tokens"],
        torch.full((B8,), 128, dtype=torch.int32), pgs, pos % 128, tables,
        pool_s, cfg, num_steps=16, window=cfg.max_seq_len))
    log(f"  synchronizing CUDA calls in one bare link: speculative "
        f"{syncs_spec}, plain chunk {syncs_plain} (the chain adds one "
        "device→host copy at its end)")
    del pool_s
    spec32 = dict(spec, kv_dtype="float32", param_dtype="float32")
    reset_counts(pa)
    eng_sf, done_sf = serve(torch, params32, cfg, prompts=sprompts, new=32,
                            **spec32)
    launches_spec_f32 = dict(pa.LAUNCHES)
    want = L * eng_sf.stats["verify_steps"]
    check(want > 0
          and launches_spec_f32["paged_decode_attention_parts_mq"] == want,
          f"spec fp32: {launches_spec_f32} launches, want {want} float mq")
    _, done_pf = serve(torch, params32, cfg, prompts=sprompts, new=32,
                       **dict(spec32, spec_k=0))
    for a, b in zip(done_sf, done_pf):
        check(len(a.generated) == len(b.generated) == 32,
              f"spec fp32: stream lengths {len(a.generated)} vs "
              f"{len(b.generated)}")
        check(a.generated[:8] == b.generated[:8],
              f"spec fp32: spec and plain streams disagree in the first 8 "
              f"tokens: {a.generated[:8]} vs {b.generated[:8]}")
    agree = sum(a.generated == b.generated for a, b in zip(done_sf, done_pf))
    log(f"  fp32 spec vs plain engine: {agree}/8 streams identical over 32 "
        f"tokens, all agree on the first 8 (spec_tok_per_step "
        f"{eng_sf.stats['spec_tok_per_step']})")

    # 8. prefix caching
    phase("phase 8: prefix caching, 256-token shared system prompt + 32-token "
          "suffixes, pages_per_seq 4, 40 pages")
    sys_prompt = prompts_for(torch, 1, [256], cfg.vocab_size, 4, device)[0]
    tails = prompts_for(torch, 8, [32] * 8, cfg.vocab_size, 5, device)
    pprompts = [sys_prompt + t for t in tails]
    done_prefix = {}
    for dt in ("int8", "float32"):
        pref = dict(kv_dtype=dt, param_dtype=dt, num_pages=40, pps=4)
        mq_key = ("paged_decode_attention_quant_parts_mq" if dt == "int8"
                  else "paged_decode_attention_parts_mq")
        eng_p = None
        for run in (1, 2):          # cold, then adopting the cached pages
            reset_counts(pa)
            eng_p, done_p = serve(torch, params32, cfg, prompts=pprompts,
                                  new=64, engine=eng_p, prefix=True, **pref)
            launches_p = dict(pa.LAUNCHES)
            st = eng_p.stats
            check(len(done_p) == 8
                  and all(len(r.generated) == 64 for r in done_p)
                  and all(0 <= t < cfg.vocab_size
                          for r in done_p for t in r.generated),
                  f"prefix {dt} run {run}: not every request finished "
                  "with 64 in-range tokens")
            check(launches_p[mq_key] == L * st["suffix_prefills"],
                  f"prefix {dt} run {run}: {launches_p} launches, want "
                  f"L x {st['suffix_prefills']} suffix prefills (mq)")
            if run == 2:
                check(st["prefix_hit_pages"] == 16
                      and st["suffix_prefills"] >= 1,
                      f"prefix {dt} run {run}: {st['prefix_hit_pages']} hit "
                      f"pages, {st['suffix_prefills']} suffix prefills "
                      "(want 16 and >= 1)")
            log(f"  {dt} run {run}: decode_tok_per_s "
                f"{st['decode_tok_per_s']:.1f}, p50_ttft_s "
                f"{st['p50_ttft_s']:.4f}, hit pages "
                f"{st['prefix_hit_pages']}, hit tokens "
                f"{st['prefix_hit_tokens']}, registered "
                f"{st['prefix_pages_registered']}, cached "
                f"{st['prefix_cached_pages']}, suffix prefills "
                f"{st['suffix_prefills']}, launches {launches_p}, wall "
                f"{st['wall_s']:.3f} s (prefill dispatch "
                f"{st['t_prefill_dispatch_s']} s, chain dispatch "
                f"{st['t_chain_dispatch_s']} s)")
        done_prefix[dt] = (eng_p, done_p)
    eng_pf32, done_pf32 = done_prefix["float32"]
    eng_nf, done_nf = serve(torch, params32, cfg, prompts=pprompts, new=64,
                            kv_dtype="float32", param_dtype="float32",
                            num_pages=40, pps=4)
    for a, b in zip(done_pf32, done_nf):
        check(a.generated[:8] == b.generated[:8],
              f"prefix fp32: streams disagree with the no-prefix engine in "
              f"the first 8 tokens: {a.generated[:8]} vs {b.generated[:8]}")
    agree = sum(a.generated == b.generated
                for a, b in zip(done_pf32, done_nf))
    st = eng_nf.stats
    log(f"  fp32 prefix (run 2) vs no-prefix engine: {agree}/8 streams "
        "identical over 64 tokens, all agree on the first 8; no-prefix "
        f"engine: decode_tok_per_s {st['decode_tok_per_s']:.1f}, p50_ttft_s "
        f"{st['p50_ttft_s']:.4f}, prefill dispatch "
        f"{st['t_prefill_dispatch_s']} s")
    # one suffix prefill against the full prefill of the same prompts
    page4 = PageConfig(page_size=128, num_pages=40, max_seqs=8,
                       pages_per_seq=4)
    tables4 = torch.arange(32, dtype=torch.int32).reshape(8, 4)
    xs = torch.tensor(pprompts, dtype=torch.int32)
    Tf = xs.shape[1]
    ones = torch.ones(8, Tf, dtype=torch.bool)
    pos = torch.arange(Tf, dtype=torch.int32).repeat(8, 1)
    pg, sl = token_coords(tables4, pos, 128, ones, 40)
    pool_a = init_pool(cfg, page4, dtype="float32", device=device)
    la, _ = gpt2_paged.prefill_paged(eng_pf32.params, xs, pg, sl, pool_a,
                                     cfg, last_pos=torch.full((8,), Tf - 1))
    del pool_a
    pool_b = init_pool(cfg, page4, dtype="float32", device=device)
    gpt2_paged.prefill_paged(eng_pf32.params, xs[:, :256], pg[:, :256],
                             sl[:, :256], pool_b, cfg,
                             last_pos=torch.full((8,), 255))
    reset_counts(pa)
    lb, _ = gpt2_paged.prefill_suffix_paged(
        eng_pf32.params, xs[:, 256:], pg[:, 256:], sl[:, 256:], pool_b,
        tables4, torch.full((8,), 256, dtype=torch.int32), cfg,
        last_pos=torch.full((8,), Tf - 257))
    torch.cuda.synchronize()
    d = float((la - lb).abs().max())
    log(f"  prefill_suffix_paged vs prefill_paged logits: max|d| {d:.3e} "
        f"(tol 1e-3), mq launches {pa.LAUNCHES['paged_decode_attention_parts_mq']}")
    check(d <= 1e-3 and bool(torch.isfinite(lb).all())
          and pa.LAUNCHES["paged_decode_attention_parts_mq"] == L,
          "prefix: suffix prefill disagrees with the full prefill")
    del pool_b

    # 9-10. the CLI and its modes
    phase("phase 9: the CLI at the reference defaults (ps 32, fp32, seed "
          "1337), 8 rows x 64-token prompts, 64 new tokens, top-k 40")
    launches_cli = phase_cli(torch, pa, params32, cfg, device)

    # 13. the serving front, before any phase that starts torch.profiler
    phase("phase 13: the serving front (ServingEngine + HTTP) under device "
          "sampling, fp32 parity engine and int8 headline engine")
    served13 = phase_serving(torch, pa, params32, cfg, device,
                             greedy_host_ms)

    # 14. the long-prompt prefill, also before any torch.profiler trace
    phase(f"phase 14: the long-prompt bf16 prefill through the flash "
          f"kernel, {LONG_PROMPT}-token prompts at 124M and 1558M")
    flash = phase_long_prefill(torch, pa, params32, cfg, device)

    # 15. evaluation and training, host-timed, so also before any trace
    phase("phase 15: evaluation and single-device training (train.py, "
          "eval.py): card against CPU, GPT-2 124M at full width, trained "
          "int8/bf16 gates, the two CLIs")
    phase_training(torch, pa, params32, cfg, device)

    # 16. the native block manager, host-timed, so also before any trace
    phase("phase 16: the native block manager (csrc/block_manager.cpp) "
          "against the Python one under the engine")
    phase_native_manager(torch, pa, params32, cfg, device)

    # 17. tensor and data parallelism, host-timed, so also before any trace
    phase("phase 17: tensor and data parallelism (parallel/), GPT-2 124M at "
          "full width over rank processes")
    phase_parallel(torch, pa, card)

    # 18. the serving front over TP ranks, host-timed, so before any trace
    phase(PHASE_18)
    phase_tp_serving(torch, card, served13)

    # 19. the long-context engines, host-timed, so also before any trace
    phase("phase 19: the long-context engines (ops/dev/probe_longctx.py, "
          "probe_longrange.py), GPT-2 1558M, 8 x (896 + 128) and 32 x "
          "(128 + 64)")
    phase_long_engines(torch, pa, device, card)

    # 21. Mellum 2, host-timed, so also before any trace
    phase(PHASE_21)
    phase_mellum(torch, pa, device)

    # 11. the kernel lab (its main path: the sweeps), then its kernels
    # timed
    phase(f"phase 11: the kernel lab, {LAB_ITERS} timed calls a run")
    lab_launches, lab_records = phase_lab_sweeps()
    log(f"  launches {lab_launches} (= the harness's calls)")
    lab = phase_lab_times(torch, lab_records, device)

    # 12. the decode-step probe
    phase("phase 12: the decode-step probe (ops/dev/probe_decode.py), every "
          "suite at 124M, the GEMV and kernel suites at 1558M")
    phase_probe(pa)
    trace_grid(torch, pa, records)
    cpu_ev, parts_ev, parts_n, cli_trace = profile_cli(torch, pa)
    log(f"  cli --profile (tiny checkpoint, greedy, batch 2): trace.json "
        f"with {cpu_ev} CPU operator events and {parts_ev} parts kernel "
        f"events for {parts_n} parts launches; read_trace: "
        + trace_summary(cli_trace))
    chunk_census(torch, cfg)

    # 20. the long-context probes' chunk cells, profiled as phase 12's
    phase("phase 20: the long-context chunk cells (ops/dev/probe_longctx.py "
          "matrix, probe_longrange.py cells), GPT-2 124M, int8")
    phase_long_cells(torch, pa, card)
    phase("done")
    log(f"  {time.monotonic() - t_start:.1f} s in all")

    kernels = []
    for wrapper, launches, source, replaces in (
            ("paged_decode_attention_parts",
             launches_f32["paged_decode_attention_parts"], KERNEL_SOURCE,
             TPU_KERNEL),
            ("paged_decode_attention_quant_parts",
             launches_main["paged_decode_attention_quant_parts"],
             KERNEL_SOURCE, TPU_KERNEL),
            ("paged_decode_attention_parts_mq",
             launches_spec_f32["paged_decode_attention_parts_mq"], MQ_SOURCE,
             MQ_TPU_KERNEL),
            ("paged_decode_attention_quant_parts_mq",
             launches_spec["paged_decode_attention_quant_parts_mq"],
             MQ_SOURCE, MQ_TPU_KERNEL),
            ("paged_decode_attention_grid",
             launches_cli["paged_decode_attention_grid"], GRID_SOURCE,
             GRID_TPU_KERNEL),
            ("paged_decode_attention_quant_grid",
             launches_cli["paged_decode_attention_quant_grid"], GRID_SOURCE,
             GRID_TPU_KERNEL)):
        rec = records[wrapper]
        kernels.append({
            "name": wrapper, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None})
    kernels.append(dict({"name": "causal_attention_flash", "route": "cuda",
                         "source": FLASH_SOURCE,
                         "replaces": FLASH_TPU_KERNEL}, **flash))
    for key, k in LAB_KERNELS.items():
        rec = lab[key]
        kernels.append({
            "name": key, "route": "cuda", "source": CSRC + k.source,
            "replaces": k.replaces, "launches": lab_launches[key],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
