#!/usr/bin/env python3
"""Smoke run of the torch port (llmc_paged_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero):
  1. device: name, power limit, torch/CUDA versions; TF32 off;
  2. build: the CUDA kernels from the sources in the checkout;
  3. kernel vs plain version: the flash-decode parts kernel against its
     plain PyTorch version for f32, bf16 and int8 pools at the GPT-2 124M
     head shapes, with ragged and zero lengths, window starts, ps=32 and
     B*pps > 4096; times from CUDA events beside the byte bound;
  4. engine, headline config: GPT-2 124M (seeded random weights) served
     by InferenceEngine.run with int8 weights, int8 KV, bf16 activations,
     a bf16 prefill copy, page_size 128 and greedy 16-token chunks;
     8 requests of 128-token prompts, 128 new tokens each;
  5. fp32 engine, kernel route vs plain route: token streams, and the
     logits of one decode_step_paged on both routes;
  6. loaded queue: 16 mixed-length requests through 8 slots with a pool
     small enough to force preemption.
The line before the last is a JSON object {"kernels": [...]}; the last
line is {"ok": true, "device": {...}}.

Exits non-zero, printing no result, without a GPU or outside a checkout
that holds the package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (dense): HBM bytes/s and fp32 (non-tensor) ops/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
TOL_ABS, TOL_REL = 1e-4, 1e-4
KERNEL_SOURCE = "llmc_paged_tpu_torch/csrc/paged_attention.cu"
TPU_KERNEL = "llmc_paged_tpu/ops/paged_attention.py:248"


def log(msg: str) -> None:
    print(msg, flush=True)


class Failed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise Failed(msg)


# ---- phase 3 helpers ---------------------------------------------------------

def make_case(torch, *, B, NH, HS, ps, pps, P, kv, lengths, starts, seed,
              device, repeat_pages=False):
    """Random q and pool for one kernel case (seeded, made on the card)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    q = torch.randn(B, NH, HS, generator=g, device=device)
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
    if repeat_pages:
        tables = torch.randint(0, P, (B, pps), generator=g, device=device,
                               dtype=torch.int32)
    else:
        perm = torch.randperm(P, generator=g, device=device)[: B * pps]
        tables = perm.reshape(B, pps).to(torch.int32)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=device)
    starts = torch.tensor(starts, dtype=torch.int32, device=device)
    return q, pool, tables, lengths, starts


def run_parts(pa, q, pool, tables, lengths, starts, plain=False):
    if len(pool) == 4:
        fn = (pa.paged_decode_attention_quant_parts_ref if plain
              else pa.paged_decode_attention_quant_parts)
    else:
        fn = (pa.paged_decode_attention_parts_ref if plain
              else pa.paged_decode_attention_parts)
    return fn(q, *pool, tables, lengths, starts)


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


def device_ms(torch, fn, iters=200):
    """Device time of one call: launches queue behind a sleep kernel, so
    the card runs them back to back whatever the host's launch cost."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def parts_cost(q, pool, tables, lengths, starts):
    """(bytes, f32 ops) the call must move and do for THESE inputs: each
    live page's K/V (and scales) read once, q and the outputs once."""
    B, NH, HS = q.shape
    ps = pool[0].shape[3]
    itemsize = pool[0].element_size()
    live_pages = 0
    live_tokens = 0
    for ln, st in zip(lengths.tolist(), starts.tolist()):
        if ln > 0 and ln > st:
            first, last = st // ps, (ln - 1) // ps
            live_pages += last - first + 1
            live_tokens += ln - st
    page_bytes = 2 * NH * HS * ps * itemsize
    if len(pool) == 4:
        page_bytes += 2 * NH * ps * 4
    nbytes = (live_pages * page_bytes + q.numel() * q.element_size()
              + B * NH * (HS + 2) * 4 + B * 4 * 2 + tables.numel() * 4)
    ops = live_tokens * NH * 4 * HS          # q·k and p·v, 2 ops per MAC
    return nbytes, ops


def phase_kernels(torch, pa, device):
    """Kernel vs plain version over the required cases; returns per-kernel
    records for the JSON line (times at the headline shapes)."""
    NH, HS = 12, 64
    rng_lengths = [200, 0, 1, 128, 129, 255, 384, 77]
    cases = [
        # (name, kwargs)
        ("headline", dict(B=8, ps=128, pps=3, P=28,
                          lengths=[130, 150, 170, 190, 210, 230, 250, 255],
                          starts=[0] * 8)),
        ("ragged+zero+boundary", dict(B=8, ps=128, pps=3, P=28,
                                      lengths=rng_lengths, starts=[0] * 8)),
        ("window", dict(B=8, ps=128, pps=3, P=28,
                        lengths=[384, 300, 256, 200, 384, 130, 5, 260],
                        starts=[256, 128, 200, 0, 129, 129, 7, 256])),
        ("ps32", dict(B=8, ps=32, pps=12, P=100,
                      lengths=[384, 0, 1, 32, 33, 100, 250, 383],
                      starts=[0, 0, 0, 0, 1, 40, 64, 300])),
        ("B*pps>4096", dict(B=8, ps=128, pps=520, P=64, repeat_pages=True,
                            lengths=[66560, 1, 0, 40000, 128, 129, 5000,
                                     66559],
                            starts=[0, 0, 0, 39000, 0, 0, 4000, 60000])),
    ]
    records = {}
    for kv in ("f32", "bf16", "int8"):
        wrapper = ("paged_decode_attention_quant_parts" if kv == "int8"
                   else "paged_decode_attention_parts")
        rec = records.setdefault(wrapper, {"max_abs_err": 0.0})
        for ci, (name, kw) in enumerate(cases):
            q, pool, tables, lengths, starts = make_case(
                torch, NH=NH, HS=HS, kv=kv, seed=100 + ci, device=device,
                **kw)
            got = run_parts(pa, q, pool, tables, lengths, starts)
            ref = run_parts(pa, q, pool, tables, lengths, starts, plain=True)
            torch.cuda.synchronize()
            errs, ok = max_err(torch, got, ref)
            err = max(errs)
            log(f"  {kv:5s} {name:22s} max|d| acc {errs[0]:.3e} m "
                f"{errs[1]:.3e} l {errs[2]:.3e} "
                f"{'ok' if ok else 'FAIL'}")
            check(ok, f"kernel vs plain mismatch: {kv} {name}")
            check(all(bool(torch.isfinite(t).all()) for t in got),
                  f"non-finite kernel output: {kv} {name}")
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            if name == "headline" and kv in ("f32", "int8"):
                # f32 serving pool for the float kernel, int8 for the quant
                ms = device_ms(torch, lambda: run_parts(
                    pa, q, pool, tables, lengths, starts))
                plain = device_ms(torch, lambda: run_parts(
                    pa, q, pool, tables, lengths, starts, plain=True),
                    iters=20)
                nbytes, ops = parts_cost(q, pool, tables, lengths, starts)
                t_bytes = nbytes / PEAK_BYTES_S * 1e3
                t_ops = ops / PEAK_F32_OPS_S * 1e3
                rec.update(ms=ms, plain_ms=plain,
                           bound_ms=max(t_bytes, t_ops),
                           bound_by="bytes" if t_bytes >= t_ops
                           else "operations", bytes=nbytes, ops=ops)
                log(f"  {kv:5s} headline time: kernel {ms * 1e3:.2f} us, "
                    f"plain {plain * 1e3:.2f} us, bound "
                    f"{max(t_bytes, t_ops) * 1e3:.3f} us "
                    f"({nbytes} B, {ops} f32 ops)")
    return records


# ---- phases 4-6 -----------------------------------------------------------

def prompts_for(torch, n, lengths, V, seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return [torch.randint(0, V, (ln,), generator=g, device=device).tolist()
            for ln in lengths[:n]]


def serve(torch, params, cfg, *, prompts, new, kv_dtype, param_dtype,
          num_pages, use_kernel=True, max_new=None, device="cuda",
          engine=None):
    from llmc_paged_tpu_torch.config import EngineConfig, PageConfig
    from llmc_paged_tpu_torch.engine.engine import InferenceEngine
    from llmc_paged_tpu_torch.engine.scheduler import Request
    if engine is None:
        quant = param_dtype == "int8"
        page = PageConfig(page_size=128, num_pages=num_pages, max_seqs=8,
                          pages_per_seq=3, kv_dtype=kv_dtype)
        econf = EngineConfig(
            cache_mode="paged", page=page, max_batch=8, greedy=True,
            decode_chunk=16, param_dtype=param_dtype,
            activation_dtype="bfloat16" if quant else "float32",
            prefill_param_dtype="bfloat16" if quant else None)
        engine = InferenceEngine(params, cfg, econf, device=device,
                                 use_kernel=use_kernel)
    reqs = [Request(rid=i, prompt=list(p),
                    max_new_tokens=(max_new[i] if max_new else new))
            for i, p in enumerate(prompts)]
    done = engine.run(reqs)
    torch.cuda.synchronize()
    return engine, sorted(done, key=lambda r: r.rid)


def reset_counts(pa):
    for k in pa.LAUNCHES:
        pa.LAUNCHES[k] = 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from llmc_paged_tpu_torch.config import GPT2Config
    from llmc_paged_tpu_torch.kv.layouts import init_pool, token_coords
    from llmc_paged_tpu_torch.models import gpt2, gpt2_paged
    from llmc_paged_tpu_torch.ops import _build
    from llmc_paged_tpu_torch.ops import paged_attention as pa

    device = "cuda"
    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    log(f"device: {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    log(smi.stdout.strip().splitlines()[0])     # name, power limit
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    # 2. build
    t0 = time.monotonic()
    _build.build_all(["paged_attention"])
    log(f"build: {time.monotonic() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in _build.BUILD_SECONDS.items())})")

    # 3. kernel vs plain
    log(f"phase 3: kernel vs plain version (tol {TOL_ABS:g} + "
        f"{TOL_REL:g}*|ref|; acc: + {TOL_REL:g}*(|acc|+l))")
    records = phase_kernels(torch, pa, device)

    # 4. headline engine (the main path)
    log("phase 4: GPT-2 124M, int8 weights + int8 KV, bf16 activations")
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
    st = eng.stats
    check(len(done) == 8 and all(len(r.generated) == 128 for r in done),
          "headline: not every request finished with 128 tokens")
    check(all(0 <= t < cfg.vocab_size for r in done for t in r.generated),
          "headline: token id out of range")
    want = cfg.num_layers * st["decode_steps"]
    check(launches_main["paged_decode_attention_quant_parts"] == want,
          f"headline: {launches_main} launches, want {want} int8 "
          f"(L x {st['decode_steps']} decode steps)")
    log(f"  decode_tok_per_s {st['decode_tok_per_s']:.1f}, p50_ttft_s "
        f"{st['p50_ttft_s']:.4f}, decode steps {st['decode_steps']}, "
        f"launches {launches_main}, wall {st['wall_s']:.3f} s (host: "
        f"prefill dispatch {st['t_prefill_dispatch_s']} s, chain dispatch "
        f"{st['t_chain_dispatch_s']} s, materialize "
        f"{st['t_materialize_s']} s)")

    # 5. fp32 engine: kernel route vs plain route
    log("phase 5: fp32 engine, kernel route vs plain route")
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
    from llmc_paged_tpu_torch.config import PageConfig
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
    log("phase 6: loaded queue, 16 requests through 8 slots")
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

    kernels = []
    for wrapper, launches in (
            ("paged_decode_attention_parts",
             launches_f32["paged_decode_attention_parts"]),
            ("paged_decode_attention_quant_parts",
             launches_main["paged_decode_attention_quant_parts"])):
        rec = records[wrapper]
        kernels.append({
            "name": wrapper, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": TPU_KERNEL, "launches": launches,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None})
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
