"""The long-context engine's full stats and the chunk isolation matrix on
the card (dev tool), port of llmc_paged_tpu/ops/dev/probe_longctx.py.

Two measurements:

1. ``long_ctx_engine``: the JAX benchmark's long-context configuration
   (GPT-2 1558M, int8 weights and KV, bf16 activations and prefill copy,
   8 prompts of 896 tokens + 128 new, chunks of 32, page size 128,
   pps = ceil(1024/128) + 1 = 9, greedy), one warm run of 4 tokens, then
   two runs, each printed with its wall time, decode tok/s, ms a step
   (B / tok/s), every ``t_*`` host bucket of the engine's stats, the
   rest of its stats and the kernels it launched.
2. ``chunk_matrix``: the decode chunk of GPT-2 124M (int8, page size 128)
   at prompt 128 and 896 × pool_mult 1, 4 and 16, through
   ``probe_decode.chunk_suite``: whether a step's cost follows the live
   range or the pool's size.

The JAX probe replicated bench.py's programs to hit a TPU compile cache
and rode one relay session; nothing here compiles ahead, so each part
runs on its own. Functions take their sizes as arguments (the CPU tests
run them small) and ``device`` (None: the card, raising without one).

Run: python -m llmc_paged_tpu_torch.ops.dev.probe_longctx [--skip-matrix]
         [--skip-engine] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

from llmc_paged_tpu_torch import resolve_device
from llmc_paged_tpu_torch.ops.dev import serving_runs as SR
from llmc_paged_tpu_torch.ops.dev.probe_decode import (
    chunk_suite,
    launch_counts,
    launches_since,
)


def long_ctx_engine(cfg=None, params=None, B=8, prompt=896, new=128,
                    chunk=32, page_size=128, warm_new=4, seed=11,
                    device=None):
    """The long-context engine (module docstring, 1): ``cfg`` defaults to
    GPT-2 1558M, ``params`` (f32) to serving_runs.device_params. Returns
    one record a run, the warm run first: tag, wall_s, tok_s, ms_step,
    stats, generated (each row's token count) and launches (by wrapper,
    counted during the run)."""
    dev = resolve_device(device)
    cfg = SR.model_cfg("1558m") if cfg is None else cfg
    pps = -(-(prompt + new) // page_size) + 1
    t0 = time.monotonic()
    params = SR.device_params(cfg, dev) if params is None else params
    eng = SR.engine(params, cfg, param_dtype="int8", kv_dtype="int8", B=B,
                    CHUNK=chunk, num_pages=B * pps + 4, pages_per_seq=pps,
                    page_size=page_size, device=dev)
    lprompts = SR.prompts(cfg, B, prompt, seed=seed)
    records = []
    for tag, n in (("warm", warm_new), ("run0", new), ("run1", new)):
        before = launch_counts()
        t1 = time.monotonic()
        done = SR.run_requests(eng, lprompts, n)
        wall = time.monotonic() - t1
        st = dict(eng.stats)
        rec = dict(suite="long_ctx", tag=tag, config=(B, prompt, n, chunk,
                                                      page_size, pps),
                   wall_s=wall, tok_s=st["decode_tok_per_s"],
                   ms_step=B / st["decode_tok_per_s"] * 1e3, stats=st,
                   generated=[len(r.generated) for r in done],
                   launches=launches_since(before))
        records.append(rec)
        if len(done) != B or any(g != n for g in rec["generated"]):
            raise RuntimeError(f"long_ctx {tag}: rows finished with "
                               f"{rec['generated']} tokens, want {B} x {n}")
        if tag == "warm":
            print(f"-- engine up ({time.monotonic() - t0:.1f}s, "
                  f"{SR.cfg_name(cfg)}, pps {pps}, {B * pps + 4} pages) --",
                  flush=True)
            continue
        print(f"== long_ctx {tag}: wall {wall:.2f}s decode "
              f"{rec['tok_s']:.1f} tok/s (={rec['ms_step']:.2f} ms/step) ==",
              flush=True)
        keys = sorted(k for k in st if k.startswith("t_"))
        print("   host buckets: " + " ".join(f"{k}={st[k]:.4f}s"
                                             for k in keys), flush=True)
        print("   full stats: " + " ".join(
            f"{k}={v}" for k, v in sorted(st.items())
            if not k.startswith("t_")), flush=True)
        print(f"   launches: {rec['launches']}", flush=True)
    del eng
    return records


def chunk_matrix(cfg=None, B=8, prompts=(128, 896), pool_mults=(1, 4, 16),
                 dtype="int8", page_size=128, device=None):
    """The chunk isolation matrix (module docstring, 2): one
    probe_decode.chunk_suite record a (prompt, pool_mult) cell; ``cfg``
    defaults to GPT-2 124M."""
    dev = resolve_device(device)
    cfg = SR.model_cfg("124m") if cfg is None else cfg
    records = []
    for prompt in prompts:
        for mult in pool_mults:
            print(f"== chunk cell {SR.cfg_name(cfg)} prompt={prompt} "
                  f"pool_mult={mult} ==", flush=True)
            records += chunk_suite(B, cfg, dtypes=(dtype,),
                                   page_size=page_size, prompt=prompt,
                                   pool_mult=mult, device=dev)
    return records


def main(argv=None):
    """The probe's entry point; returns the engine's and the matrix's
    records."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--skip-matrix", action="store_true")
    ap.add_argument("--skip-engine", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default: the card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {SR.device_label(dev)}", flush=True)
    records = []
    if not args.skip_engine:
        records += long_ctx_engine(device=dev)
    if not args.skip_matrix:
        records += chunk_matrix(device=dev)
    return records


if __name__ == "__main__":
    main()
