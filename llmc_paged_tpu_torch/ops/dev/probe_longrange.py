"""Attention over long live ranges on the card (dev tool), port of
llmc_paged_tpu/ops/dev/probe_longrange.py.

The GPT-2 124M decode chunk (B=8, int8, page size 128) at prompt 896
(about 7.25 live pages a row), three ways, then GPT-2 1558M at B=32:

  int8-xlaattn  the plain parts path (``use_kernel=False``: gather the
                block table, dense parts) in place of the int8 parts
                kernel; probe_longctx's matrix has the kernel's cell;
  NBUF=8        the JAX kernel's DMA ring at twice its depth. The CUDA
                parts kernel has no ring of page buffers (a warp starts
                32 independent loads per 32-token chunk,
                csrc/paged_attention_parts.cuh), so this cell has no
                counterpart: one line says so;
  scale-DMA     the JAX kernel's mode that streams int8 scales through
                its ring, for pools whose pinned scales overflow the
                TPU's VMEM. The CUDA kernel reads each token group's
                scales from device memory (``__ldg``), so no mode is
                needed; its check carries over: ``scale_check`` holds
                the int8 parts kernel against its plain version at a
                1152-page pool (the 124M pool at pool_mult 16:
                (8·8 + 8)·16), then the chunk runs at pool_mult 16;
  m1558_b32     bench.py's stage at 1558M, B=32, 128 + 64 tokens, chunks
                of 32, int8 weights and KV (a TPU compile-cache warm-up
                in the JAX probe; here one serving_runs.run_paged).

Run: python -m llmc_paged_tpu_torch.ops.dev.probe_longrange [--skip-cells]
         [--skip-b32] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from llmc_paged_tpu_torch import resolve_device
from llmc_paged_tpu_torch.ops import paged_attention as pa
from llmc_paged_tpu_torch.ops.dev import serving_runs as SR
from llmc_paged_tpu_torch.ops.dev.probe_decode import (
    chunk_suite,
    launch_counts,
    launches_since,
)

# the cells' batch, committed context and the scale check's pool
CELL_B = 8
PROMPT = 896
SCALE_PAGES = 1152
POOL_MULT = 16
# a kernel output against its plain version: TOL_ABS + TOL_REL·|ref|
# (for acc the relative part is of |acc| + l, the mass it sums)
TOL_ABS, TOL_REL = 1e-4, 1e-4


def scale_inputs(P, B=8, NH=12, HS=64, ps=128, pps=8, seed=5):
    """The JAX probe's scale-DMA check inputs, as numpy arrays from
    default_rng(seed) in its order: f32 q, int8 pages, scales uniform in
    [0.005, 0.02], a permuted table, lengths in [1, pps·ps), starts 0."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, NH, HS)).astype(np.float32)
    kq = rng.integers(-127, 128, (P, NH, HS, ps)).astype(np.int8)
    vq = rng.integers(-127, 128, (P, NH, HS, ps)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, (P, NH, ps)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (P, NH, ps)).astype(np.float32)
    tables = rng.permutation(P)[: B * pps].reshape(B, pps).astype(np.int32)
    lengths = rng.integers(1, pps * ps, B).astype(np.int32)
    starts = np.zeros(B, np.int32)
    return q, kq, vq, ks, vs, tables, lengths, starts


def parts_within(got, ref):
    """max |Δ| of acc, m and l, and whether every element is within
    TOL_ABS + TOL_REL·|ref| (for acc, of |acc| + l)."""
    (acc, m, l), (racc, rm, rl) = got, ref
    errs = [(acc - racc).abs(), (m - rm).abs(), (l - rl).abs()]
    tols = [TOL_ABS + TOL_REL * (racc.abs() + rl[..., None]),
            TOL_ABS + TOL_REL * rm.abs(), TOL_ABS + TOL_REL * rl.abs()]
    return ([float(e.max()) for e in errs],
            all(bool((e <= t).all()) for e, t in zip(errs, tols)))


def scale_check(P=SCALE_PAGES, device=None, **shape):
    """paged_decode_attention_quant_parts (on the card, the kernel)
    against its plain version on scale_inputs(P, **shape); prints the max
    diffs and raises when any element is out of tolerance. Returns P,
    diffs, the plain parts (acc, m, l) and the kernels launched."""
    dev = resolve_device(device)
    args = [torch.from_numpy(a).to(dev) for a in scale_inputs(P, **shape)]
    before = launch_counts()
    out = pa.paged_decode_attention_quant_parts(*args)
    ref = pa.paged_decode_attention_quant_parts_ref(*args)
    kernels = launches_since(before)
    diffs, ok = parts_within(out, ref)
    print(f"== int8 parts kernel against its plain version at P={P}: "
          f"acc/m/l max diff {[f'{d:.3e}' for d in diffs]} (tol "
          f"{TOL_ABS:g} + {TOL_REL:g}*|ref|) ==", flush=True)
    if not ok:
        raise RuntimeError(f"int8 parts at P={P}: max diffs {diffs} exceed "
                           f"{TOL_ABS:g} + {TOL_REL:g}*|ref|")
    return dict(P=P, diffs=diffs, ref=ref, kernels=kernels)


def m1558_b32(params=None, cfg=None, B=32, prompt=128, new=64, chunk=32,
              device=None):
    """bench.py's m1558_b32 stage: serving_runs.run_paged at int8 weights
    and KV, one warm-up and two runs (LLMC_BENCH_SMOKE: prompt 32, 16 new
    tokens, chunks of 8). Prints and returns its record: tok_s,
    p50_ttft_s, runs, batch, new_tokens, and the best run's stats."""
    dev = resolve_device(device)
    cfg = SR.model_cfg("1558m") if cfg is None else cfg
    if SR.smoke():
        prompt, new, chunk = 32, 16, 8
    params = SR.device_params(cfg, dev) if params is None else params
    st = SR.run_paged(params, cfg, B, SR.prompts(cfg, B, prompt), new, chunk,
                      "int8", "int8", warmups=1, runs=2, device=dev)
    rec = {"tok_s": round(st["decode_tok_per_s"], 2),
           "p50_ttft_s": round(st["p50_ttft_s"], 4), "runs": st["runs"],
           "batch": B, "new_tokens": new}
    print(f"== m1558_b32 ({SR.cfg_name(cfg)}): {rec} ==", flush=True)
    return dict(rec, suite="m1558_b32", stats=st)


def main(argv=None):
    """The probe's entry point; returns the cells' records, the scale
    check's (P, diffs, kernels) and the B=32 run's."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--skip-cells", action="store_true")
    ap.add_argument("--skip-b32", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default: the card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {SR.device_label(dev)}", flush=True)
    records = []
    if not args.skip_cells:
        cfg = SR.model_cfg("124m")
        name = SR.cfg_name(cfg)
        print(f"== cell {name} prompt={PROMPT} int8-xlaattn (plain parts) "
              "==", flush=True)
        records += chunk_suite(CELL_B, cfg, dtypes=("int8-xlaattn",),
                               page_size=128, prompt=PROMPT, pool_mult=1,
                               device=dev)
        print(f"== cell {name} prompt={PROMPT} int8 NBUF=8: no counterpart "
              "(the CUDA parts kernel has no ring of page buffers: a warp "
              "starts 32 independent loads per 32-token chunk) ==",
              flush=True)
        sc = scale_check(SCALE_PAGES, device=dev)
        records.append(dict(suite="scale_check", P=sc["P"],
                            diffs=sc["diffs"], kernels=sc["kernels"]))
        print(f"== cell {name} prompt={PROMPT} pool_mult={POOL_MULT} int8 "
              "==", flush=True)
        records += chunk_suite(CELL_B, cfg, dtypes=("int8",), page_size=128,
                               prompt=PROMPT, pool_mult=POOL_MULT,
                               device=dev)
    if not args.skip_b32:
        records.append(m1558_b32(device=dev))
    return records


if __name__ == "__main__":
    main()
