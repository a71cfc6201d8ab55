"""What one decode chunk moves, read from a torch.profiler trace (dev
tool), the port's counterpart of llmc_paged_tpu/ops/dev/dump_chunk_hlo.py.

The JAX tool compiles the chunk and greps its HLO for pool-sized
``copy``/``dynamic-update-slice``/``fusion`` ops, split into the scan's
while-loop body (per STEP) and the rest (per CHUNK): it exists to catch a
whole-pool copy on every step, which no kernel-level timing can see. The
port's chunk (models/gpt2_paged.decode_chunk_paged) is eager PyTorch,
with no compiled program to grep, so this tool profiles one warm call
with CPU and CUDA activities and ``record_shapes=True`` and reads the
Chrome trace instead:

  * census: every operator that takes a tensor of one layer's pool
    plane (P*NH*HS*ps elements, kv/layouts.py) or of its scales (P*NH*ps),
    the outermost one where such operators nest, and only if it or an
    operator inside it does more than make a view. In-place indexed
    writes (``index_put_``, ``index_copy_``, ``scatter_`` ...) and
    indexed reads (``index``, ``gather`` ...) are listed apart from the
    operators that move the whole plane (``copy_``, ``clone``, ``cat``,
    ``to``, ``where``, elementwise ...). Each line gives the count, the
    MB from the shapes and dtypes (the plane-sized inputs of a
    whole-plane operator; the other inputs of an indexed one: the rows
    and indices) and the device µs of the kernels the operators launched
    (a kernel's correlation id gives its launch call, and the launch lies
    inside the operator on the host's timeline), for one step or for the
    chunk's once-a-chunk operators;
  * per STEP against per CHUNK: the eager chunk has no loop body to
    split by, so the chunk is profiled at S and at 2S steps: per step =
    (n(2S) - n(S)) / S, per chunk = n(S) - S * per step. Both must be
    non-negative integers; where they are not, the raw counts are
    printed;
  * the profiler's ``with_flops`` total in place of ``cost_analysis``
    (it counts matrix products only), or "not available";
  * ``read_trace`` (also for any Chrome trace of the port, e.g. the CLI's
    ``--profile DIR/trace.json``): the card's busy ms (the union of
    kernel, memcpy and memset intervals), the window (first start to
    last end of the trace's timed events) and the idle share
    1 - busy/window, the ten kernels with the most total time, and the
    five longest idle gaps with the innermost host operator running at
    each gap's start.

Weights are seeded (f32 from a torch.Generator on the device, as the
probe makes them); ``int8`` is int8 weights with bf16 activations over an
int8 pool, as in the JAX tool. The pool has (B*pps + 8) * pool_mult
pages, pps = ceil((prompt + 2*chunk) / page_size) (at least 2), so both
profiled calls fit; coordinates come from the port's BlockManager.

Run: python -m llmc_paged_tpu_torch.ops.dev.dump_chunk_trace [--model 124m]
         [--prompt 128] [--pool-mult 4] [--dtypes int8] [--chunk 32]
         [--batch 8] [--no-kernel] [--save PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import math
import operator
import os
import time
import tempfile

import torch

from llmc_paged_tpu_torch import resolve_device
from llmc_paged_tpu_torch.config import GPT2Config, PageConfig
from llmc_paged_tpu_torch.kv.layouts import init_pool
from llmc_paged_tpu_torch.models import gpt2
from llmc_paged_tpu_torch.models.gpt2_paged import decode_chunk_paged
from llmc_paged_tpu_torch.ops.dev.probe_decode import _chunk_coords, _params
from llmc_paged_tpu_torch.ops.int8 import quantize_params

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_OP_CATS = ("cpu_op", "user_annotation")
# operators that only make a view or hand back their input: an operator
# counts as moving data only if it, or one inside it, is not one of these
PLUMBING = frozenset(f"aten::{n}" for n in (
    "view", "reshape", "_reshape_alias", "as_strided", "select", "slice",
    "narrow", "unsqueeze", "squeeze", "permute", "transpose", "t", "expand",
    "expand_as", "alias", "detach", "contiguous", "to", "lift_fresh",
    "unbind", "split", "chunk", "view_as", "flatten", "unflatten",
    "numpy_T", "empty", "empty_like", "empty_strided", "result_type"))
INDEXED_WRITES = frozenset(f"aten::{n}" for n in (
    "index_put_", "index_put", "_index_put_impl_", "index_copy_",
    "scatter_", "scatter_add_", "index_add_", "index_fill_", "put_",
    "masked_scatter_"))
INDEXED_READS = frozenset(f"aten::{n}" for n in (
    "index", "index_select", "gather", "take", "embedding"))
# "Input type" names of the profiler → bytes an element
ITEMSIZE = {"float": 4, "double": 8, "c10::BFloat16": 2, "c10::Half": 2,
            "signed char": 1, "unsigned char": 1, "bool": 1, "short int": 2,
            "int": 4, "long int": 8}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# tiny kernels of profile_chunk's warmup step
LEAD_IN = 32


def _params_for(p32, cfg, dtype: str, dev):
    """Serving weights for ``dtype``: int8 → int8 weights, bf16
    activations (the JAX tool's int8); else that float dtype."""
    if dtype == "int8":
        return quantize_params(gpt2.to_device(p32, cfg, torch.bfloat16, dev))
    return gpt2.to_device(p32, cfg, _DTYPES[dtype], dev)


def build_args(cfg: GPT2Config, prompt: int, pool_mult: int, dtype: str,
               B: int = 8, chunk: int = 32, page_size: int = 128,
               device=None) -> dict:
    """The chunk's inputs for ``cfg``: seeded weights in ``dtype``, a
    zeroed pool, B rows holding ``prompt`` tokens with 2*chunk more
    reserved by the BlockManager. Returns a dict with cfg, page_cfg,
    params, pool, first, pos0, pages and slots (2*chunk, B) and tables."""
    dev = resolve_device(device)
    pps = max(2, -(-(prompt + 2 * chunk) // page_size))
    page_cfg = PageConfig(page_size=page_size,
                          num_pages=(B * pps + 8) * pool_mult, max_seqs=B,
                          pages_per_seq=pps)
    pgs, sls, tables = (torch.from_numpy(a).to(dev) for a in
                        _chunk_coords(B, prompt, 2 * chunk, page_cfg))
    return dict(cfg=cfg, page_cfg=page_cfg,
                params=_params_for(_params(cfg, dev), cfg, dtype, dev),
                pool=init_pool(cfg, page_cfg,
                               dtype="int8" if dtype == "int8" else dtype,
                               device=dev),
                first=torch.zeros(B, dtype=torch.int32, device=dev),
                pos0=torch.full((B,), prompt, dtype=torch.int32, device=dev),
                pages=pgs, slots=sls, tables=tables)


def profile_chunk(a: dict, steps: int, path: str,
                  use_kernel: bool = True, warm: bool = True) -> float:
    """One decode_chunk_paged call of ``steps`` steps under
    torch.profiler (CPU and, on the card, CUDA activity, shapes and
    FLOPs), its Chrome trace written to ``path``; ``warm`` runs the chunk
    once unprofiled first (a caller that has just run it passes False).
    Returns the profiler's FLOP total (0.0 when it counted none), summed over its raw events:
    ``key_averages()`` would first build Python objects for every event,
    about 0.1 ms each, minutes for a chunk's trace."""
    from torch.profiler import ProfilerActivity, profile, schedule
    dev = a["first"].device
    cfg = a["cfg"]

    def call():
        decode_chunk_paged(a["params"], a["first"], a["pos0"],
                           a["pages"][:steps], a["slots"][:steps],
                           a["tables"], a["pool"], cfg, num_steps=steps,
                           window=cfg.max_seq_len, use_kernel=use_kernel)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    # a warmup step before the recorded one: the card's first kernel
    # records after a session starts can be lost (0-94 launches of a
    # chunk profiled after others in one process, on an H100; none in
    # ten sessions once the tracer runs through a warmup step first)
    sched = schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.no_grad():
        if warm:
            call()
        with profile(activities=acts, record_shapes=True, with_flops=True,
                     schedule=sched) as prof:
            lead = torch.zeros(1, device=dev)
            for _ in range(LEAD_IN):
                lead.add_(1)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            prof.step()
            call()
            prof.step()
    prof.export_chrome_trace(path)
    try:
        return float(sum(e.flops() for e in
                         prof.profiler.kineto_results.events()))
    except AttributeError:         # a PyTorch whose events carry no FLOPs
        return 0.0


# ---- reading a trace --------------------------------------------------------

def load_events(trace) -> list:
    """The timed ("X") events of a Chrome trace: its path, or the list
    this function returned for it (a chunk's trace is read once)."""
    if isinstance(trace, list):
        return trace
    with open(trace) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "ts" in e]


def _union(spans):
    """Merged (start, end) intervals of ``spans``, in order."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(ops, t):
    """Name of the innermost host operator running at time t (the one
    that started last among those that contain t), or None."""
    best = None
    for e in ops:
        if e["ts"] <= t < e["ts"] + e.get("dur", 0):
            if best is None or e["ts"] >= best["ts"]:
                best = e
    return None if best is None else best["name"]


def read_trace(path, top: int = 10, gaps: int = 5) -> dict:
    """Where the card's time went in a Chrome trace of the port (its
    path, or load_events' list for it).

    Returns busy_ms (union of kernel, memcpy and memset intervals),
    window_ms (first start to last end of all timed events), idle_share
    (1 - busy/window; None when the trace holds no device activity),
    device_events, top_kernels ([{name, count, ms}], the ``top`` kernels
    by total time) and gaps ([{start_ms, ms, op}], the ``gaps`` longest
    idle intervals of the window, before, between and after the busy
    intervals, start_ms from the window's start, op the innermost host
    operator running at the gap's start)."""
    events = load_events(path)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    ops = [e for e in events if e.get("cat") in HOST_OP_CATS]
    timed = [e for e in events if e.get("cat") != "Trace"]
    t0 = min((e["ts"] for e in timed), default=0.0)
    t1 = max((e["ts"] + e.get("dur", 0) for e in timed), default=0.0)
    busy = _union((e["ts"], e["ts"] + e.get("dur", 0)) for e in dev)
    busy_us = sum(e - s for s, e in busy)
    window_us = t1 - t0
    per = collections.defaultdict(lambda: [0, 0.0])
    for e in dev:
        if e["cat"] == "kernel":
            per[e["name"]][0] += 1
            per[e["name"]][1] += e.get("dur", 0)
    top_k = sorted(per.items(), key=lambda kv: -kv[1][1])[:top]
    idle = []
    if busy:
        edges = [t0] + [x for se in busy for x in se] + [t1]
        idle = [(s, e - s) for s, e in zip(edges[::2], edges[1::2])
                if e > s]
    idle.sort(key=lambda g: -g[1])
    return dict(
        busy_ms=busy_us / 1e3, window_ms=window_us / 1e3,
        idle_share=(1.0 - busy_us / window_us) if busy and window_us > 0
        else None,
        device_events=len(dev),
        top_kernels=[dict(name=n, count=c, ms=us / 1e3)
                     for n, (c, us) in top_k],
        gaps=[dict(start_ms=(s - t0) / 1e3, ms=d / 1e3,
                   op=_innermost(ops, s)) for s, d in idle[:gaps]])


def _tensor_dims(entry):
    """The shapes an "Input Dims" entry holds: one for a tensor, several
    for a tensor list, none for a scalar or a 0-d tensor."""
    if not entry:
        return []
    if all(isinstance(d, int) for d in entry):
        return [entry]
    return [d for d in entry if isinstance(d, list) and d
            and all(isinstance(x, int) for x in d)]


def _category(name: str) -> str:
    if name in INDEXED_WRITES:
        return "indexed write"
    if name in INDEXED_READS:
        return "indexed read"
    return "whole plane"


def census(path, plane_elems: int, scale_elems: int) -> dict:
    """Operators of a chunk trace (a path, or load_events' list) that take
    a pool plane or its scales (see the module docstring): {(category,
    op, tag): [count, MB, device µs]}, tag "pool" or "scale"."""
    events = load_events(path)
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    # by thread and start, an operator before those it contains (two
    # stable sorts on item keys: a Python key function costs seconds)
    ops.sort(key=operator.itemgetter("dur"), reverse=True)
    ops.sort(key=operator.itemgetter("tid", "ts"))
    # launch calls by correlation id → the kernels' launch times by thread
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    launches = collections.defaultdict(list)       # tid → [(ts, dev µs)]
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            call = launch.get(e.get("args", {}).get("correlation"))
            if call is not None:
                launches[call["tid"]].append((call["ts"], e.get("dur", 0)))
    for v in launches.values():
        v.sort()

    # the operator tree of each thread
    parent, stack = {}, []
    for i, e in enumerate(ops):
        while stack and not (ops[stack[-1]]["tid"] == e["tid"]
                             and e["ts"] < ops[stack[-1]]["ts"]
                             + ops[stack[-1]].get("dur", 0)):
            stack.pop()
        parent[i] = stack[-1] if stack else None
        stack.append(i)
    moves = [e["name"] not in PLUMBING for e in ops]
    for i in range(len(ops) - 1, -1, -1):         # children follow parents
        if moves[i] and parent[i] is not None:
            moves[parent[i]] = True

    def tag(e):
        dims = e.get("args", {}).get("Input Dims", [])
        sizes = [math.prod(d) for ent in dims for d in _tensor_dims(ent)]
        if plane_elems in sizes:
            return "pool"
        return "scale" if scale_elems in sizes else None

    def mbytes(e, cat):
        args = e.get("args", {})
        total = 0
        for ent, ty in zip(args.get("Input Dims", []),
                           args.get("Input type", [])):
            for d in _tensor_dims(ent):
                n = math.prod(d)
                plane = n in (plane_elems, scale_elems)
                if plane == (cat == "whole plane"):
                    total += n * ITEMSIZE.get(ty, 4)
        return total / 1e6

    out = collections.defaultdict(lambda: [0, 0.0, 0.0])
    counted = set()
    for i, e in enumerate(ops):
        a = parent[i]
        while a is not None and a not in counted:
            a = parent[a]
        if a is not None or not moves[i]:
            continue
        t = tag(e)
        if t is None:
            continue
        counted.add(i)
        cat = _category(e["name"])
        rec = out[(cat, e["name"], t)]
        rec[0] += 1
        rec[1] += mbytes(e, cat)
        lt = launches.get(e["tid"], [])
        lo = bisect.bisect_left(lt, (e["ts"], -1.0))
        hi = bisect.bisect_right(lt, (e["ts"] + e.get("dur", 0),
                                      float("inf")))
        rec[2] += sum(d for _, d in lt[lo:hi])
    return dict(out)


def split_steps(c1: dict, c2: dict, steps: int) -> dict:
    """Per STEP and per CHUNK counts from the census at S (c1) and 2S
    (c2) steps: {key: dict(step, chunk, n_S, n_2S)}. ``step`` and
    ``chunk`` are ints when the split comes out as non-negative integers,
    else None (the raw counts stand)."""
    out = {}
    for key in sorted(set(c1) | set(c2)):
        n1 = c1.get(key, [0])[0]
        n2 = c2.get(key, [0])[0]
        step, rem = divmod(n2 - n1, steps)
        chunk = n1 - steps * step
        ok = rem == 0 and step >= 0 and chunk >= 0
        out[key] = dict(step=step if ok else None,
                        chunk=chunk if ok else None, n_S=n1, n_2S=n2)
    return out


def analyze(a: dict, traces: dict, steps: int, itemsize: int,
            flops: float = 0.0, report=print) -> dict:
    """The census of the chunk's traces at ``steps`` (S) and 2S steps
    (``traces``: {steps: path}), split per step and per chunk, with
    read_trace's summary of the S trace and the parts-kernel launches of
    each trace. Prints the table through ``report``; returns the
    record."""
    cfg, page_cfg = a["cfg"], a["page_cfg"]
    plane = (page_cfg.num_pages * cfg.num_heads * cfg.head_dim
             * page_cfg.page_size)
    scale = page_cfg.num_pages * cfg.num_heads * page_cfg.page_size
    events = {s: load_events(p) for s, p in traces.items()}
    cen = {s: census(ev, plane, scale) for s, ev in events.items()}
    split = split_steps(cen[steps], cen[2 * steps], steps)
    parts = {s: sum(1 for e in ev if e.get("cat") == "kernel"
                    and "parts_kernel" in e["name"])
             for s, ev in events.items()}
    summary = read_trace(events[steps])
    report(f"pool plane elems={plane} ({plane * itemsize / 1e6:.1f} MB @ "
           f"{itemsize}B), scale elems={scale}")
    integral = all(v["step"] is not None for v in split.values())
    for key, v in split.items():
        cat, op, t = key
        n1, mb1, us1 = cen[steps].get(key, [0, 0.0, 0.0])
        n2, mb2, us2 = cen[2 * steps].get(key, [0, 0.0, 0.0])
        if v["step"] is None:
            report(f"  [{cat:13s}] {op + ':' + t:32s} raw counts: "
                   f"{v['n_S']} at S={steps}, {v['n_2S']} at "
                   f"S={2 * steps} (no integer split)")
            continue
        if v["chunk"] == 0:          # all per step: the S call's average
            lines = [("per STEP", v["step"], mb1 / steps, us1 / steps)]
        elif v["step"] == 0:         # all per chunk: the S call's
            lines = [("per CHUNK", v["chunk"], mb1, us1)]
        else:                        # both: split the sizes as the counts
            mb_step, us_step = (mb2 - mb1) / steps, (us2 - us1) / steps
            lines = [("per STEP", v["step"], mb_step, us_step),
                     ("per CHUNK", v["chunk"], mb1 - steps * mb_step,
                      us1 - steps * us_step)]
        for where, n, mb, us in lines:
            report(f"  {where:9s} [{cat:13s}] {op + ':' + t:32s} "
                   f"x{n:4d}  {mb:9.3f} MB  {us:10.1f} us")
    if not split:
        report("  no operator takes a pool plane or its scales")
    report("  flops (with_flops): " + (f"{flops:.3e}" if flops
                                       else "not available"))
    report("  trace S: " + (
        "no device activity" if summary["idle_share"] is None else
        f"busy {summary['busy_ms']:.3f} ms of {summary['window_ms']:.3f}"
        f" ms, idle share {summary['idle_share']:.3f}") +
        f"; parts kernels {parts}")
    return dict(census=cen, split=split, integral=integral,
                parts_kernels=parts, summary=summary, flops=flops,
                plane_elems=plane, scale_elems=scale)


def run(cfg: GPT2Config, dtype: str, *, prompt=128, pool_mult=4, chunk=32,
        batch=8, use_kernel=True, save="", device=None, report=print,
        label=None) -> dict:
    """build_args, the two profiled calls and analyze for one dtype;
    traces go to ``save``.<dtype>.S<steps>.json, or to a temporary
    directory that is removed."""
    a = build_args(cfg, prompt, pool_mult, dtype, B=batch, chunk=chunk,
                   device=device)
    report(f"== {label or 'model'} {dtype} prompt={prompt} "
           f"pool={a['page_cfg'].num_pages}p chunk={chunk} "
           f"kernel={use_kernel} device={a['first'].device} ==")
    with tempfile.TemporaryDirectory() as d:
        traces, flops, took = {}, 0.0, []
        for s in (chunk, 2 * chunk):
            base = save or os.path.join(d, "chunk")
            traces[s] = f"{base}.{dtype}.S{s}.json"
            t0 = time.monotonic()
            f = profile_chunk(a, s, traces[s], use_kernel,
                              warm=s == chunk)
            took.append(f"S={s} profiled and written in "
                        f"{time.monotonic() - t0:.1f} s "
                        f"({os.path.getsize(traces[s]) / 1e6:.0f} MB)")
            if s == chunk:
                flops = f
        itemsize = 1 if dtype == "int8" else _DTYPES[dtype].itemsize
        t0 = time.monotonic()
        rec = analyze(a, traces, chunk, itemsize, flops, report)
        report(f"  {'; '.join(took)}; read in "
               f"{time.monotonic() - t0:.1f} s")
    rec.update(dtype=dtype, steps=chunk, num_layers=cfg.num_layers,
               traces=traces if save else None)
    return rec


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="124m",
                    choices=["124m", "350m", "774m", "1558m"])
    ap.add_argument("--prompt", type=int, default=128)
    ap.add_argument("--pool-mult", type=int, default=4)
    ap.add_argument("--dtypes", default="int8",
                    help="comma list of int8, float32, bfloat16")
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--no-kernel", action="store_true")
    ap.add_argument("--save", default="",
                    help="also keep the Chrome traces as "
                         "SAVE.<dtype>.S<steps>.json")
    ap.add_argument("--device", default=None,
                    help="cuda (the default: the card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = getattr(GPT2Config, f"gpt2_{args.model}")()
    return [run(cfg, dtype, prompt=args.prompt, pool_mult=args.pool_mult,
                chunk=args.chunk, batch=args.batch,
                use_kernel=not args.no_kernel, save=args.save, device=dev,
                label=args.model)
            for dtype in args.dtypes.split(",")]


if __name__ == "__main__":
    main()
