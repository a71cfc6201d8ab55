"""Run one cell of BENCHMARK.json once, on the card, and print its result.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s>
                              --trace <0|1>

from the root of a checkout. The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``compared``: each
number of the correctness comparison beside its limit, which also close
standard error. Without a CUDA device, or with fewer than the cell asks
for, it exits 2 and prints no result; if JAX or the JAX package is loaded
once the window has closed, it exits 3 and prints no result.
"""

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that no run may load (the JAX package's name is a
# prefix of the port's, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "llmc_paged_tpu")


def forbidden_loaded():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _fail(msg: str, code: int) -> int:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the script's own folder would shadow top-level modules; the
    # checkout's root holds the benchmark's package and the program
    if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
        sys.path.pop(0)
    sys.path.insert(0, ROOT)
    # caches a library may keep, at fixed paths inside the checkout
    cache = os.path.join(ROOT, "build", "bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")

    import torch
    print(f"[bench] set-up: torch imported at "
          f"{time.monotonic() - T_PROCESS:.3f} s", file=sys.stderr)
    if not torch.cuda.is_available():
        return _fail("no CUDA device: the benchmark runs only on the card",
                     2)
    try:
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            bench = json.load(f)
    except OSError as e:
        return _fail(f"BENCHMARK.json: {e}", 2)
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        return _fail(f"no workload {args.workload!r} in BENCHMARK.json", 2)
    if torch.cuda.device_count() < entry["chips"]:
        return _fail(f"{args.workload} needs {entry['chips']} devices, "
                     f"{torch.cuda.device_count()} found", 2)
    try:
        from benchmarks import harness
    except ImportError as e:
        return _fail(f"the program is not importable: {e}", 2)

    out = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                           bool(args.trace), device="cuda",
                           t_process=T_PROCESS)
    loaded = forbidden_loaded()
    if loaded:
        return _fail(f"loaded in this process: {', '.join(loaded)}", 3)
    result = out["result"]
    print(f"[bench] compared {len(out['sample'])} requests, "
          f"{sum(len(r.generated) for r in out['sample'])} served tokens",
          file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
