"""The readings a cell's correctness limits are set from (the benchmark's
own runs never run this).

    python3 benchmarks/control.py --workload <cell> --seeds 11,12,...
                                  [--seconds 10] [--out PATH]

For each seed, in one process: one run of the cell at its own load with a
short window, then its sample of served requests read against the
reference twice, the program's served tokens (the lower reading) and the
control's own picks, the reference computed one precision below the
configuration's (the upper reading; the family's ``CONTROL``). One
JSON line a seed, then a summary: for each number compared, the largest
program reading, the smallest control reading and their ratio. A limit
goes between the two (PERF.md gives the readings and the limits).
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def calibrate(bench, workload, seeds, seconds, device="cuda", registry=None,
              out=None):
    """Per-seed readings and their summary, as dicts."""
    from benchmarks import harness
    rows = []
    for seed in seeds:
        got = harness.run_cell(bench, workload, seed, seconds, False,
                               device=device, registry=registry,
                               control=True)
        row = {"seed": seed, "correct": got["result"]["correct"],
               "program": got["readings"]["program"],
               "control": got["readings"]["control"],
               "sample_requests": len(got["sample"]),
               "served_tokens": sum(len(r.generated) for r in got["sample"]),
               "metrics": got["result"]["metrics"]}
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            with open(out, "a") as f:
                f.write(line + "\n")
    summary = {}
    for name in rows[0]["program"]:
        lo = max(r["program"][name] for r in rows)
        hi = min(r["control"][name] for r in rows)
        summary[name] = {"program_max": lo, "control_min": hi,
                         "ratio": hi / lo if lo > 0 else None}
    return rows, summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
        sys.path.pop(0)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("[control] no CUDA device", file=sys.stderr)
        return 2
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    seeds = [int(s) for s in args.seeds.split(",")]
    _, summary = calibrate(bench, args.workload, seeds, args.seconds,
                           out=args.out)
    print(json.dumps({"workload": args.workload, "summary": summary}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
