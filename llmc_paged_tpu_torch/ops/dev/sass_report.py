"""What the port's CUDA sources compile to: each kernel's registers,
static shared memory, spills, tensor-core instructions (HMMA, HGMMA) and
TMA loads (UTMALDG), and a hash of its SASS instruction stream, for
checking that an edit leaves other instances unchanged.

Each ``csrc/<name>.cu`` is compiled to a cubin with the build's flags
(``ops/_build.py``) plus ``-Xptxas -v``; ``cuobjdump -sass`` lists its
functions. A function's hash covers its instructions and both 64-bit
words of each one's encoding (sm_90 prints the second word, which holds
the control bits, on a line of its own), so two builds of one instance
hash alike only if their SASS is identical. ``--against DIR`` compiles
the sources of another checkout's ``csrc`` too (for example the parent
commit's, unpacked with ``git archive``) and reports, for every function
there whose demangled name contains ``--kernel`` (by default
``parts_kernel``, the paged-attention parts template), whether a function
of this checkout has the same SASS.

Run (on a machine with nvcc):
    python -m llmc_paged_tpu_torch.ops.dev.sass_report [--against DIR]
        [--kernel NAME] [--out FILE]
It prints one line a function, then a JSON summary as its last line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor

from llmc_paged_tpu_torch.ops._build import CSRC, NVCC_FLAGS, nvcc_path

_PTXAS_FN = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
_PTXAS_SMEM = re.compile(r"(\d+) bytes smem")
_SASS_FN = re.compile(r"^\s*Function : (\S+)")
_SASS_INSN = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s*(.*)$")
_SASS_WORD = re.compile(r"^\s*/\*\s*(0x[0-9a-f]+)\s*\*/\s*$")


def _tool(name: str) -> str | None:
    nvcc = nvcc_path()
    cand = os.path.join(os.path.dirname(nvcc), name)
    return cand if os.path.isfile(cand) else shutil.which(name)


def _demangle(names):
    """Demangled names (cu++filt, else c++filt, else as they are)."""
    tool = _tool("cu++filt") or shutil.which("c++filt")
    if not tool or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else \
        {n: n for n in names}


def compile_report(csrc: str, name: str) -> list:
    """[{source, function, demangled, registers, smem, spill_stores,
    spill_loads, hmma, hgmma, utmaldg, instructions, sha}] of
    csrc/<name>.cu (smem: static shared memory bytes)."""
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, name + ".cubin")
        proc = subprocess.run(
            [nvcc_path(), *flags, "-cubin", "-Xptxas", "-v", "-o", cubin,
             os.path.join(csrc, name + ".cu")], capture_output=True,
            text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
        info, fn = {}, None
        for line in proc.stderr.splitlines():
            m = _PTXAS_FN.search(line)
            if m:
                fn = m.group(1)
                info[fn] = {"registers": None, "smem": 0,
                            "spill_stores": 0, "spill_loads": 0}
                continue
            if fn is None:
                continue
            m = _PTXAS_SPILL.search(line)
            if m:
                info[fn]["spill_stores"] = int(m.group(1))
                info[fn]["spill_loads"] = int(m.group(2))
            m = _PTXAS_REGS.search(line)
            if m:
                info[fn]["registers"] = int(m.group(1))
            m = _PTXAS_SMEM.search(line)
            if m:
                info[fn]["smem"] = int(m.group(1))
        sass = subprocess.run([_tool("cuobjdump") or "cuobjdump", "-sass",
                               cubin], capture_output=True, text=True,
                              check=True).stdout
    funcs, fn = {}, None
    for line in sass.splitlines():
        m = _SASS_FN.match(line)
        if m:
            fn = m.group(1)
            funcs[fn] = []
            continue
        if fn is None:
            continue
        m = _SASS_INSN.match(line)
        if m:
            funcs[fn].append(m.group(1).strip())
            continue
        m = _SASS_WORD.match(line)   # an instruction's second word
        if m and funcs[fn]:
            funcs[fn][-1] += " " + m.group(1)
    names = _demangle(list(funcs))
    out = []
    for f, insns in funcs.items():
        body = "\n".join(insns)
        out.append({
            "source": name, "function": f, "demangled": names[f],
            **info.get(f, {"registers": None, "smem": None,
                           "spill_stores": None, "spill_loads": None}),
            "hmma": sum(" HMMA" in f" {i}" for i in insns),
            "hgmma": sum(" HGMMA" in f" {i}" for i in insns),
            "utmaldg": sum(" UTMALDG" in f" {i}" for i in insns),
            "instructions": len(insns),
            "sha": hashlib.sha256(body.encode()).hexdigest()[:16]})
    return out


def report(csrc: str, names) -> list:
    """compile_report of every name, one nvcc each, all started together."""
    with ThreadPoolExecutor(max_workers=len(names)) as ex:
        parts = list(ex.map(lambda n: compile_report(csrc, n), names))
    return [r for p in parts for r in p]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", help="another checkout's csrc directory")
    ap.add_argument("--kernel", default="parts_kernel",
                    help="with --against: compare the functions whose "
                         "demangled name contains this")
    ap.add_argument("--out", help="write the records as JSON here")
    a = ap.parse_args(argv)
    names = sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))
    recs = report(CSRC, names)
    for r in recs:
        print(f"{r['source']}: {r['demangled']}: {r['registers']} regs, "
              f"spill {r['spill_stores']}/{r['spill_loads']} B, "
              f"{r['instructions']} insns, HMMA {r['hmma']}, "
              f"HGMMA {r['hgmma']}, UTMALDG {r['utmaldg']}, "
              f"sha {r['sha']}")
    summary = {"functions": len(recs),
               "spilling": sorted(r["demangled"] for r in recs
                                  if r["spill_stores"]),
               "with_hmma": sorted(r["demangled"] for r in recs
                                   if r["hmma"] or r["hgmma"])}
    if a.against:
        theirs = report(a.against, [n for n in names if os.path.exists(
            os.path.join(a.against, n + ".cu"))])
        ours = {r["sha"] for r in recs}
        pick = [r for r in theirs if a.kernel in r["demangled"]]
        same = [r for r in pick if r["sha"] in ours]
        summary["against"] = {
            "kernel": a.kernel, "compared": len(pick), "identical": len(same),
            "changed": sorted(f"{r['source']}: {r['demangled']}"
                              for r in pick if r["sha"] not in ours)}
    if a.out:
        with open(a.out, "w") as f:
            json.dump({"records": recs, "summary": summary}, f, indent=1)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
