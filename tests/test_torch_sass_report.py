"""ops/dev/sass_report.py reads ptxas's and cuobjdump's output right: the
tools are faked with canned output (there is no nvcc here), so this
checks the parsing and the comparison against another tree."""

import types

from llmc_paged_tpu_torch.ops.dev import sass_report as S

PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z4mmaf' for 'sm_90a'
ptxas info    : Function properties for _Z4mmaf
    24 bytes stack frame, 24 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_Z12parts_kernelv' for 'sm_90a'
ptxas info    : Function properties for _Z12parts_kernelv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 127 registers, used 1 barriers, 400 bytes cmem[0]
"""


def _sass(parts_op, parts_ctrl="0x000fe40000000800"):
    """cuobjdump -sass as sm_90 prints it: each instruction's first
    encoding word on its line, the second (control bits) on the next."""
    return f"""\
\tcode for sm_90a
\t\tFunction : _Z4mmaf
\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;     /* 0x00000a00ff017b82 */
                                                              /* 0x000fe40000000800 */
        /*0010*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;  /* 0x0000000c0804723c */
                                                              /* 0x004fde0000041804 */
        /*0020*/                   HMMA.16816.F32.BF16 R4, R8, R14, R4 ;  /* 0x0000000e0804723c */
                                                              /* 0x004fde0000041804 */
\t\t..........
\t\tFunction : _Z12parts_kernelv
        /*0000*/                   {parts_op} R1, c[0x0][0x28] ;     /* 0x00000a00ff017b82 */
                                                              /* {parts_ctrl} */
        /*0010*/                   EXIT ;                     /* 0x000000000000794d */
"""


def _fake_tools(monkeypatch, sass_by_tree):
    """nvcc, cuobjdump and the demangler faked: the SASS returned is that
    of the tree whose source nvcc compiled last."""
    monkeypatch.setattr(S, "nvcc_path", lambda: "fake-cuda/bin/nvcc")
    last = {}

    def run(cmd, input=None, capture_output=True, text=True, check=False):
        tool = cmd[0].rsplit("/", 1)[-1]
        if tool == "nvcc":
            last["tree"] = cmd[-1].split("/")[-2]
            return types.SimpleNamespace(returncode=0, stdout="",
                                         stderr=PTXAS)
        if tool == "cuobjdump":
            return types.SimpleNamespace(returncode=0,
                                         stdout=sass_by_tree[last["tree"]])
        return types.SimpleNamespace(returncode=0, stdout=input)  # demangler

    monkeypatch.setattr(S.subprocess, "run", run)


def test_compile_report_reads_registers_spills_and_mma(monkeypatch):
    _fake_tools(monkeypatch, {"ours": _sass("LDC")})
    recs = {r["function"]: r for r in S.compile_report("/src/ours", "k")}
    mma, parts = recs["_Z4mmaf"], recs["_Z12parts_kernelv"]
    assert (mma["registers"], mma["spill_stores"], mma["spill_loads"]) == (
        64, 24, 16)
    assert (mma["hmma"], mma["hgmma"], mma["instructions"]) == (2, 0, 3)
    assert (parts["registers"], parts["spill_stores"], parts["hmma"]) == (
        127, 0, 0)
    assert parts["instructions"] == 2 and mma["sha"] != parts["sha"]


def test_against_finds_changed_parts_instances(monkeypatch, tmp_path,
                                               capsys):
    """main --against: a parts instance of the other tree counts as
    identical only when its SASS is, both encoding words of every
    instruction (the third case differs in an instruction's second word
    alone); --kernel picks which functions are compared; the summary lists
    the spilling and the tensor-core kernels."""
    for tree in ("ours", "theirs"):
        (tmp_path / tree).mkdir()
        (tmp_path / tree / "k.cu").write_text("")
    monkeypatch.setattr(S, "CSRC", str(tmp_path / "ours"))
    for op, ctrl, changed in (
            ("LDC", "0x000fe40000000800", []),
            ("MOV", "0x000fe40000000800", ["k: _Z12parts_kernelv"]),
            ("LDC", "0x000fc80000000800", ["k: _Z12parts_kernelv"])):
        _fake_tools(monkeypatch, {"ours": _sass("LDC"),
                                  "theirs": _sass(op, ctrl)})
        summary = S.main(["--against", str(tmp_path / "theirs")])
        assert summary["against"] == {"kernel": "parts_kernel",
                                      "compared": 1,
                                      "identical": 1 - len(changed),
                                      "changed": changed}
        assert summary["spilling"] == ["_Z4mmaf"]
        assert summary["with_hmma"] == ["_Z4mmaf"]
    assert "_Z4mmaf: 64 regs, spill 24/16 B" in capsys.readouterr().out
    _fake_tools(monkeypatch, {"ours": _sass("LDC"), "theirs": _sass("LDC")})
    summary = S.main(["--against", str(tmp_path / "theirs"),
                      "--kernel", "mmaf"])
    assert summary["against"] == {"kernel": "mmaf", "compared": 1,
                                  "identical": 1, "changed": []}


PTXAS_TMA = """\
ptxas info    : Compiling entry function '_Z5flashv' for 'sm_90a'
ptxas info    : Function properties for _Z5flashv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers, 32 bytes smem
"""

SASS_TMA = """\
\t\tFunction : _Z5flashv
        /*0000*/                   UTMALDG.4D [UR8], [UR4], desc[UR6] ;     /* 0x00000008040075b4 */
                                                              /* 0x0003e20008019000 */
        /*0010*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], RZ, !UPT ;  /* 0x01e00000081879f0 */
                                                              /* 0x000fe2000bf00018 */
        /*0020*/                   HGMMA.64x64x16.F32.BF16 R88, R120, gdesc[UR12].tnspB, R88 ;  /* 0x40e0000c78587df0 */
                                                              /* 0x000fe2000bf00858 */
        /*0030*/                   UTMALDG.4D [UR16], [UR4], desc[UR6] ;     /* 0x00000010040075b4 */
                                                              /* 0x0003e20008019000 */
        /*0040*/                   EXIT ;                     /* 0x000000000000794d */
"""


def test_compile_report_counts_hgmma_tma_loads_and_smem(monkeypatch):
    """A wgmma + TMA kernel: HGMMA (both the shared-memory and the
    register-A form) and UTMALDG are counted, HMMA is 0, and ptxas's
    static shared memory is read."""
    monkeypatch.setattr(S, "nvcc_path", lambda: "fake-cuda/bin/nvcc")

    def run(cmd, input=None, capture_output=True, text=True, check=False):
        tool = cmd[0].rsplit("/", 1)[-1]
        if tool == "nvcc":
            return types.SimpleNamespace(returncode=0, stdout="",
                                         stderr=PTXAS_TMA)
        if tool == "cuobjdump":
            return types.SimpleNamespace(returncode=0, stdout=SASS_TMA)
        return types.SimpleNamespace(returncode=0, stdout=input)

    monkeypatch.setattr(S.subprocess, "run", run)
    (rec,) = S.compile_report("/src", "flash_attention")
    assert (rec["hgmma"], rec["hmma"], rec["utmaldg"]) == (2, 0, 2)
    assert (rec["registers"], rec["smem"], rec["spill_stores"]) == (168, 32, 0)
    assert rec["instructions"] == 5
