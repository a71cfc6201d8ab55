"""Mellum's family (``families/mellum.py``) at a tiny size on the CPU
(``tiny_mellum/``: 4 layers, 3 sliding and 1 full, 8 experts top 2,
window 32, pages of 16, served in f32 with int8 KV: in bf16 a model this
small flips an expert choice often enough that its readings overlap the
control's): a cell of it runs through the harness with no
harness file edited, every delivery's FLOPs are the family's formula,
the control fails where the program passes, a planted fault in the timed
path is not correct, and the kernels' bounds and the routing reader read
what they should."""

import os

import pytest
import torch

import tinybench
from benchmarks import check, harness, roofline
from benchmarks.registry import HERE
from llmc_paged_tpu_torch.models import gpt2_paged, mellum, mellum_paged

TINY_MELLUM = os.path.join(HERE, "tests", "tiny_mellum")
WORKLOAD = "tiny.code"
SEED = 2147483693


def _registry():
    return tinybench.registry(TINY_MELLUM)


def _bench():
    b = tinybench.bench()
    b["workloads"].append({"name": WORKLOAD, "config": "tiny-mellum",
                           "traffic": "tiny_code", "chips": 1,
                           "why": "test"})
    return b


def _run(seed=SEED, **kw):
    return harness.run_cell(_bench(), WORKLOAD, seed, 0.6,
                            kw.pop("trace", False), device="cpu",
                            registry=_registry(), **kw)


def _cfg():
    return _registry().config("tiny-mellum")


def _family():
    return _registry().family_of(_cfg())


def test_the_cell_runs_and_reads_the_familys_flops(monkeypatch):
    fam, cfg = _family(), _cfg()
    fl = fam.flops(cfg)
    calls = []
    on_tokens = harness.Loop.on_tokens

    def counted(self, req, toks):
        k0 = self.sent.get(req.rid, 0)
        kind = "first" if k0 == 0 else "decode"
        d0 = self.last.get(kind)
        f0 = d0[4] if d0 is not None else None
        on_tokens(self, req, toks)
        d1 = self.last[kind]
        calls.append((len(req.prompt), k0, len(toks),
                      d1[4] - f0 if d1 is d0 else d1[4]))
    monkeypatch.setattr(harness.Loop, "on_tokens", counted)
    out = _run()
    res = out["result"]
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {"output_tok_per_s", "setup_s"}
    assert calls
    for n, k0, k, got in calls:
        want = sum(fl.prefill(n, 1) if j == 0 else fl.decode(n + j)
                   for j in range(k0, k0 + k))
        assert got == pytest.approx(want, rel=1e-12)
    st = out["record"]["stats"]
    assert len(st["moe_routed_tokens"]) == cfg["num_hidden_layers"]
    assert st["kv_window_pages"] == 4 * mellum_paged.ring_pages(32, 16)


def test_the_flop_formula_by_hand():
    cfg = _cfg()
    fl = _family().flops(cfg)
    C, V, L, HD = 64, 512, 4, 16
    lin = 2 * L * ((8 + 4) * HD * C + C * 8 * HD + 8 * C + 2 * 3 * 32 * C)
    # a 40-token prompt: full layers' queries attend t + 1 keys, sliding
    # ones min(t + 1, 32)
    keys = 3 * (32 * 33 / 2 + 8 * 32) + 40 * 41 / 2
    assert fl.prefill(40, 1) == 40 * lin + 4 * keys * 8 * HD + 2 * C * V
    assert fl.decode(50) == lin + 4 * (3 * 32 + 50) * 8 * HD + 2 * C * V
    assert fl.decode(5) == lin + 4 * (4 * 5) * 8 * HD + 2 * C * V


def test_the_control_fails_where_the_program_passes():
    out = _run(control=True)
    limits = _registry().cell(WORKLOAD)["limits"]
    assert check.verdict(out["readings"]["program"], limits)[0]
    ok, compared = check.verdict(out["readings"]["control"], limits)
    assert not ok, compared


def _state_unchanged(mp):
    # a decode link that never commits its K/V
    mp.setattr(gpt2_paged, "commit_layer_kv_quant",
               lambda pool_l, *a, **k: pool_l)


def _window_ignored(mp):
    # sliding layers that attend the whole committed context
    read = mellum_paged.MellumModel.chain_read
    mp.setattr(mellum_paged.MellumModel, "chain_read", staticmethod(
        lambda ctx, tables, pool, i: (read(ctx, tables, pool, i)[0],
                                      ctx.zeros)))


def _token_altered(mp):
    # every decode pick one past the argmax
    orig = gpt2_paged._pick

    def pick(logits, *a, **k):
        return (orig(logits, *a, **k) + 1) % logits.shape[-1]
    mp.setattr(gpt2_paged, "_pick", pick)


def _routing_unnormalized(mp):
    # the top-k weights as the softmax gave them
    def route(y, router, cfg):
        probs = torch.softmax(torch.nn.functional.linear(
            y.float(), router.float()), dim=-1)
        return torch.topk(probs, cfg.top_k, dim=-1)
    mp.setattr(mellum, "route", route)


@pytest.mark.parametrize("fault", [_state_unchanged, _window_ignored,
                                   _token_altered, _routing_unnormalized],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_fault_in_the_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = _run()
    assert out["result"]["correct"] is False, out["result"]["compared"]


def test_the_kernels_bounds():
    cfg = _cfg()
    fam = _family()
    kernels = fam.kernels(cfg)
    per_tok = 2 * (2 * 16 + 8)      # 2 K/V heads of 16 bytes, 2 scales
    # a chain of 2 steps over rows of 40 and 10 committed tokens: full
    # layer 40 + 10 a step, sliding min(n, 31 - j)
    chunk = {"kind": "chunk", "B": 4, "steps": 2, "lengths": [40, 10]}
    toks = sum(n + 3 * min(n, 31 - j) for n in (40, 10) for j in range(2))
    _, bound, expected = kernels["parts"]
    assert expected(chunk) == 8
    assert bound(chunk) * 8 == pytest.approx(
        toks * per_tok / roofline.PEAK_HBM_BYTES)
    _, mbound, mexpected = kernels["moe"]
    assert mexpected(chunk) == 2 * 4 * 2
    assert mbound(chunk) * 16 == pytest.approx(
        4 * 2 * fam.moe_layer_bound_s(cfg, 2 * 4))
    # a prefill wave of rows 300, 0 (padding) and 20: one group each
    wave = {"kind": "prefill", "B": 4, "T": 304, "lengths": [300, 0, 20, 0]}
    assert mellum_paged.prefill_groups(wave["lengths"], 320) == [[0], [2]]
    assert expected(wave) == 0
    assert mexpected(wave) == 2 * 4 * len(
        mellum_paged.prefill_groups(wave["lengths"]))
    # all experts' weights at the HBM peak bound small batches
    E, C, I = 8, 64, 32
    want = 2 * (E * C * 2 * I + 16 * (C + 2 * I)) / roofline.PEAK_HBM_BYTES \
        + 2 * (E * I * C + 16 * (I + C)) / roofline.PEAK_HBM_BYTES
    assert fam.moe_layer_bound_s(cfg, 16) == pytest.approx(want)


def test_the_prompt_attention_bound():
    """A wave of rows 300, 0 (padding) and 20 is one group padded to 300:
    one causal call on the full layer, ceil(300 / 32) on each of the 3
    sliding ones; the bound is the real rows' attention FLOPs, a sliding
    layer's keys within the window, at the bf16 peak."""
    cfg = _cfg()
    fam = _family()
    _, bound, expected = fam.kernels(cfg)["prompt_attn"]
    wave = {"kind": "prefill", "B": 4, "T": 304, "lengths": [300, 0, 20, 0]}
    assert expected(wave) == 1 + 3 * 10
    keys = sum(n * (n + 1) / 2 for n in (300, 20)) \
        + 3 * (32 * 33 / 2 + (300 - 32) * 32 + 20 * 21 / 2)
    flops = 4 * keys * 8 * 16
    assert bound(wave) * 31 == pytest.approx(flops / roofline.PEAK_BF16_FLOPS)
    chunk = {"kind": "chunk", "B": 4, "steps": 2, "lengths": [40, 10]}
    assert expected(chunk) == 0 and bound(chunk) == 0.0
    roof = _registry().metric("prompt_attn_roofline.code")
    assert roof.compute({"trace": None}) is None
    assert roof.compute({"trace": {"moe": {}}}) is None
    assert roof.compute({"trace": {"prompt_attn": {
        "calls": 31, "time_s": 4.0, "bound_s": 1.0}}}) == 25.0


def test_the_routing_reader():
    metric = _registry().metric("moe_load_max.code")
    rec = {"stats": {"moe_routed_tokens": [[2, 2, 2, 2], [1, 1, 1, 5]]}}
    assert metric.compute(rec) == pytest.approx(2.5)
    assert metric.compute({"stats": {}}) is None
    roof = _registry().metric("moe_roofline.code")
    assert roof.compute({"trace": {"parts": {}}}) is None
    assert roof.compute({"trace": {"moe": {"calls": 4, "time_s": 2.0,
                                           "bound_s": 1.0}}}) == 50.0


def test_the_new_modules_are_scanned_and_the_reference_imports_torch_only():
    """``test_bench_imports.py`` walks every module of the benchmark: the
    family and its reference are among them, and the reference imports
    nothing of the program."""
    import test_bench_imports as imports
    found = set(imports._modules(HERE))
    fam = os.path.join(HERE, "families", "mellum.py")
    ref = os.path.join(HERE, "reference", "mellum_ref.py")
    assert {fam, ref} <= found
    assert set(imports._imports(ref)) <= {"__future__", "contextlib", "math",
                                          "typing", "torch"}
    assert not set(imports._imports(fam)) & imports.FORBIDDEN
