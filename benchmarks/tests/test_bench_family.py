"""A model family is found by the config file's ``model_type``
(``families/<model_type>.py``), and GPT-2's family gives the harness the
very numbers GPT-2's formulas and reference give: the FLOPs of every
delivery, the comparison's readings and the kernels' bounds. A family of
the tests' own (``toy/``) runs a cell with no harness file edited."""

import json
import os

import pytest
import torch

import tinybench
from benchmarks import harness, roofline
from benchmarks.reference import full_f32, gpt2_ref
from benchmarks.registry import HERE, Registry
from test_bench_trace import _trace

TOY = os.path.join(HERE, "tests", "toy")
GPT2_FILE = os.path.join(HERE, "families", "gpt2.py")


def _tiny():
    return tinybench.registry().config("tiny-int8")


def _direct_readings(cfg, seed, reqs, score):
    """The widest token gap and prompt logprob error of ``reqs`` against
    ``gpt2_ref.ServedModel`` at the configuration's heads, computed here."""
    fam = Registry().family("gpt2")
    with torch.no_grad(), full_f32():
        ref = gpt2_ref.ServedModel(fam.make_weights(cfg, seed, "cpu"),
                                   cfg["n_head"], gpt2_ref.REFERENCE)
        out = {"token_gap": 0.0}
        if score:
            out["prompt_logprob_err"] = 0.0
        for r in reqs:
            served, rows = ref.logits(r.prompt, r.generated, score)
            picks = torch.tensor(r.generated)
            got = served.gather(1, picks[:, None])[:, 0]
            out["token_gap"] = max(out["token_gap"], float(
                (served.max(dim=-1).values - got).max()))
            if score:
                nxt = torch.tensor(r.prompt[1:])
                lp = torch.log_softmax(rows[:-1].double(), dim=-1).gather(
                    1, nxt[:, None])[:, 0]
                served_lp = torch.tensor(r.prompt_logprob_values,
                                         dtype=torch.float64)
                out["prompt_logprob_err"] = max(
                    out["prompt_logprob_err"],
                    float((served_lp - lp).abs().max()))
    return out


@pytest.mark.parametrize("workload", ["tiny.chat", "tiny.score"])
def test_the_tiny_cells_read_gpt2s_flops_and_reference(workload,
                                                      monkeypatch):
    cfg = _tiny()
    L, C, V = cfg["n_layer"], cfg["n_embd"], cfg["vocab_size"]
    seed = 2147483671
    # every call's FLOPs, as its delivery took them
    calls = []
    on_tokens = harness.Loop.on_tokens

    def counted(self, req, toks):
        k0 = self.sent.get(req.rid, 0)
        kind = "first" if k0 == 0 else "decode"
        d0 = self.last.get(kind)
        f0 = d0[4] if d0 is not None else None
        on_tokens(self, req, toks)
        d1 = self.last[kind]
        calls.append((len(req.prompt), k0, len(toks), self.score,
                      d1[4] - f0 if d1 is d0 else d1[4]))
    monkeypatch.setattr(harness.Loop, "on_tokens", counted)
    out = tinybench.run(workload, seed=seed)
    assert out["result"]["correct"] is True
    assert calls
    for n, k0, k, score, got in calls:
        want = sum(roofline.prefill_flops(L, C, V, n, n if score else 1)
                   if j == 0 else roofline.decode_flops(L, C, V, n + j)
                   for j in range(k0, k0 + k))
        assert got == want
    assert sum(d[4] for d in out["record"]["deliveries"]) == \
        sum(c[4] for c in calls)
    score = workload == "tiny.score"
    assert out["readings"] == {"program": _direct_readings(
        cfg, seed, out["sample"], score)}


class _Profile:
    def __init__(self, trace):
        self.trace = trace

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump(self.trace, f)


class _Spans:
    # what the harness's spans recorded for the synthetic trace's two
    # ranges, bench.chunk#0 and bench.prefill#1
    records = [{"kind": "chunk", "idx": 0, "B": 3, "steps": 4,
                "lengths": [130, 5]},
               {"kind": "prefill", "idx": 1, "B": 2, "T": 208,
                "lengths": [200, 100], "all_rows": False}]


def test_the_tiny_kernels_bounds_are_gpt2s():
    cfg = _tiny()
    NH = cfg["n_head"]
    HS = cfg["n_embd"] // NH
    ps = cfg["serving"]["page_size"]
    kernels = tinybench.registry().family_of(cfg).kernels(cfg)
    got = harness.trace_summary(_Profile(_trace()), _Spans(), kernels)
    chunk, prefill = _Spans.records
    assert got["parts"] == {
        "calls": 2, "expected": cfg["n_layer"] * 4,
        "bound_s": 2 * roofline.parts_call_bound_s(chunk["lengths"], 3, NH,
                                                   HS, ps),
        "time_s": 50e-6}
    assert got["flash"] == {
        "calls": 1, "expected": cfg["n_layer"],
        "bound_s": roofline.flash_call_bound_s(prefill["lengths"], NH, HS),
        "time_s": 50e-6}


def test_a_family_of_new_files_runs_a_cell():
    reg = tinybench.registry(TOY)
    cfg = reg.config("toy-int8")
    assert cfg["model_type"] == "toy" and "n_embd" not in cfg
    assert reg.family_of(cfg).__file__ == os.path.join(TOY, "families",
                                                       "toy.py")
    bench = tinybench.bench()
    for w in bench["workloads"]:
        if w["name"] == "tiny.chat":
            w["config"] = "toy-int8"
    out = harness.run_cell(bench, "tiny.chat", 2147483677, 0.6, False,
                           device="cpu", registry=reg)
    res = out["result"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["metrics"]["output_tok_per_s"]["value"] > 0


def test_an_unknown_model_type_raises_naming_its_file(tmp_path):
    (tmp_path / "configs").mkdir()
    cfg = dict(_tiny(), model_type="no_such_family")
    (tmp_path / "configs" / "tiny-int8.json").write_text(json.dumps(cfg))
    with pytest.raises(FileNotFoundError,
                       match="families/no_such_family.py"):
        tinybench.run("tiny.chat", registry=tinybench.registry(
            str(tmp_path)))


def test_a_config_without_model_type_is_gpt2s():
    reg = tinybench.registry()
    cfg = _tiny()
    assert "model_type" not in cfg
    assert reg.family_of(cfg).__file__ == GPT2_FILE
    assert reg.family_of(reg.config("gpt2-small-int8")).__file__ == GPT2_FILE
