"""The comparison that decides ``correct`` fails what it must fail: the
control (the reference one precision below the configuration's) and the
faults a served cell can have, each planted under a run that otherwise
goes as on the card. At the tiny configuration on the CPU, with the tiny
cells' limits."""

import pytest
import torch

import tinybench
from benchmarks import check
from llmc_paged_tpu_torch.engine import engine as engine_mod
from llmc_paged_tpu_torch.models import gpt2_paged


@pytest.mark.parametrize("workload", ["tiny.chat", "tiny.score"])
def test_the_control_fails_where_the_program_passes(workload):
    out = tinybench.run(workload, control=True)
    limits = tinybench.registry().cell(workload)["limits"]
    ok, _ = check.verdict(out["readings"]["program"], limits)
    assert ok
    ok, compared = check.verdict(out["readings"]["control"], limits)
    assert not ok, compared


def _state_unchanged(mp):
    # a decode chunk that never commits its K/V: the pool keeps its state
    mp.setattr(gpt2_paged, "commit_layer_kv_quant",
               lambda pool_l, *a, **k: pool_l)


def _half_the_batch(mp):
    # a wave that computes only its first half of rows: the second half
    # is handed the first half's prompts, so its logits, logprobs and K/V
    # are another row's
    orig = gpt2_paged.prefill_paged

    def prefill(params, tokens, page, slot, pool, cfg, **kw):
        tokens = tokens.clone()
        h = tokens.shape[0] // 2
        tokens[h:2 * h] = tokens[:h]
        return orig(params, tokens, page, slot, pool, cfg, **kw)
    mp.setattr(gpt2_paged, "prefill_paged", prefill)


def _token_altered(mp):
    # every decode pick one past the argmax
    orig = gpt2_paged._pick

    def pick(logits, *a, **k):
        return (orig(logits, *a, **k) + 1) % logits.shape[-1]
    mp.setattr(gpt2_paged, "_pick", pick)


def _answer_altered(mp):
    # the prompt logprobs off by 0.1 where they are produced
    orig = engine_mod._prefill_plp_extract

    def extract(*a, **k):
        last, lp = orig(*a, **k)
        return last, lp + 0.1
    mp.setattr(engine_mod, "_prefill_plp_extract", extract)


# a single-card cell has no exchange between chips to leave out
FAULTS = [("tiny.chat", _state_unchanged), ("tiny.chat", _half_the_batch),
          ("tiny.chat", _token_altered), ("tiny.score", _half_the_batch),
          ("tiny.score", _answer_altered)]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f.__name__}" for w, f in FAULTS])
def test_a_fault_in_the_timed_path_is_not_correct(workload, fault,
                                                  monkeypatch):
    fault(monkeypatch)
    out = tinybench.run(workload)
    assert out["result"]["correct"] is False, out["result"]["compared"]


def test_the_reference_is_the_served_model_in_f32():
    from benchmarks.reference import gpt2_ref
    w = torch.tensor([[0.5, -0.25, 0.126, 0.0], [0.0, 0.0, 0.0, 0.0]])
    q = gpt2_ref.quant_rows(w, "int8")
    # scale 0.5/127 through bf16; the zero row keeps scale 1 and stays 0
    s = torch.tensor(0.5 / 127).bfloat16().float()
    assert torch.equal(q[0], torch.clamp(torch.round(w[0] / s), -127, 127)
                       * s)
    assert torch.equal(q[1], w[1])
    assert gpt2_ref.quant_rows(w, "int4")[0, 0] == pytest.approx(0.5, 1e-2)
