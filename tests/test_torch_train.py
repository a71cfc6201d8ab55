"""Training in the torch port against the JAX package, on the CPU:
grad_fn (models/gpt2.py), the AdamW trajectory, train() and the train CLI
(train.py), and the trained-weights int8/bf16 gate of
test_quant_trained.py with the port doing the training.

Tolerances: grads per leaf within rtol 1e-4 / atol 1e-6 of JAX's grad_fn
(wte's first V rows) and within rtol 5e-3 / atol 1e-4 of the golden torch
grads; 10 AdamW steps within 2e-3 of losses_tiny.json and 1e-4 of the
optax trajectory; train()'s losses and val lines within 1e-4 of JAX
train()'s; trained weights: val < 3.2, |int8 - fp32| and |bf16 - fp32|
<= 0.05."""

import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from llmc_paged_tpu import formats as JF
from llmc_paged_tpu.models import gpt2 as JG
from llmc_paged_tpu.train import train as j_train
from llmc_paged_tpu.utils.dataloader import DataLoader as JLoader
from llmc_paged_tpu_torch import formats as TF
from llmc_paged_tpu_torch.config import GPT2Config
from llmc_paged_tpu_torch.convert import params_from_numpy
from llmc_paged_tpu_torch.eval import evaluate
from llmc_paged_tpu_torch.models import gpt2 as TG
from llmc_paged_tpu_torch.ops.int8 import quantize_params
from llmc_paged_tpu_torch.train import train as t_train
from llmc_paged_tpu_torch.utils.dataloader import DataLoader as TLoader
from test_torch_common import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def golden(fixtures_dir):
    cfg, p_np = JF.read_checkpoint(os.path.join(fixtures_dir,
                                                "model_tiny.bin"))
    state = JF.read_debug_state(os.path.join(fixtures_dir, "state_tiny.bin"),
                                cfg)
    with open(os.path.join(fixtures_dir, "losses_tiny.json")) as f:
        meta = json.load(f)
    cfg_t, _ = TG.load_params(os.path.join(fixtures_dir, "model_tiny.bin"))
    return cfg, cfg_t, p_np, state, meta


@pytest.mark.parametrize("ref", ["jax", "golden"])
def test_grad_fn_matches(golden, ref):
    """grad_fn's (loss, grads) against JAX's grad_fn (rtol 1e-4, atol
    1e-6; JAX's padded wte rows carry zero grad and are cut) or the golden
    torch grads (rtol 5e-3, atol 1e-4, test_grads_match_torch's)."""
    cfg, cfg_t, p_np, state, _ = golden
    params = params_from_numpy(p_np, cfg_t, device="cpu")
    loss, grads = TG.grad_fn(params, state["x"], state["y"], cfg_t)
    assert set(grads) == set(params)
    assert all(not p.requires_grad and p.grad is None
               for p in params.values())
    if ref == "jax":
        jl, jg = JG.grad_fn(JG.to_device(p_np, cfg), jnp.asarray(state["x"]),
                            jnp.asarray(state["y"]), cfg)
        want_loss, rtol, atol = float(jl), 1e-4, 1e-6
        want = {k: np.asarray(v)[: cfg.vocab_size] if k == "wte"
                else np.asarray(v) for k, v in jg.items()}
        assert abs(float(loss) - want_loss) < 1e-5
    else:
        want, rtol, atol = state["grads"], 5e-3, 1e-4
        assert abs(float(loss) - state["loss"]) < 1e-4
    for name in TF.param_shapes(cfg_t):
        np.testing.assert_allclose(grads[name].numpy(), want[name],
                                   rtol=rtol, atol=atol, err_msg=name)


def test_adamw_trajectory_matches_torch_and_optax(golden):
    """10 AdamW steps (lr 1e-4) on the fixed golden batch through
    train(): within 2e-3 of losses_tiny.json a step
    (test_adamw_loss_trajectory_matches_torch) and within 1e-4 of the
    JAX package's optax trajectory."""
    cfg, cfg_t, p_np, state, meta = golden
    params = JG.to_device(p_np, cfg)
    tx = optax.adamw(1e-4, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0)
    opt_state = tx.init(params)
    x, y = jnp.asarray(state["x"]), jnp.asarray(state["y"])
    want = []
    for _ in meta["losses"]:
        loss, grads = JG.grad_fn(params, x, y, cfg)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        want.append(float(loss))

    class FixedBatch:                       # the golden (x, y) every step
        def next_batch(self):
            return state["x"], state["y"]

    start = params_from_numpy(p_np, cfg_t, device="cpu")
    trained, got = t_train(cfg_t, start, FixedBatch(),
                           steps=len(meta["losses"]), sample_every=0,
                           log=lambda *_: None)
    for i, (g, w, t) in enumerate(zip(got, want, meta["losses"])):
        assert abs(g - t) < 2e-3, (i, g, t)
        assert abs(g - w) < 1e-4, (i, g, w)
    # train() leaves the caller's params as they were
    for k, v in start.items():
        np.testing.assert_array_equal(v.numpy(), p_np[k], err_msg=k)
    assert not torch.equal(trained["qkvw"], start["qkvw"])


def test_train_matches_jax_train(golden, fixtures_dir):
    """train() on the stream loader, with val and sample cadence and
    weight decay: the val loss falls, and the train losses and val lines equal
    JAX train()'s within 1e-4; the samples are the same tokens."""
    cfg, cfg_t, p_np, _, _ = golden
    path = os.path.join(fixtures_dir, "tokens_tiny.bin")
    kw = dict(steps=8, lr=1e-3, weight_decay=0.1, val_every=3,
              val_batches=2, sample_every=5, sample_tokens=6, seed=11)
    logs = {"jax": [], "port": []}
    _, jl = j_train(cfg, JG.to_device(p_np, cfg), JLoader(path, 4, 16),
                    JLoader(path, 4, 16), log=logs["jax"].append, **kw)
    _, tl = t_train(cfg_t, params_from_numpy(p_np, cfg_t, device="cpu"),
                    TLoader(path, 4, 16), TLoader(path, 4, 16),
                    log=logs["port"].append, **kw)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    num = re.compile(r"\d+\.\d+")
    val = [float(num.findall(s)[0]) for s in logs["port"] if "val loss" in s]
    assert val[-1] < val[0], val          # on the fixed val batches
    for which in ("val loss", "sample"):
        lines = {k: [s for s in v if which in s] for k, v in logs.items()}
        assert len(lines["port"]) == len(lines["jax"]) \
            == (3 if which == "val loss" else 1)
        for a, b in zip(lines["port"], lines["jax"]):
            if which == "sample":
                assert a == b
                continue
            assert num.sub("#", a) == num.sub("#", b)
            assert abs(float(num.findall(a)[0])
                       - float(num.findall(b)[0])) < 1e-4, (a, b)
    for s in logs["port"]:
        if "train loss" in s:
            assert re.fullmatch(r"step \d+: train loss \d+\.\d{6} "
                                r"\(took \d+\.\d\d ms\)", s), s


def test_train_cli_scratch_and_save(tmp_path, fixtures_dir):
    """From-scratch training through ``python -m
    llmc_paged_tpu_torch.train`` (LLMC_PLATFORM=cpu), saving a
    reference-format checkpoint that round-trips through both packages'
    readers, then the eval CLI on it."""
    env = {**os.environ, "LLMC_PLATFORM": "cpu", "PYTHONPATH": ROOT}
    save = str(tmp_path / "trained.bin")
    data = os.path.join(fixtures_dir, "tokens_tiny.bin")
    out = subprocess.run(
        [sys.executable, "-m", "llmc_paged_tpu_torch.train",
         "--train-data", data, "--val-data", data,
         "--steps", "3", "--batch", "2", "--seq-len", "16",
         "--layers", "2", "--heads", "2", "--channels", "32",
         "--vocab", "256", "--max-seq-len", "32",
         "--val-every", "2", "--sample-every", "0", "--save", save],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.count("train loss") == 3
    assert out.stdout.count("val loss") == 2
    assert f"saved {save}" in out.stdout
    cfg2, params2 = TF.read_checkpoint(save)
    assert (cfg2.num_layers, cfg2.num_heads, cfg2.channels,
            cfg2.vocab_size, cfg2.max_seq_len) == (2, 2, 32, 256, 32)
    assert params2["wte"].shape == (256, 32)
    _, params_j = JF.read_checkpoint(save)
    for k in params2:
        np.testing.assert_array_equal(params2[k], params_j[k])
    out = subprocess.run(
        [sys.executable, "-m", "llmc_paged_tpu_torch.eval", "--checkpoint",
         save, "--data", data, "--batch", "2", "--seq-len", "16",
         "--batches", "2"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert re.fullmatch(r"dtype=float32 val loss \d+\.\d{6} ppl \d+\.\d{3}",
                        out.stdout.strip())


# ---- the trained-weights gate (test_quant_trained.py, trained by the port)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """test_quant_trained.py's fixture with the port training: the repo's
    own text through tools/prepro_text.py's byte encoder, the tiny config
    from the JAX PRNGKey(7) init, 300 steps at lr 1e-3, wd 0.1, plus 300
    more while val >= 3.2."""
    tmp = tmp_path_factory.mktemp("trained")
    corpus = tmp / "corpus.txt"
    docs = [os.path.join(ROOT, "SURVEY.md"),
            os.path.join(ROOT, "docs", "layernorm.md")]
    text = "\n\n".join(open(d, encoding="utf-8").read() for d in docs)
    corpus.write_text(text, encoding="utf-8")
    subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "prepro_text.py"),
         str(corpus), "--encoder", "byte", "--val-tokens", "8192",
         "--out-prefix", str(tmp / "docs")],
        check=True, cwd=ROOT, capture_output=True)
    B, T = 8, 128
    train_loader = TLoader(str(tmp / "docs_train.bin"), B, T)
    val_loader = TLoader(str(tmp / "docs_val.bin"), B, T)
    cfg = GPT2Config.tiny(max_seq_len=T, vocab_size=257, num_layers=2,
                          num_heads=4, channels=128)
    init = {k: np.asarray(v) for k, v in
            JG.init_params(cfg, jax.random.PRNGKey(7)).items()}
    params = params_from_numpy(init, cfg, device="cpu")
    loss0 = evaluate(cfg, params, val_loader, batches=4)
    params, losses = t_train(cfg, params, train_loader, steps=300, lr=1e-3,
                             weight_decay=0.1, sample_every=0,
                             log=lambda *_: None)
    if evaluate(cfg, params, val_loader, batches=4) >= 3.2:
        params, more = t_train(cfg, params, train_loader, steps=300,
                               lr=1e-3, weight_decay=0.1, sample_every=0,
                               log=lambda *_: None)
        losses = losses + more
    return cfg, params, val_loader, loss0, losses, str(tmp)


def test_chip_smoke_corpus_is_prepro_text_output(trained):
    """chip_smoke.py phase 15 encodes the same text itself (the card has
    no JAX package for tools/prepro_text.py to import): equal streams."""
    import chip_smoke
    tmp = trained[-1]
    train_toks, val_toks = chip_smoke.docs_corpus(ROOT)
    np.testing.assert_array_equal(
        train_toks, TF.read_token_stream(os.path.join(tmp, "docs_train.bin")))
    np.testing.assert_array_equal(
        val_toks, TF.read_token_stream(os.path.join(tmp, "docs_val.bin")))


def test_training_converged(trained):
    cfg, params, val_loader, loss0, losses, _ = trained
    final = evaluate(cfg, params, val_loader, batches=4)
    assert loss0 > 5.0, loss0
    assert final < 3.2, (loss0, final)
    assert losses[-1] < losses[0] * 0.6


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_val_loss_gate_on_trained_weights(trained, dtype):
    """fp32 against int8 (per-row absmax) or bf16 (layernorms fp32) val
    loss on held-out text: |delta| <= 0.05."""
    cfg, params, val_loader, _, _, _ = trained
    loss_f = evaluate(cfg, params, val_loader, batches=4)
    p = quantize_params(params) if dtype == "int8" else \
        TG.to_device(params, cfg, torch.bfloat16, device="cpu")
    loss_q = evaluate(cfg, p, val_loader, batches=4)
    print(f"trained-weights val loss: fp32 {loss_f:.4f} {dtype} "
          f"{loss_q:.4f} delta {loss_q - loss_f:+.4f}")
    assert abs(loss_q - loss_f) <= 0.05, (loss_f, loss_q)
