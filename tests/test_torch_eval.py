"""Evaluation in the torch port against the JAX package, on the CPU: the
DataLoader (utils/dataloader.py), loss_fn (models/gpt2.py), evaluate()
and the eval CLI (eval.py), on the golden tiny checkpoint and on the same
seeded numpy weights through both packages.

Tolerances: DataLoader batches equal; loss_fn within 1e-5 of JAX's and
1e-4 of the golden torch loss; evaluate() in fp32 and int8 within 1e-5 of
JAX's; in bf16 within 2e-3 of JAX's bf16 loss (the two bf16 forwards round
different elements: ROADMAP §3) and within 0.05 of fp32 (the north-star
gate)."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_paged_tpu import eval as J_eval
from llmc_paged_tpu import formats as JF
from llmc_paged_tpu.models import gpt2 as JG
from llmc_paged_tpu.ops.int8 import quantize_params as j_quantize
from llmc_paged_tpu.utils.dataloader import DataLoader as JLoader
from llmc_paged_tpu_torch import eval as T_eval
from llmc_paged_tpu_torch.convert import params_from_numpy
from llmc_paged_tpu_torch.models import gpt2 as TG
from llmc_paged_tpu_torch.ops.int8 import quantize_params as t_quantize
from llmc_paged_tpu_torch.utils.dataloader import DataLoader as TLoader
from test_torch_common import jax_cfg, one_thread  # noqa: F401
from test_torch_common import params_np, port_cfg

pytestmark = pytest.mark.usefixtures("one_thread")

BF16_TOL = 2e-3


@pytest.fixture(scope="module")
def golden(fixtures_dir):
    path = os.path.join(fixtures_dir, "model_tiny.bin")
    cfg_j, p_np = JF.read_checkpoint(path)
    cfg_t, p_t = TG.load_params(path)
    state = JF.read_debug_state(os.path.join(fixtures_dir, "state_tiny.bin"),
                                cfg_j)
    return cfg_j, p_np, cfg_t, p_t, state


@pytest.mark.parametrize("B,T", [(2, 8), (4, 32), (3, 7)])
def test_dataloader_matches_the_jax_loader(fixtures_dir, B, T):
    """Batch for batch equal to the JAX loader, through the wraparound
    (train_gpt2.c:1020) and after reset(); the first batches are the
    stream's (B*T)-strided windows."""
    path = os.path.join(fixtures_dir, "tokens_tiny.bin")
    stream = JF.read_token_stream(path)
    jl, tl = JLoader(path, B, T), TLoader(path, B, T)
    assert tl.num_batches == jl.num_batches
    for i in range(jl.num_batches + 2):
        (xj, yj), (xt, yt) = jl.next_batch(), tl.next_batch()
        assert xt.dtype == np.int32 and xt.shape == (B, T)
        np.testing.assert_array_equal(xt, xj, err_msg=str(i))
        np.testing.assert_array_equal(yt, yj, err_msg=str(i))
        if i < 2:
            n = B * T
            np.testing.assert_array_equal(xt.ravel(), stream[i * n:(i + 1) * n])
            np.testing.assert_array_equal(yt.ravel(),
                                          stream[i * n + 1:(i + 1) * n + 1])
    tl.reset()
    np.testing.assert_array_equal(tl.next_batch()[0].ravel(), stream[:B * T])
    with pytest.raises(ValueError, match="too small"):
        TLoader(path, len(stream), 1)


def test_load_params_is_the_checkpoint(golden):
    cfg_j, p_np, cfg_t, p_t, _ = golden
    assert cfg_t.num_layers == cfg_j.num_layers
    assert cfg_t.vocab_size == cfg_j.vocab_size
    assert set(p_t) == set(p_np)
    for k in p_np:
        np.testing.assert_array_equal(p_t[k], p_np[k], err_msg=k)


def test_loss_fn_matches_jax_and_the_golden_loss(golden):
    cfg_j, p_np, cfg_t, _, state = golden
    want = float(JG.loss_fn(JG.to_device(p_np, cfg_j), jnp.asarray(state["x"]),
                            jnp.asarray(state["y"]), cfg_j))
    params = params_from_numpy(p_np, cfg_t, device="cpu")
    got = TG.loss_fn(params, torch.from_numpy(state["x"]),
                     torch.from_numpy(state["y"]), cfg_t)
    assert got.dim() == 0 and got.requires_grad is False
    assert abs(float(got) - want) < 1e-5, (float(got), want)
    assert abs(float(got) - state["loss"]) < 1e-4, (float(got), state["loss"])
    # numpy inputs, and forward() is loss_fn's forward without autograd
    assert float(TG.loss_fn(params, state["x"], state["y"], cfg_t)) \
        == float(got)
    logits = TG.forward({k: v.detach().requires_grad_(True)
                         for k, v in params.items()}, state["x"], cfg_t)
    assert not logits.requires_grad


def _evals(cfg_j, cfg_t, p_np, path, B, T, batches):
    """evaluate() of both packages in the three dtypes on one stream."""
    pj = JG.to_device(p_np, cfg_j)
    jax_params = {"float32": pj, "int8": j_quantize(pj),
                  "bfloat16": JG.to_device(p_np, cfg_j, jnp.bfloat16)}
    pt = TG.to_device(p_np, cfg_t, device="cpu")
    port_params = {"float32": pt, "int8": t_quantize(pt),
                   "bfloat16": TG.to_device(p_np, cfg_t, torch.bfloat16,
                                            device="cpu")}
    return ({dt: J_eval.evaluate(cfg_j, p, JLoader(path, B, T), batches)
             for dt, p in jax_params.items()},
            {dt: T_eval.evaluate(cfg_t, p, TLoader(path, B, T), batches)
             for dt, p in port_params.items()})


@pytest.fixture(scope="module")
def golden_evals(golden, fixtures_dir):
    """Both packages' evaluate() of the golden checkpoint on the stream,
    B=2, T=16, 3 batches (the eval CLI test's arguments)."""
    cfg_j, p_np, cfg_t, _, _ = golden
    return _evals(cfg_j, cfg_t, p_np,
                  os.path.join(fixtures_dir, "tokens_tiny.bin"), 2, 16, 3)


@pytest.mark.parametrize("weights", ["golden", "seeded"])
def test_evaluate_matches_jax_in_three_dtypes(golden_evals, fixtures_dir,
                                              weights):
    """fp32 and int8 (per-row absmax, the JAX quantization) within 1e-5 of
    JAX's evaluate(); bf16 within BF16_TOL of JAX's and 0.05 of fp32."""
    if weights == "golden":
        want, got = golden_evals
    else:
        want, got = _evals(jax_cfg(), port_cfg(), params_np(port_cfg(),
                                                            seed=5),
                           os.path.join(fixtures_dir, "tokens_tiny.bin"),
                           2, 16, 3)
    for dt in ("float32", "int8"):
        assert abs(got[dt] - want[dt]) < 1e-5, (dt, got, want)
    assert abs(got["bfloat16"] - want["bfloat16"]) < BF16_TOL, (got, want)
    for dt in ("bfloat16", "int8"):
        assert abs(got[dt] - got["float32"]) < 0.05, (dt, got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_eval_cli_dtype_gate(golden_evals, fixtures_dir, monkeypatch,
                             capsys, dtype):
    """The eval entry point (in process, LLMC_PLATFORM=cpu) prints the
    JAX CLI's line; its loss is evaluate()'s, and bf16 and int8 sit
    within the 0.05 gate of fp32 (test_train.py::test_eval_cli_dtype_gate
    on the port)."""
    monkeypatch.setenv("LLMC_PLATFORM", "cpu")
    ckpt = os.path.join(fixtures_dir, "model_tiny.bin")
    data = os.path.join(fixtures_dir, "tokens_tiny.bin")
    losses = {}
    for dt in ("float32", dtype):
        assert T_eval.main(["--checkpoint", ckpt, "--data", data, "--dtype",
                            dt, "--batch", "2", "--seq-len", "16",
                            "--batches", "3"]) == 0
        line = capsys.readouterr().out.strip().splitlines()[-1]
        m = re.fullmatch(rf"dtype={dt} val loss (\d+\.\d{{6}}) ppl "
                         rf"(\d+\.\d{{3}})", line)
        assert m, line
        losses[dt] = float(m.group(1))
        assert abs(float(m.group(2)) - np.exp(losses[dt])) < 2e-3
    want, _ = golden_evals
    tol = BF16_TOL if dtype == "bfloat16" else 1e-5
    assert abs(losses[dtype] - want[dtype]) < tol, (losses, want)
    assert abs(losses[dtype] - losses["float32"]) < 0.05, losses
