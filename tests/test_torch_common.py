"""Shared inputs for the torch-port tests (no tests of its own).

Both packages get the same numpy inputs, made from a seed; results are
compared as numpy arrays. Sizes are small: GPT2Config.tiny with
channels=128 and 2 heads, so head_dim is 64 as in GPT-2 124M.
"""

import numpy as np
import pytest
import torch

TINY = dict(max_seq_len=128, vocab_size=512, num_layers=2, num_heads=2,
            channels=128)


def jax_cfg(**kw):
    from llmc_paged_tpu.config import GPT2Config
    return GPT2Config.tiny(**{**TINY, **kw})


def port_cfg(**kw):
    from llmc_paged_tpu_torch.config import GPT2Config
    return GPT2Config.tiny(**{**TINY, **kw})


def params_np(cfg, seed=0, std=0.02):
    """GPT-2 parameters as numpy (the stacked layout both packages take).
    Layernorm weights and biases are perturbed from ones/zeros so they
    take part in the comparison."""
    from llmc_paged_tpu_torch.models.gpt2 import param_shapes
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in param_shapes(cfg).items():
        noise = rng.standard_normal(shape).astype(np.float32)
        if name in ("ln1w", "ln2w", "lnfw"):
            out[name] = 1.0 + 0.1 * noise
        elif name.endswith("b"):
            out[name] = 0.02 * noise
        else:
            out[name] = std * noise
    return out


def to_np(t):
    if torch.is_tensor(t):
        return t.detach().cpu().float().numpy() if t.dtype == torch.bfloat16 \
            else t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float32) if str(t.dtype) == "bfloat16" \
        else np.asarray(t)


@pytest.fixture
def cuda():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernel-vs-plain runs on the card)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def one_thread():
    """One intra-op thread for a module's tiny CPU runs. The serving tests
    run the engine on a background thread beside HTTP threads; under a
    parallel test run, torch's default thread pool (one thread a core in
    every worker) oversubscribes the CPU and slows them a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

