"""The torch port stands alone: it imports neither jax nor any module of
the JAX package, imports without a GPU, nvcc or triton, and its entry
points refuse to fall back to the CPU when no card is present."""

import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "llmc_paged_tpu_torch")


def _port_modules():
    import llmc_paged_tpu_torch
    return ["llmc_paged_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(llmc_paged_tpu_torch.__path__,
                                              "llmc_paged_tpu_torch.")]


def test_import_leaves_jax_and_the_jax_package_out():
    """A fresh interpreter (the test process already imported jax)."""
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'llmc_paged_tpu'\n"
        "             or m.startswith('llmc_paged_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_source_names_jax_or_the_jax_package():
    """Static scan of every port source and of chip_smoke.py."""
    pat = re.compile(r"^\s*(import|from)\s+jax\b|llmc_paged_tpu\.|"
                     r"^\s*(import|from)\s+llmc_paged_tpu\b(?!_torch)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh"))]
    assert len(files) > 10
    assert {os.path.join(PKG, "ops", "dev", n) for n in
            ("lab_full_pool.py", "probe_decode.py")} <= set(files)
    assert {os.path.join(PKG, "engine", n) for n in
            ("server.py", "http_server.py")} <= set(files)
    assert {os.path.join(PKG, "ops", "flash_attention.py"),
            os.path.join(PKG, "csrc", "flash_attention.cu")} <= set(files)
    hits = []
    for f in files:
        with open(f) as fh:
            text = fh.read()
        hits += [f"{os.path.relpath(f, ROOT)}: {m.group(0).strip()}"
                 for m in pat.finditer(text)]
    assert not hits, hits


def test_entry_points_default_to_the_card():
    """device=None means the card: without one it raises, never falls
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from llmc_paged_tpu_torch.config import EngineConfig, GPT2Config
    from llmc_paged_tpu_torch.engine.engine import InferenceEngine
    from llmc_paged_tpu_torch.models import gpt2
    cfg = GPT2Config.tiny()
    params = gpt2.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(params, cfg, EngineConfig(greedy=True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gpt2.init_params(cfg, torch.Generator().manual_seed(0))
    # the kernel lab's stacked-pool sweep and helper, and the probe
    from llmc_paged_tpu_torch.ops.dev import lab_full_pool, probe_decode
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lab_full_pool.main(["--iters", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lab_full_pool.pool_from_numpy(*[np.zeros((1, 1, 1, 1, 1))] * 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe_decode.main(["--skip", ",".join(probe_decode.SUITES)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe_decode.gemv_suite(8, cfg)


def test_options_outside_the_slice_raise():
    """Only tensor parallelism (mesh_shape) is outside the port now:
    device sampling, logprobs, penalties and the serving hooks run."""
    import dataclasses

    from llmc_paged_tpu_torch.config import EngineConfig, GPT2Config, \
        PageConfig
    from llmc_paged_tpu_torch.engine.engine import InferenceEngine
    from llmc_paged_tpu_torch.engine.scheduler import Request
    from llmc_paged_tpu_torch.models import gpt2
    cfg = GPT2Config.tiny()
    params = gpt2.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    base = EngineConfig(greedy=True, page=PageConfig(page_size=8,
                                                     pages_per_seq=4))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        InferenceEngine(params, cfg, dataclasses.replace(
            base, mesh_shape={"model": 2}), device="cpu")
    # speculative decode, prefix caching, host and device sampling and
    # the dense and no-cache modes are in the port: they build
    for change in (dict(spec_k=2), dict(spec_k=4, page=dataclasses.replace(
            base.page, prefix_cache=True)), dict(greedy=False),
            dict(device_sampling=True), dict(cache_mode="dense"),
            dict(cache_mode="none")):
        InferenceEngine(params, cfg, dataclasses.replace(base, **change),
                        device="cpu")
    eng = InferenceEngine(params, cfg, base, device="cpu")
    for kw in (dict(logprobs=True), dict(prompt_logprobs=True),
               dict(frequency_penalty=0.5), dict(presence_penalty=0.5)):
        done = eng.run([Request(rid=0, prompt=[1, 2], max_new_tokens=2,
                                **kw)])
        assert len(done[0].generated) == 2
    # a per-request sampling override runs; invalid values are refused
    done = eng.run([Request(rid=0, prompt=[1, 2], max_new_tokens=2,
                            temperature=0.7)])
    assert len(done[0].generated) == 2
    for kw in (dict(temperature=-1.0), dict(top_k=0)):
        with pytest.raises(ValueError):
            eng.run([Request(rid=0, prompt=[1, 2], max_new_tokens=2, **kw)])
    # the serving hooks: on_tokens sees every token, feed admits
    seen = []
    reqs = [Request(rid=0, prompt=[1, 2], max_new_tokens=3)]
    done = eng.run([], on_tokens=lambda r, t: seen.extend(t),
                   feed=lambda block: (reqs and [reqs.pop()], bool(reqs)))
    assert done == [] and len(seen) == 3
