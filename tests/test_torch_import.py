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
    assert {"llmc_paged_tpu_torch.eval", "llmc_paged_tpu_torch.train",
            "llmc_paged_tpu_torch.utils.dataloader",
            "llmc_paged_tpu_torch.kv.native",
            "llmc_paged_tpu_torch.ops.dev.dump_chunk_trace",
            "llmc_paged_tpu_torch.parallel",
            "llmc_paged_tpu_torch.parallel.sharding",
            "llmc_paged_tpu_torch.parallel.mp_dryrun",
            "llmc_paged_tpu_torch.ops.dev.serving_runs",
            "llmc_paged_tpu_torch.ops.dev.probe_longctx",
            "llmc_paged_tpu_torch.ops.dev.probe_longrange"} <= set(
                _port_modules())
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
    """Static scan of every port source (Python, CUDA and host C++) and
    of chip_smoke.py."""
    pat = re.compile(r"^\s*(import|from)\s+jax\b|llmc_paged_tpu\.|"
                     r"^\s*(import|from)\s+llmc_paged_tpu\b(?!_torch)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh", ".cpp"))]
    assert len(files) > 10
    assert {os.path.join(PKG, "ops", "dev", n) for n in
            ("lab_full_pool.py", "probe_decode.py")} <= set(files)
    assert {os.path.join(PKG, "engine", n) for n in
            ("server.py", "http_server.py")} <= set(files)
    assert {os.path.join(PKG, "ops", "flash_attention.py"),
            os.path.join(PKG, "csrc", "flash_attention.cu")} <= set(files)
    assert {os.path.join(PKG, "eval.py"), os.path.join(PKG, "train.py"),
            os.path.join(PKG, "utils", "dataloader.py")} <= set(files)
    assert {os.path.join(PKG, "kv", "native.py"),
            os.path.join(PKG, "ops", "dev", "dump_chunk_trace.py"),
            os.path.join(PKG, "csrc", "block_manager.cpp")} <= set(files)
    assert {os.path.join(PKG, "parallel", n) for n in
            ("__init__.py", "sharding.py", "mp_dryrun.py")} <= set(files)
    assert {os.path.join(PKG, "ops", "dev", n) for n in
            ("serving_runs.py", "probe_longctx.py",
             "probe_longrange.py")} <= set(files)
    hits = []
    for f in files:
        with open(f) as fh:
            text = fh.read()
        hits += [f"{os.path.relpath(f, ROOT)}: {m.group(0).strip()}"
                 for m in pat.finditer(text)]
    assert not hits, hits


def test_entry_points_default_to_the_card(fixtures_dir, monkeypatch):
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
    # the long-context probes
    from llmc_paged_tpu_torch.ops.dev import probe_longctx, probe_longrange
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe_longctx.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe_longrange.main([])
    # training from scratch and its CLI
    from llmc_paged_tpu_torch import train
    monkeypatch.delenv("LLMC_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--train-data", os.path.join(fixtures_dir,
                                                 "tokens_tiny.bin"),
                    "--steps", "1", "--layers", "1", "--channels", "32",
                    "--vocab", "256", "--max-seq-len", "16"])


@pytest.mark.parametrize("module", ["eval", "train"])
def test_eval_and_train_clis_default_to_the_card(fixtures_dir, module):
    """``python -m`` the two entry points with LLMC_PLATFORM unset exits
    non-zero with the no-CUDA message when there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    data = os.path.join(fixtures_dir, "tokens_tiny.bin")
    argv = (["--checkpoint", os.path.join(fixtures_dir, "model_tiny.bin"),
             "--data", data] if module == "eval" else
            ["--train-data", data, "--steps", "1"])
    env = {k: v for k, v in os.environ.items() if k != "LLMC_PLATFORM"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-m",
                           f"llmc_paged_tpu_torch.{module}"] + argv,
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr, proc.stderr[-2000:]


@pytest.fixture
def one_rank(tmp_path):
    """A torch.distributed group of this process alone (gloo, a file
    rendezvous), destroyed after the test."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def _parallel_message(where, capsys, request):
    """The error of a parallel option outside a process group of its size:
    the engine (mesh_shape), the serving CLI (--mesh-model), train()
    (data_parallel), the train CLI (--data-parallel). For "serving", the
    serving front over a tensor-parallel engine built in a group of one
    rank: None, after checking that it serves a request equal to that
    engine's run()."""
    import dataclasses

    from llmc_paged_tpu_torch import train
    from llmc_paged_tpu_torch.config import EngineConfig, GPT2Config, \
        PageConfig
    from llmc_paged_tpu_torch.engine import cli
    from llmc_paged_tpu_torch.engine.engine import InferenceEngine
    from llmc_paged_tpu_torch.engine.scheduler import Request
    from llmc_paged_tpu_torch.engine.server import ServingEngine
    from llmc_paged_tpu_torch.models import gpt2
    cfg = GPT2Config.tiny()
    params = gpt2.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    if where in ("cli", "train_cli"):
        main, argv = ((cli.main, ["--checkpoint", "x", "--data", "x",
                                  "--mesh-model", "2"]) if where == "cli"
                      else (train.main, ["--train-data", "x",
                                         "--data-parallel", "2"]))
        with pytest.raises(SystemExit) as exc:
            main(argv)
        assert exc.value.code == 2
        return capsys.readouterr().err.strip().splitlines()[-1]

    def engine(model):
        return InferenceEngine(params, cfg, dataclasses.replace(
            EngineConfig(greedy=True, page=PageConfig(page_size=8,
                                                      pages_per_seq=4)),
            mesh_shape={"model": model}), device="cpu")

    if where == "serving":
        request.getfixturevalue("one_rank")
        eng = engine(1)
        prompt = [3, 1, 4, 1, 5]
        want = eng.run([Request(rid=0, prompt=prompt, max_new_tokens=6)])
        with ServingEngine(eng) as srv:
            assert srv.is_leader
            got = srv.submit(prompt, 6).result(timeout=120)
            stats = srv.stats()
        assert got == want[0].tokens and len(got) == len(prompt) + 6
        assert stats["broadcasts"] >= 2 and stats["finished_total"] == 1
        return None
    with pytest.raises(RuntimeError) as exc:
        if where == "engine":
            engine(2)
        else:
            train.train(cfg, params, None, data_parallel=2)
    return str(exc.value)


@pytest.mark.parametrize("where", ["engine", "cli", "train", "train_cli",
                                   "serving"])
def test_not_ported_messages_name_a_roadmap_item(capsys, request, where):
    """Tensor and data parallelism outside a process group of the right
    size: each error names torchrun, and the two Python entry points also
    init_distributed. Every parallel option is in the port: the serving
    front over a TP engine serves (no "not ported" error is left, and
    the package has no helper for one)."""
    import llmc_paged_tpu_torch
    msg = _parallel_message(where, capsys, request)
    if where == "serving":
        assert msg is None
        assert not hasattr(llmc_paged_tpu_torch, "not_ported")
        return
    assert "torchrun --nproc-per-node 2" in msg, msg
    if where in ("engine", "train"):
        assert "init_distributed" in msg, msg


def test_options_outside_the_slice_raise(one_rank):
    """Every engine option is in the port: a mesh_shape engine builds and
    serves inside a group of one rank (refusing, as the JAX package does
    under TP, logprobs, penalties and per-request overrides), a mesh
    larger than the group raises; device sampling, logprobs, penalties
    and the serving hooks run."""
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
    with pytest.raises(RuntimeError, match="init_distributed"):
        InferenceEngine(params, cfg, dataclasses.replace(
            base, mesh_shape={"model": 2}), device="cpu")
    tp = InferenceEngine(params, cfg, dataclasses.replace(
        base, mesh_shape={"data": 1, "model": 1}), device="cpu")
    done = tp.run([Request(rid=0, prompt=[1, 2], max_new_tokens=3)])
    assert len(done[0].generated) == 3
    assert set(tp.warmup()) == {"default"}   # no logprobs variant under TP
    for kw, what in ((dict(logprobs=True), "logprobs"),
                     (dict(prompt_logprobs=True), "prompt_logprobs"),
                     (dict(frequency_penalty=0.5), "penalties"),
                     (dict(top_k=3), "per-request sampling overrides")):
        with pytest.raises(ValueError, match=f": {what} under tensor "
                                             "parallelism are not"):
            tp.run([Request(rid=0, prompt=[1, 2], max_new_tokens=2, **kw)])
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
