"""engine/cli.py of the port against the JAX package's CLI on a tiny
checkpoint written to tmp_path (LLMC_PLATFORM=cpu; JAX with --no-kernel):
the --json tokens are equal for sampled and greedy batches at page sizes
32 (the default) and 8, the three --mode values, and a sliding window.
One subprocess run shows that ``python -m llmc_paged_tpu_torch.engine.cli``
works; --serve, --warmup, --max-pending, --device-sampling and --profile
run, and --mesh-model 2 outside torchrun exits naming the torchrun
command (tests/test_torch_mp_dryrun.py runs it under torchrun)."""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from llmc_paged_tpu.engine import cli as JC
from llmc_paged_tpu_torch import formats as TF
from llmc_paged_tpu_torch.engine import cli as TC
from llmc_paged_tpu_torch.tokenizer import byte_fallback_table
from test_torch_common import one_thread  # noqa: F401
from test_torch_common import params_np, port_cfg

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A tiny checkpoint, token stream and tokenizer, written by the
    port's formats."""
    d = tmp_path_factory.mktemp("cli")
    cfg = port_cfg()
    TF.write_checkpoint(str(d / "model.bin"), cfg, params_np(cfg, seed=0))
    TF.write_token_stream(str(d / "tokens.bin"), np.random.default_rng(0)
                          .integers(0, cfg.vocab_size, 400).astype(np.int32))
    TF.write_tokenizer_bin(str(d / "tok.bin"),
                           byte_fallback_table(cfg.vocab_size))
    return [f"--checkpoint={d / 'model.bin'}", f"--data={d / 'tokens.bin'}",
            f"--tokenizer={d / 'tok.bin'}"]


@pytest.fixture
def cpu_env(monkeypatch):
    monkeypatch.setenv("LLMC_PLATFORM", "cpu")
    monkeypatch.setenv("LLMC_NO_COMPILE_CACHE", "1")


def _json(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


ARGS = {
    "topk-ps32": "--batch 4 --prompt-size 16 --max-new 12 --top-k 40 "
                 "--temperature 0.8 --pages-per-seq 4",
    "parity-ps8": "--batch 4 --prompt-size 16 --max-new 12 --page-size 8 "
                  "--num-pages 40 --pages-per-seq 8",
    "greedy-ps32": "--batch 3 --prompt-size 20 --max-new 12 --greedy "
                   "--pages-per-seq 4",
    "none": "--mode none --max-new 10 --greedy",
    "dense": "--mode dense --max-new 10 --top-k 40",
    "paged-window": "--mode paged --max-new 14 --window 24 --pages-per-seq 4",
}


@pytest.mark.parametrize("case", sorted(ARGS))
def test_cli_json_tokens_equal_jax(files, cpu_env, case):
    argv = files + ["--json"] + ARGS[case].split()
    got = _json(TC.main, argv)
    want = _json(JC.main, argv + ["--no-kernel"])
    assert got["tokens"] == want["tokens"]
    assert got["stats"]["mode"] == want["stats"]["mode"]
    assert got["stats"]["total_new_tokens"] == \
        want["stats"]["total_new_tokens"]
    for k in ("decode_tokens", "preemptions", "peak_pages_used"):
        assert got["stats"].get(k) == want["stats"].get(k), k


def test_cli_module_entry_point(files, cpu_env):
    """``python -m``, once with --json (tokens equal to the in-process
    run) and once printing decoded text."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    argv = files + ARGS["topk-ps32"].split()
    cmd = [sys.executable, "-m", "llmc_paged_tpu_torch.engine.cli"] + argv
    out = subprocess.run(cmd + ["--json"], capture_output=True, text=True,
                         timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    payload = json.loads(out.stdout.strip().splitlines()[-1])
    assert payload["tokens"] == _json(TC.main, argv + ["--json"])["tokens"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "--- sequence 3 (28 tokens) ---" in out.stdout
    assert "generated 48 tokens" in out.stdout


@pytest.mark.parametrize("flag", ["--serve=8000", "--warmup",
                                  "--max-pending=4", "--device-sampling",
                                  "--mesh-model=2", "--profile=trace"])
def test_cli_flags_outside_the_port_exit(files, cpu_env, capsys, tmp_path,
                                         monkeypatch, flag):
    """The flags that once exited for want of their ROADMAP item run as
    in the JAX package's CLI (--serve hands the engine to serve_http with
    the port, --max-pending and --window; --warmup and --max-pending
    without --serve change nothing; --profile writes its trace);
    --mesh-model 2 needs one process a rank, so a plain start exits 2
    naming the torchrun command."""
    from llmc_paged_tpu_torch.engine import http_server
    if flag == "--mesh-model=2":
        monkeypatch.delenv("WORLD_SIZE", raising=False)
        with pytest.raises(SystemExit) as exc:
            TC.main(files + [flag])
        assert exc.value.code == 2
        assert ("torchrun --nproc-per-node 2 -m "
                "llmc_paged_tpu_torch.engine.cli") in capsys.readouterr().err
        return
    served = {}
    monkeypatch.setattr(http_server, "serve_http",
                        lambda engine, **kw: served.update(kw, engine=engine))
    if flag.startswith("--profile"):
        flag = f"--profile={tmp_path / 'trace'}"
    argv = files + ["--batch=2", "--prompt-size=8", "--max-new=6", flag]
    if flag == "--serve=8000":
        assert TC.main(argv + ["--max-pending=3", "--warmup"]) == 0
        assert served["port"] == 8000 and served["max_pending"] == 3
        assert served["window"] is None
        assert served["engine"].device.type == "cpu"
        assert "warmup: {" in capsys.readouterr().out
        return
    out = _json(TC.main, argv + ["--json"])
    assert not served
    assert all(len(t) == 14 for t in out["tokens"].values())
    if flag == "--device-sampling":
        # a sampled batch chains under device sampling
        assert out["stats"]["single_steps"] == 0
        assert out["stats"]["decode_steps"] > 0


def test_cli_profile_writes_a_trace(files, cpu_env, tmp_path):
    """--profile DIR writes a Chrome trace of the run with the engine's
    CPU activity in it, and stops the trace when the run fails."""
    d = tmp_path / "prof"
    _json(TC.main, files + ["--batch=2", "--prompt-size=8", "--max-new=6",
                            "--greedy", f"--profile={d}", "--json"])
    trace = json.loads((d / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("aten::" in n for n in names)
    # a failing run (a window larger than the model's context) still
    # leaves its trace behind
    d2 = tmp_path / "prof_fail"
    with pytest.raises(ValueError, match="window"):
        TC.main(files + ["--batch=2", "--prompt-size=8", "--max-new=6",
                         "--window=100000", f"--profile={d2}"])
    assert json.loads((d2 / "trace.json").read_text())["traceEvents"]


def test_cli_device_sampling_chains_equal_greedy_at_top1(files, cpu_env):
    """--device-sampling --top-k 1 gives the greedy streams of the JAX
    CLI, through the chained path."""
    argv = files + ["--batch=3", "--prompt-size=12", "--max-new=10",
                    "--pages-per-seq=4", "--json"]
    got = _json(TC.main, argv + ["--device-sampling", "--top-k=1"])
    want = _json(JC.main, argv + ["--greedy", "--no-kernel"])
    assert got["tokens"] == want["tokens"]
    assert got["stats"]["single_steps"] == 0


def test_cli_platform(files, monkeypatch):
    monkeypatch.setenv("LLMC_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="LLMC_PLATFORM"):
        TC.main(files)
    monkeypatch.delenv("LLMC_PLATFORM")
    assert TC.platform_device() is None          # the card
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TC.main(files)
