"""The port's multi-process path on the CPU (llmc_paged_tpu_torch/parallel/
mp_dryrun.py, train.py's data parallelism, the CLIs under torchrun), the
counterparts of the JAX package's mp_dryrun and train(data_parallel=N).

Two gloo rank processes (one module-scoped RankPool) run
train(data_parallel=2) against JAX's train(data_parallel=2) on the
virtual CPU devices (losses and val lines within 1e-4, as
test_torch_train.py holds the one-device loop); the dry run's parent
with 2 ranks prints its sentinels; a rank that fails after joining the
group raises MpChildFailure; ``--mesh-model 2`` and ``--data-parallel
2`` under torchrun (LLMC_PLATFORM=cpu) print what one process prints,
``--profile`` writing one trace a rank; ``--serve PORT --mesh-model 2``
under torchrun answers HTTP requests with the in-process CLI's tokens
and stops on SIGINT.
"""

import collections
import contextlib
import io
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from llmc_paged_tpu import formats as JF
from llmc_paged_tpu.models import gpt2 as JG
from llmc_paged_tpu.train import train as j_train
from llmc_paged_tpu.utils.dataloader import DataLoader as JLoader
from llmc_paged_tpu_torch import formats as TF
from llmc_paged_tpu_torch import train as t_train_mod
from llmc_paged_tpu_torch.engine import cli as TC
from llmc_paged_tpu_torch.models import gpt2 as TG
from llmc_paged_tpu_torch.ops.dev import dump_chunk_trace as DT
from llmc_paged_tpu_torch.parallel import mp_dryrun
from llmc_paged_tpu_torch.parallel.mp_dryrun import (
    MpChildFailure,
    RankPool,
    http_post,
)
from llmc_paged_tpu_torch.tokenizer import byte_fallback_table
from test_torch_common import one_thread  # noqa: F401
from test_torch_common import params_np, port_cfg

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASKS = "llmc_paged_tpu_torch.parallel.mp_dryrun:"


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    with RankPool(2, workdir=str(tmp_path_factory.mktemp("ranks")),
                  timeout_s=300) as pool:
        yield pool


def test_train_data_parallel_matches_jax(ranks, fixtures_dir):
    """train(data_parallel=2), every rank on its 2 rows of each 4-row
    batch, against JAX's train(data_parallel=2): the losses within 1e-4
    on both ranks; rank 0 logs JAX's val lines (within 1e-4), rank 1
    nothing. (Sampling does not depend on data parallelism:
    test_torch_train.py holds the samples to JAX's.)"""
    cfg_j, p = JF.read_checkpoint(os.path.join(fixtures_dir,
                                               "model_tiny.bin"))
    cfg_t, _ = TG.load_params(os.path.join(fixtures_dir, "model_tiny.bin"))
    path = os.path.join(fixtures_dir, "tokens_tiny.bin")
    kw = dict(steps=6, lr=1e-3, weight_decay=0.1, val_every=3,
              val_batches=2, sample_every=0, seed=11)
    jlog = []
    _, want = j_train(cfg_j, JG.to_device(p, cfg_j), JLoader(path, 4, 16),
                      JLoader(path, 4, 16), data_parallel=2,
                      log=jlog.append, **kw)
    got = ranks.run(TASKS + "train_losses", p, cfg_t, path, 4, 16,
                    val=True, **kw)
    num = re.compile(r"\d+\.\d+")
    for rank, (losses, lines) in enumerate(got):
        np.testing.assert_allclose(losses, want, rtol=0, atol=1e-4)
        if rank:
            assert lines == []
            continue
        mine = [s for s in lines if "val loss" in s]
        ref = [s for s in jlog if "val loss" in s]
        assert len(mine) == len(ref) == 2
        for a, b in zip(mine, ref):
            assert num.sub("#", a) == num.sub("#", b)
            assert abs(float(num.findall(a)[0])
                       - float(num.findall(b)[0])) < 1e-4, (a, b)


def test_mp_dryrun_parent_prints_sentinels(capsys):
    """The dry run's parent over 2 CPU ranks: TP int8 engine tokens equal
    the single-rank run's, one DP step, both sentinels on every rank."""
    mp_dryrun.run_parent(2, device="cpu")
    out = capsys.readouterr().out
    for r in range(2):
        assert f"MP_INIT_OK p{r}" in out and f"MP_DRYRUN_OK p{r}" in out
    assert "tokens match single-rank" in out
    assert "[mp_dryrun] 2-process run OK (gloo on cpu)" in out


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    """A tiny checkpoint (NH=2, so 2 ranks divide it), token stream and
    tokenizer, written by the port's formats."""
    d = tmp_path_factory.mktemp("cli")
    cfg = port_cfg()
    TF.write_checkpoint(str(d / "model.bin"), cfg, params_np(cfg, seed=0))
    TF.write_token_stream(str(d / "tokens.bin"), np.random.default_rng(0)
                          .integers(0, cfg.vocab_size, 400).astype(np.int32))
    TF.write_tokenizer_bin(str(d / "tok.bin"),
                           byte_fallback_table(cfg.vocab_size))
    return d


TORCHRUN = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "2", "-m"]
TORCHRUN_ENV = dict(os.environ, LLMC_PLATFORM="cpu", PYTHONPATH=ROOT,
                    OMP_NUM_THREADS="1")


def _torchrun(module, argv, tmp_path):
    proc = subprocess.run(TORCHRUN + [module] + argv, capture_output=True,
                          text=True, timeout=300, env=TORCHRUN_ENV,
                          cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return proc.stdout


def _in_process(main, argv, monkeypatch):
    monkeypatch.setenv("LLMC_PLATFORM", "cpu")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def test_cli_mesh_model_under_torchrun(cli_files, tmp_path, monkeypatch):
    """``--mesh-model 2`` under torchrun prints, from rank 0 only, the
    sequences one process prints (the timing line aside). With
    ``--profile DIR`` rank 0 writes DIR/trace.json and rank 1
    DIR/trace_rank1.json: each parses with read_trace and holds that
    rank's forwards (one all-gather each, at least one a generated
    token, 2L + 1 all-reduces each), the same on both ranks."""
    argv = [f"--checkpoint={cli_files / 'model.bin'}",
            f"--data={cli_files / 'tokens.bin'}",
            f"--tokenizer={cli_files / 'tok.bin'}", "--batch=3",
            "--prompt-size=12", "--max-new=10", "--greedy",
            "--page-size=8", "--num-pages=40", "--pages-per-seq=8"]
    prof = tmp_path / "prof"
    got = _torchrun("llmc_paged_tpu_torch.engine.cli",
                    argv + ["--mesh-model=2", f"--profile={prof}"], tmp_path)
    want = _in_process(TC.main, argv, monkeypatch)
    timing = re.compile(r"in \S+s \(\S+ tok/s\)")
    assert got.count("--- sequence 0 ") == 1
    assert timing.sub("#", got) == timing.sub("#", want)
    assert sorted(os.listdir(prof)) == ["trace.json", "trace_rank1.json"]
    counts = []
    for name in ("trace.json", "trace_rank1.json"):
        assert DT.read_trace(str(prof / name))["window_ms"] > 0
        ops = collections.Counter(e["name"] for e in DT.load_events(
            str(prof / name)))
        counts.append((ops["c10d::allgather_"], ops["c10d::allreduce_"]))
    n_layers = port_cfg().num_layers
    forwards, reduces = counts[0]
    assert counts[1] == counts[0] and forwards >= 10
    assert reduces == (2 * n_layers + 1) * forwards


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _children(pid: int) -> list:
    """The processes whose parent is ``pid`` (read from /proc)."""
    out = []
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    stat = f.read()
            except OSError:
                continue
            if int(stat.rpartition(")")[2].split()[1]) == pid:
                out.append(int(d))
    return out


def test_cli_serve_mesh_model_under_torchrun(cli_files, tmp_path,
                                             monkeypatch):
    """``--serve PORT --mesh-model 2 --warmup`` under torchrun: every rank
    warms up and serves, rank 0 alone prints the serving line; two
    concurrent POSTs give the in-process CLI's tokens for the same
    prompts. SIGINT to torchrun reaches both ranks, which close together:
    every process exits within 30 s, none killed."""
    argv = [f"--checkpoint={cli_files / 'model.bin'}",
            f"--data={cli_files / 'tokens.bin'}", "--greedy",
            "--page-size=8", "--num-pages=40", "--pages-per-seq=8",
            "--batch=2"]
    want = json.loads(_in_process(
        TC.main, argv + ["--prompt-size=12", "--max-new=10", "--json"],
        monkeypatch))["tokens"]
    port = _free_port()
    out, err = tmp_path / "out.txt", tmp_path / "err.txt"
    with open(out, "w") as fo, open(err, "w") as fe:
        proc = subprocess.Popen(
            TORCHRUN + ["llmc_paged_tpu_torch.engine.cli"] + argv
            + [f"--serve={port}", "--mesh-model=2", "--warmup"],
            stdout=fo, stderr=fe, text=True, env=TORCHRUN_ENV, cwd=tmp_path)
    try:
        deadline = time.monotonic() + 240
        while "serving on" not in out.read_text():
            assert proc.poll() is None and time.monotonic() < deadline, \
                out.read_text()[-2000:] + err.read_text()[-4000:]
            time.sleep(0.1)
        text = out.read_text()
        assert text.count("serving on") == 1 and text.count("warmup:") == 1
        assert f"http://127.0.0.1:{port}" in text
        got = {}

        def post(rid):
            got[rid] = http_post(
                f"http://127.0.0.1:{port}/generate",
                dict(prompt=want[rid][:12], max_new_tokens=10), timeout=120)

        threads = [threading.Thread(target=post, args=(rid,))
                   for rid in want]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for rid, tokens in want.items():
            status, reply, _ = got[rid]
            assert (status, reply["tokens"]) == (200, tokens)
        workers = _children(proc.pid)
        assert len(workers) == 2
        t0 = time.monotonic()
        proc.send_signal(signal.SIGINT)
        proc.wait(timeout=30)
        while any(os.path.exists(f"/proc/{w}") for w in workers):
            assert time.monotonic() - t0 < 30, workers
            time.sleep(0.1)
        assert "forcefully" not in err.read_text()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_train_cli_data_parallel_under_torchrun(cli_files, tmp_path,
                                                monkeypatch):
    """``--data-parallel 2`` under torchrun: rank 0 alone prints the train
    and val lines and saves; the losses equal one process's within 1e-4
    (the same global batches, the gradients averaged over the ranks)."""
    argv = [f"--train-data={cli_files / 'tokens.bin'}",
            f"--val-data={cli_files / 'tokens.bin'}", "--steps=3",
            "--batch=4", "--seq-len=16", "--layers=2", "--heads=2",
            "--channels=32", "--vocab=512", "--max-seq-len=32",
            "--val-every=2", "--sample-every=0"]
    save = tmp_path / "dp.bin"
    got = _torchrun("llmc_paged_tpu_torch.train",
                    argv + ["--data-parallel=2", f"--save={save}"], tmp_path)
    want = _in_process(t_train_mod.main, argv, monkeypatch)
    assert got.count("train loss") == 3 and got.count("val loss") == 2
    assert got.count(f"saved {save}") == 1 and save.exists()
    num = re.compile(r"loss (\d+\.\d+)")
    np.testing.assert_allclose([float(v) for v in num.findall(got)],
                               [float(v) for v in num.findall(want)],
                               rtol=0, atol=1e-4)


def test_rank_failure_after_init_raises_mp_child_failure(ranks):
    """A task that raises on the ranks (a mesh of 3 in a group of 2)
    fails the pool with MpChildFailure: the ranks had joined the group.
    Runs last: a failure stops the module's pool."""
    with pytest.raises(MpChildFailure, match="needs an initialized"):
        ranks.run("llmc_paged_tpu_torch.parallel.sharding:make_mesh", 3)
    with pytest.raises(RuntimeError, match="closed"):
        ranks.run(TASKS + "rank_device")
