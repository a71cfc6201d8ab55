"""Multi-process dry run and the launcher of rank processes (port of
llmc_paged_tpu/parallel/mp_dryrun.py).

The reference's only multi-process execution is DDP under torchrun
(train_gpt2.py:400-428, 577-578): N OS processes and collectives that
cross process boundaries. The port runs the same way: one process a
rank, each in one torch.distributed group, all running the same
program and the same host schedule.

``RankPool`` starts ``world`` processes (``python -m
llmc_paged_tpu_torch.parallel.mp_dryrun --role child``), each joining the
group as one rank (``backend`` gloo on the CPU or for ranks that share a
card, nccl across cards; the rendezvous is a file in the pool's
directory, so concurrent pools never race for a port). Each child prints
``MP_INIT_OK p<rank>`` once it has joined, then runs tasks:
``pool.run("module:function", *args)`` runs the function on every rank
and returns the ranks' results in rank order. A task's target is
imported by module name in the child, so it lives in an importable
module (this one holds the ones the tests use). Tasks and results pass
as pickles through the pool's directory; each child's output goes to
``rank<r>.log`` there. ``run_ranks`` is one pool, one task.

The dry run (``python -m llmc_paged_tpu_torch.parallel.mp_dryrun
[--nprocs 2]``; ``LLMC_PLATFORM=cpu`` for the CPU, else one card a rank
over NCCL, or gloo where ranks outnumber the cards) runs on every rank

  1. the int8 continuous-batching engine under tensor parallelism
     (admission, batched prefill, chunk chains, pool pressure),
     asserting that its tokens equal a single-rank run's, and
  2. one data-parallel AdamW step, asserting a finite loss, equal on
     every rank,

and prints ``MP_DRYRUN_OK p<rank>``. A child that failed after
``MP_INIT_OK`` is a correctness failure (``MpChildFailure``); one that
never joined the group an environmental one (``RuntimeError``).
"""

from __future__ import annotations

import argparse
import importlib
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_POLL_S = 0.002


class MpChildFailure(RuntimeError):
    """A child got PAST joining the process group (the environment was
    fine) and then failed: a multi-process correctness failure. Callers
    that treat environmental problems (no backend, spawn failure) as
    skippable must NOT swallow this."""


def _dump(obj, path: str) -> None:
    """Pickle ``obj`` to ``path`` atomically (write, then rename), so a
    reader polling for ``path`` never sees half a file."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(obj, f)
    os.replace(tmp, path)


def _load(path: str):
    # the pool's own files, written by this program's processes only
    with open(path, "rb") as f:
        return pickle.load(f)


def _resolve(target: str):
    module, _, name = target.partition(":")
    return getattr(importlib.import_module(module), name)


def rank_device():
    """The device of this rank's process (set by the child from the
    pool's ``device``): "cpu", or one card."""
    import torch
    return torch.device(os.environ["LLMC_RANK_DEVICE"])


class RankPool:
    """``world`` rank processes in one process group that run tasks (see
    the module docstring). ``device``: "cpu", "cuda" (card rank % count
    on each rank) or one card for every rank ("cuda:0"). The pool's files
    go to a new directory (in ``workdir`` when given), removed on close.
    Use as a context manager, or call ``close()``."""

    def __init__(self, world: int, backend: str = "gloo", device="cpu",
                 workdir=None, timeout_s: float = 900.0):
        self.world = world
        self.timeout_s = timeout_s
        # a directory of its own (in ``workdir`` when given): a task or
        # result file of an earlier pool must never be read as this one's
        if workdir is not None:
            os.makedirs(workdir, exist_ok=True)
        self.dir = tempfile.mkdtemp(prefix="llmc_ranks_", dir=workdir)
        self._next = 0
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        init = "file://" + os.path.join(self.dir, "rendezvous")
        self._logs = [os.path.join(self.dir, f"rank{r}.log")
                      for r in range(world)]
        self.procs = []
        try:
            for r in range(world):
                with open(self._logs[r], "w") as log:
                    self.procs.append(subprocess.Popen(
                        [sys.executable, "-m",
                         "llmc_paged_tpu_torch.parallel.mp_dryrun",
                         "--role", "child", "--rank", str(r),
                         "--world", str(world), "--backend", backend,
                         "--device", str(device), "--init-method", init,
                         "--tasks", self.dir,
                         "--timeout", str(timeout_s)],
                        cwd=REPO, env=env, stdout=log,
                        stderr=subprocess.STDOUT))
        except BaseException:
            self.close()
            raise

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def log(self, rank: int) -> str:
        """What rank ``rank`` has printed so far."""
        with open(self._logs[rank], errors="replace") as f:
            return f.read()

    def _fail(self, rank: int, why: str):
        logs = {r: self.log(r) for r in range(self.world)}
        self.close(kill=True)
        exc = (MpChildFailure if f"MP_INIT_OK p{rank}" in logs[rank]
               else RuntimeError)
        tails = "\n".join(f"--- rank {r} ---\n{text[-4000:]}"
                          for r, text in logs.items())
        raise exc(f"rank {rank} {why}\n{tails}")

    def run(self, target: str, *args, **kwargs) -> list:
        """Run ``target`` ("module:function") with these arguments on
        every rank; the ranks' results in rank order. A rank that raises,
        dies or outlasts the pool's timeout fails the pool: every child
        is stopped and MpChildFailure (or RuntimeError, for a rank that
        never joined the group) raised with their logs."""
        if not self.procs:
            raise RuntimeError("the rank pool is closed")
        k = self._next
        self._next += 1
        _dump((target, args, kwargs), os.path.join(self.dir, f"task{k}.pkl"))
        results = {}
        deadline = time.monotonic() + self.timeout_s
        while len(results) < self.world:
            for r in range(self.world):
                path = os.path.join(self.dir, f"result{k}_{r}.pkl")
                if r not in results and os.path.exists(path):
                    ok, value = _load(path)
                    if not ok:
                        self._fail(r, f"raised in {target}:\n{value}")
                    results[r] = value
            for r, p in enumerate(self.procs):
                if r not in results and p.poll() is not None:
                    self._fail(r, f"exited with code {p.returncode} in "
                                  f"{target}")
            if time.monotonic() > deadline:
                self._fail(min(set(range(self.world)) - set(results)),
                           f"did not finish {target} in {self.timeout_s} s")
            time.sleep(_POLL_S)
        return [results[r] for r in range(self.world)]

    def close(self, kill: bool = False) -> None:
        """Stop the children: a None task ends each loop, and any child
        still running 60 s later (at once with ``kill``: after a failure,
        ranks may wait in a collective) is killed. Removes the pool's
        directory."""
        procs, self.procs = self.procs, []
        if procs:
            _dump(None, os.path.join(self.dir, f"task{self._next}.pkl"))
            deadline = time.monotonic() + (0 if kill else 60)
            for p in procs:
                try:
                    p.wait(timeout=max(0.1, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        shutil.rmtree(self.dir, ignore_errors=True)


def run_ranks(world: int, target: str, args=(), kwargs=None,
              backend: str = "gloo", device="cpu", workdir=None,
              timeout_s: float = 900.0) -> list:
    """One pool of ``world`` ranks, one task: ``target(*args, **kwargs)``
    on every rank; the results in rank order."""
    with RankPool(world, backend, device, workdir, timeout_s) as pool:
        return pool.run(target, *args, **(kwargs or {}))


def _child(rank: int, world: int, backend: str, device: str,
           init_method: str, tasks: str, timeout_s: float) -> int:
    """A rank's process: join the group, then run the pool's tasks in
    order until a None task (or until the parent is gone)."""
    parent = os.getppid()
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    import torch
    import torch.distributed as dist

    from llmc_paged_tpu_torch.parallel.sharding import init_distributed
    if device == "cpu":
        torch.set_num_threads(1)
    elif device == "cuda":
        device = f"cuda:{rank % torch.cuda.device_count()}"
    os.environ["LLMC_RANK_DEVICE"] = device
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    # the rank's card on this host, as torchrun's LOCAL_RANK names it
    os.environ["LOCAL_RANK"] = str(torch.device(device).index or 0)
    init_distributed(backend, init_method, rank, world, timeout_s)
    # past this line failures are CORRECTNESS failures, not environment
    # ones: the parent tells them apart by this sentinel
    print(f"MP_INIT_OK p{rank}", flush=True)
    k = 0
    while True:
        path = os.path.join(tasks, f"task{k}.pkl")
        while not os.path.exists(path):
            if os.getppid() != parent:
                return 1            # the parent is gone
            time.sleep(_POLL_S)
        task = _load(path)
        if task is None:
            break
        target, args, kwargs = task
        try:
            result = (True, _resolve(target)(*args, **kwargs))
        except Exception:           # reported to the parent, which fails
            result = (False, traceback.format_exc())
            print(result[1], flush=True)
        _dump(result, os.path.join(tasks, f"result{k}_{rank}.pkl"))
        if not result[0]:
            return 1
        k += 1
    dist.destroy_process_group()
    return 0


# ---- rank tasks (targets the tests, the dry run and chip_smoke.py use) ---------

def _params(spec, cfg):
    """Float parameters: a numpy dict as given, or an int seed, drawn on
    the CPU by a torch.Generator (the same weights on every rank)."""
    if isinstance(spec, dict):
        return spec
    import torch

    from llmc_paged_tpu_torch.models import gpt2
    return gpt2.init_params(cfg, torch.Generator().manual_seed(spec),
                            device="cpu")


class TopTwo:
    """An engine's model pieces with a record: the two largest logits of
    every row at every logits call (a prefill wave, a chunk step), so a
    caller can read how near a tie each greedy pick was. Everything else
    is the wrapped pieces'."""

    def __init__(self, inner):
        self.inner = inner
        self.calls = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def logits(self, x, params, cfg):
        import torch
        out = self.inner.logits(x, params, cfg)
        self.calls.append(torch.topk(out.float(), 2, dim=-1).values.cpu()
                          .numpy())
        return out


def weight_bytes(engine) -> int:
    """Bytes of the weights an InferenceEngine holds on its device (the
    whole model's, the bf16 prefill copy's, a TP rank's shards), each
    tensor once."""
    seen = {}
    for d in (engine.params, engine._prefill_params, engine._decode_params,
              engine._prompt_params):
        for t in (d or {}).values():
            seen[t.data_ptr()] = t.numel() * t.element_size()
    return sum(seen.values())


def engine_run(params, cfg, econf, requests, runs: int = 1, window=None,
               record: bool = False, warm_new: int = 0):
    """``runs`` runs of one InferenceEngine on this rank's device over
    ``requests`` (a list of Request keyword dicts); per run a dict of the
    streams {rid: tokens}, the engine's stats, the TP collectives and
    the kernels' launches of the run, the engine's ``weight_bytes``, the
    process's peak allocated bytes on a card since the task began (0 on
    the CPU), and with ``record`` (the last run only) the two largest
    logits of every row at every logits call (``TopTwo``). ``warm_new``
    > 0 first runs the requests once at that many new tokens, unreported
    (the kernels load, the allocator warms). ``params``: numpy dict or
    seed (``_params``)."""
    import torch

    from llmc_paged_tpu_torch.engine.engine import InferenceEngine
    from llmc_paged_tpu_torch.engine.scheduler import Request
    from llmc_paged_tpu_torch.ops import paged_attention as pa
    from llmc_paged_tpu_torch.parallel import sharding as sh
    dev = rank_device()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    eng = InferenceEngine(_params(params, cfg), cfg, econf, device=dev)
    if warm_new:
        eng.run([Request(**dict(r, max_new_tokens=warm_new))
                 for r in requests], window=window)
    out = []
    for i in range(runs):
        for counts in (sh.COLLECTIVES, pa.LAUNCHES):
            for key in counts:
                counts[key] = 0
        top2 = None
        if record and i == runs - 1:
            top2 = eng._model = TopTwo(eng._model)
        done = eng.run([Request(**r) for r in requests], window=window)
        if cuda:
            torch.cuda.synchronize(dev)
        out.append({"streams": {r.rid: list(r.tokens) for r in done},
                    "stats": dict(eng.stats),
                    "collectives": dict(sh.COLLECTIVES),
                    "launches": dict(pa.LAUNCHES),
                    "weight_bytes": weight_bytes(eng),
                    "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                   if cuda else 0),
                    "top2": None if top2 is None else top2.calls})
    return out


# ---- serving over TP ranks ---------------------------------------------------

def http_post(url: str, payload: dict, timeout: float = 300.0):
    """POST ``payload`` as JSON; (status, reply, seconds)."""
    import json
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    t0 = time.monotonic()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), time.monotonic() - t0
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), time.monotonic() - t0


def http_stream(url: str, payload: dict, timeout: float = 300.0):
    """POST a streaming request and read it to its end; (the streamed
    tokens, seconds to the first token line, the final line)."""
    import json
    import urllib.request
    req = urllib.request.Request(
        url, data=json.dumps(dict(payload, stream=True)).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    t0 = time.monotonic()
    toks, t_first, final = [], None, None
    with urllib.request.urlopen(req, timeout=timeout) as r:
        for line in r:
            obj = json.loads(line)
            if obj.get("done"):
                final = obj
            else:
                toks.extend(obj["tokens"])
                if t_first is None:
                    t_first = time.monotonic() - t0
    return toks, t_first, final


def http_disconnect(host: str, port: int, payload: dict, lines: int = 2):
    """POST a streaming request over a raw socket, read its first
    ``lines`` token lines (the first holds only the prefill's pick) and
    close the connection, which cancels the request; their tokens."""
    import json
    import socket
    body = json.dumps(dict(payload, stream=True)).encode()
    s = socket.create_connection((host, port), timeout=120)
    try:
        s.sendall(b"POST /generate HTTP/1.1\r\nHost: ranks\r\n"
                  b"Content-Type: application/json\r\n"
                  + f"Content-Length: {len(body)}\r\n\r\n".encode()
                  + body)
        buf = b""
        while buf.partition(b"\r\n\r\n")[2].count(b"\n") < lines:
            chunk = s.recv(65536)
            if not chunk:
                raise RuntimeError(f"the stream closed before {lines} "
                                   "lines")
            buf += chunk
    finally:
        s.close()
    got = buf.partition(b"\r\n\r\n")[2].split(b"\n")[:lines]
    return [t for ln in got for t in json.loads(ln)["tokens"]]


def serve_run(params, cfg, econf, requests, client: str = "submit",
              gap_s: float = 0.0, cancel_running=None, cancel_queued=None,
              bad=(), batch: bool = True, warmup: bool = False):
    """A ServingEngine over this rank's engine (every rank builds one; a
    model group's leader takes the requests). ``requests``: Request
    keyword dicts. First, with ``batch``, the engine's ``run()`` of the
    same requests on every rank; with ``warmup``, ``warmup()``. Then the
    leader starts one client thread a request, ``gap_s`` apart, each
    through ``client``:

    - "submit": ``submit`` and the future's result;
    - "stream": ``submit_stream``, its batches concatenated;
    - "http": a POST to an HttpServingFront on the leader (127.0.0.1).

    The request ``cancel_running`` is streamed and cancelled after its
    first batch: under "submit" or "stream" the engine waits in that
    flush until the client has cancelled (so the cancel lands at the
    next poll), under "http" the client disconnects after two lines. The
    request ``cancel_queued`` ("submit") is cancelled right after its
    submission. ``bad`` ("http"): more payloads, whose statuses are
    returned. A follower records the error of its own ``submit``. Then
    ``close()`` on every rank.

    Returns a dict: ``leader``; ``batch`` {rid: tokens}; ``served`` {rid:
    {tokens, cancelled}} (the leader's clients; tokens None for a
    cancelled future); ``bad``; ``follower_error``; ``finished`` {rid:
    [tokens, cancelled]} as the serving loop finished them on this rank
    (the HTTP front numbers its requests itself); ``live`` (the front's
    ``stats()`` after the drain), ``stats`` (the engine's), ``launches``
    and ``collectives`` of the served run; ``alive`` (the loop after
    close); ``wall_s`` of the clients."""
    import threading
    from concurrent.futures import CancelledError

    from llmc_paged_tpu_torch.engine.engine import InferenceEngine
    from llmc_paged_tpu_torch.engine.http_server import HttpServingFront
    from llmc_paged_tpu_torch.engine.scheduler import Request
    from llmc_paged_tpu_torch.engine.server import ServingEngine
    from llmc_paged_tpu_torch.ops import paged_attention as pa
    from llmc_paged_tpu_torch.parallel import sharding as sh
    eng = InferenceEngine(_params(params, cfg), cfg, econf,
                          device=rank_device())
    out = {"batch": None, "served": {}, "bad": [], "follower_error": None}
    if batch:
        done = eng.run([Request(**r) for r in requests])
        out["batch"] = {r.rid: list(r.tokens) for r in done}
    if warmup:
        eng.warmup()
    for counts in (sh.COLLECTIVES, pa.LAUNCHES):
        for key in counts:
            counts[key] = 0
    resume = threading.Event()

    class Recording(ServingEngine):
        """Records what the loop finishes; on the leader, holds the flush
        of ``cancel_running``'s first batch until its client cancelled."""

        def __init__(self, *args, **kwargs):
            self.finished = {}         # before the loop starts
            super().__init__(*args, **kwargs)

        def _on_tokens(self, req, new_tokens):
            super()._on_tokens(req, new_tokens)
            if (req.rid == cancel_running and self.is_leader
                    and client != "http"):
                resume.wait(60)

        def _on_finish(self, req):
            self.finished[req.rid] = [list(req.tokens), req.cancelled]
            super()._on_finish(req)

    srv = Recording(eng)
    out["leader"] = srv.is_leader
    front = None
    if srv.is_leader and client == "http":
        front = HttpServingFront(srv, "127.0.0.1", 0)
    url = front and f"http://{front.host}:{front.port}/generate"
    fields = ("max_new_tokens", "stop_tokens", "temperature", "top_k",
              "greedy", "priority", "logprobs", "prompt_logprobs",
              "frequency_penalty", "presence_penalty")

    def one(r):
        kw = {k: v for k, v in r.items() if k in fields}
        rid, prompt = r["rid"], list(r["prompt"])
        res = {"cancelled": False}
        if client == "http":
            payload = dict(kw, prompt=prompt)
            if rid == cancel_running:
                got = http_disconnect(front.host, front.port, payload)
                res.update(tokens=prompt + got, cancelled=True)
            elif r.get("stream"):
                res["tokens"] = prompt + http_stream(url, payload)[0]
            else:
                status, reply, _ = http_post(url, payload)
                if status != 200:
                    raise RuntimeError(f"request {rid}: HTTP {status} "
                                       f"{reply}")
                res["tokens"] = reply["tokens"]
        elif client == "stream" or rid == cancel_running:
            it = srv.submit_stream(prompt, rid=rid, **kw)
            got = []
            for part in it:
                got.extend(part)
                if rid == cancel_running and not res["cancelled"]:
                    res["cancelled"] = it.cancel()
                    resume.set()
            res["tokens"] = prompt + got
        else:
            fut = srv.submit(prompt, rid=rid, **kw)
            if rid == cancel_queued:
                srv.cancel(rid)
            try:
                res["tokens"] = fut.result(timeout=600)
            except CancelledError:
                res.update(tokens=None, cancelled=True)
        out["served"][rid] = res

    errors = []

    def guarded(r):
        try:
            one(r)
        except BaseException as e:     # re-raised below, after close
            errors.append(e)

    t0 = time.monotonic()
    if srv.is_leader:
        threads = []
        for i, r in enumerate(requests):
            if i and gap_s:
                time.sleep(gap_s)
            threads.append(threading.Thread(target=guarded, args=(r,)))
            threads[-1].start()
        for t in threads:
            t.join()
        out["bad"] = [http_post(url, payload)[0] for payload in bad]
    else:
        try:
            srv.submit(list(requests[0]["prompt"]), 1)
        except RuntimeError as e:
            out["follower_error"] = str(e)
    out["wall_s"] = time.monotonic() - t0
    if front is not None:
        front.close()
    srv.close()
    if errors:
        raise errors[0]
    if srv._error is not None:
        raise RuntimeError("the serving loop died") from srv._error
    out.update(finished=srv.finished, live=srv.stats(),
               stats=dict(eng.stats), launches=dict(pa.LAUNCHES),
               collectives=dict(sh.COLLECTIVES),
               alive=srv._thread.is_alive())
    return out


def step_logits(params, cfg, page, prompts, data: int = 1,
                param_dtype="float32", kv_dtype="float32"):
    """TP prefill of tokens [0, T-1) of ``prompts`` (a (B, T) int array)
    into a fresh pool, then one TP decode step of token T-1; the step's
    logits (B, V) as f32 numpy. Row b takes pages [b·pps, (b+1)·pps).
    The mesh: ``data`` replicas of world/data ranks on the model axis."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from llmc_paged_tpu_torch.kv.layouts import token_coords
    from llmc_paged_tpu_torch.parallel import sharding as sh
    mesh = sh.make_mesh(model=dist.get_world_size() // data, data=data)
    dev = rank_device()
    params_tp = sh.prepare_tp_params(
        _params(params, cfg), cfg, mesh, param_dtype=param_dtype,
        device=dev)
    pool = sh.init_tp_pool(cfg, page, mesh, dtype=kv_dtype, device=dev)
    x = torch.as_tensor(np.asarray(prompts), dtype=torch.int32)
    B, T = x.shape
    pps = page.pages_per_seq
    tables = torch.arange(B * pps, dtype=torch.int32).reshape(B, pps)
    pos = torch.arange(T - 1, dtype=torch.int32).repeat(B, 1)
    pg, sl = token_coords(tables, pos, page.page_size,
                          torch.ones(B, T - 1, dtype=torch.bool),
                          page.num_pages)
    _, pool = sh.make_tp_prefill(cfg, mesh)(
        params_tp, x[:, : T - 1], pg, sl, pool,
        torch.full((B,), T - 2, dtype=torch.int32))
    last = torch.full((B,), T - 1, dtype=torch.int32)
    pg1, sl1 = token_coords(tables, last[:, None], page.page_size,
                            torch.ones(B, 1, dtype=torch.bool),
                            page.num_pages)
    logits, _ = sh.make_tp_decode_step(cfg, mesh)(
        params_tp, x[:, T - 1], last, pg1[:, 0], sl1[:, 0], tables,
        last + 1, torch.zeros(B, dtype=torch.int32), pool)
    return logits.float().cpu().numpy()


def embed_logits(params, cfg, tokens, wpe_pos):
    """The vocab-sharded embedding of ``tokens`` at ``wpe_pos`` and the
    logits of that embedding, all ranks on the model axis; f32 numpy."""
    import torch
    import torch.distributed as dist

    from llmc_paged_tpu_torch.parallel import sharding as sh
    mesh = sh.make_mesh(model=dist.get_world_size())
    params_tp = sh.prepare_tp_params(_params(params, cfg), cfg, mesh,
                                     device=rank_device())
    dev = rank_device()
    emb = sh._tp_embed(params_tp, torch.as_tensor(tokens, device=dev),
                       torch.as_tensor(wpe_pos, device=dev), mesh)
    logits = sh._tp_logits(emb, params_tp, mesh, cfg)
    return emb.cpu().numpy(), logits.cpu().numpy()


def dp_losses(params, cfg, x, y, steps: int = 2, model: int = 1):
    """``steps`` data-parallel AdamW steps (lr 1e-4, the JAX dry run's) on
    the global batch (x, y) over a mesh of world/model ranks on the data
    axis (the ranks of a model row take the same rows); the losses the
    steps return."""
    import torch
    import torch.distributed as dist

    from llmc_paged_tpu_torch.models import gpt2
    from llmc_paged_tpu_torch.parallel import sharding as sh
    dev = rank_device()
    mesh = sh.make_mesh(model=model, data=dist.get_world_size() // model)
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in
              gpt2.to_device(_params(params, cfg), cfg, device=dev).items()}
    opt = torch.optim.AdamW(leaves.values(), lr=1e-4, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=0.0)
    step, shard_batch, replicate = sh.make_dp_train_step(cfg, mesh, opt)
    replicate(leaves)
    xd, yd = shard_batch(torch.as_tensor(x, device=dev),
                         torch.as_tensor(y, device=dev))
    return [float(step(leaves, xd, yd)) for _ in range(steps)]


def train_losses(params, cfg, data_path: str, batch: int, seq_len: int,
                 **kw):
    """``train(data_parallel=world)`` over a stream loader on this rank's
    device; (losses, the lines it logged)."""
    import torch.distributed as dist

    from llmc_paged_tpu_torch.models import gpt2
    from llmc_paged_tpu_torch.train import train
    from llmc_paged_tpu_torch.utils.dataloader import DataLoader
    lines = []
    val = kw.pop("val", False)
    _, losses = train(
        cfg, gpt2.to_device(_params(params, cfg), cfg, device=rank_device()),
        DataLoader(data_path, batch, seq_len),
        DataLoader(data_path, batch, seq_len) if val else None,
        data_parallel=dist.get_world_size(), log=lines.append, **kw)
    return losses, lines


# ---- the dry run -----------------------------------------------------------------

def dryrun() -> None:
    """The dry run's body on one rank (module docstring): the JAX
    package's configuration (``mp_dryrun.py:82-108``) at head_dim 64, the
    one the port's kernels take (C 512 for its 8 heads)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from llmc_paged_tpu_torch.config import EngineConfig, GPT2Config, \
        PageConfig

    rank, world = dist.get_rank(), dist.get_world_size()

    def log(msg: str) -> None:
        print(f"[mp_dryrun p{rank}] {msg}", flush=True)

    cfg = GPT2Config.tiny(max_seq_len=64, vocab_size=256, num_layers=2,
                          num_heads=8, channels=512)
    model = next(c for c in (8, 4, 2, 1)
                 if world % c == 0 and cfg.num_heads % c == 0)
    data = world // model
    log(f"ranks={world} device={rank_device()} mesh: model={model} "
        f"data={data}")
    rng = np.random.default_rng(7)
    reqs = [dict(rid=i, prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                 max_new_tokens=new)
            for i, (n, new) in enumerate(zip((5, 11, 7, 9), (10, 8, 12, 9)))]
    page = PageConfig(page_size=8, num_pages=10, max_seqs=8,
                      pages_per_seq=6, kv_dtype="int8")

    def econf(mesh_shape):
        return EngineConfig(cache_mode="paged", page=page, greedy=True,
                            max_batch=4, decode_chunk=6, param_dtype="int8",
                            mesh_shape=mesh_shape)

    t0 = time.monotonic()
    tp, = engine_run(0, cfg, econf({"data": data, "model": model}), reqs)
    tp_out = tp["streams"]
    log(f"TP int8 engine over {world} processes OK "
        f"({time.monotonic() - t0:.1f}s, collectives {tp['collectives']})")
    ref_out = engine_run(0, cfg, econf(None), reqs)[0]["streams"]
    if tp_out != ref_out:
        raise AssertionError(f"multi-process TP tokens != single-rank: "
                             f"{tp_out} vs {ref_out}")
    log(f"tokens match single-rank (all "
        f"{sum(len(v) for v in tp_out.values())})")

    brng = np.random.default_rng(1)
    B = max(4, data)
    x = brng.integers(0, cfg.vocab_size, (B, 16)).astype(np.int64)
    y = brng.integers(0, cfg.vocab_size, (B, 16)).astype(np.int64)
    loss, = dp_losses(0, cfg, x, y, steps=1, model=model)
    losses = [torch.zeros(1, device=rank_device()) for _ in range(world)]
    dist.all_gather(losses, torch.tensor([loss], device=rank_device()))
    losses = [float(t) for t in losses]
    if not (np.isfinite(loss) and len(set(losses)) == 1):
        raise AssertionError(f"DP losses not finite and equal: {losses}")
    log(f"DP train step OK loss={loss:.4f}")
    print(f"MP_DRYRUN_OK p{rank}", flush=True)


def run_parent(nprocs: int = 2, device=None, backend=None,
               timeout_s: float = 900.0) -> None:
    """Start ``nprocs`` ranks (``RankPool``), run the dry run on each and
    require every one's MP_DRYRUN_OK sentinel; print their logs. Raises
    MpChildFailure when a rank failed after MP_INIT_OK (correctness),
    plain RuntimeError when it never joined (environmental)."""
    import torch

    from llmc_paged_tpu_torch import platform_device, resolve_device
    dev = resolve_device(device if device is not None
                         else platform_device())
    if backend is None:
        backend = ("nccl" if dev.type == "cuda"
                   and torch.cuda.device_count() >= nprocs else "gloo")
    with RankPool(nprocs, backend, dev.type, timeout_s=timeout_s) as pool:
        pool.run("llmc_paged_tpu_torch.parallel.mp_dryrun:dryrun")
        logs = [pool.log(r) for r in range(nprocs)]
    for r, out in enumerate(logs):
        if f"MP_DRYRUN_OK p{r}" not in out:
            raise MpChildFailure(f"mp_dryrun rank {r} printed no "
                                 f"MP_DRYRUN_OK:\n{out}")
        sys.stdout.write(out)
    print(f"[mp_dryrun] {nprocs}-process run OK ({backend} on {dev.type})",
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="llmc_paged_tpu_torch.parallel."
                                      "mp_dryrun")
    ap.add_argument("--role", choices=("parent", "child"), default="parent")
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--backend", default=None,
                    help="gloo or nccl (default: nccl with a card a rank, "
                         "else gloo)")
    # the child's own flags (set by RankPool)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--init-method", default=None)
    ap.add_argument("--tasks", default=None)
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args(argv)
    if args.role == "child":
        return _child(args.rank, args.world, args.backend, args.device,
                      args.init_method, args.tasks, args.timeout)
    run_parent(args.nprocs, backend=args.backend)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
