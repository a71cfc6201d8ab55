"""One run of one cell: the program under test built from a configuration
file, driven by a traffic mix through ``InferenceEngine.run``, measured
over a window, checked against the plain reference.

What the run knows of the model comes from the configuration's family
(``families/<model_type>.py``, found by the registry): the program's
configs, the weights, the reference, the FLOPs a token needs, the
kernels the trace is read for and the spans around the model's calls.

The steps, in order:
 1. f32 weights from the seed on the device (the family's
    ``make_weights``);
 2. the engine, through the port's public API (``InferenceEngine``, with
    the family's ``program_config`` and ``engine_config``), handed those
    weights; the f32 copy is dropped (the reference draws it again after
    the window);
 3. every CUDA source of the program built into the checkout's
    ``build/torch_kernels/`` (on its first run; later runs find them);
 4-5. the closed loop starts at once: its first requests warm the
    allocator and the cell's own shapes and ramp the engine to its
    steady mix: the window opens when
    ``ramp_finished_per_slot`` x concurrency requests have finished;
    all of it is set-up (``setup_s``);
 6. ``--seconds`` of measurement; a traced run profiles the window's last
    ``trace_seconds`` (the profiler is started one feed poll earlier, so
    its first records, which the tracer can drop, fall in a warm-up
    step);
 7. the window closes at the first feed poll after deliveries of every
    kind (first tokens, decode tokens) at or past its end, so the work
    that straddles the end is counted in proportion: live requests are
    cancelled (not failures) and the feed
    closes; the peak memory is read, the engine freed, and the sample of
    finished requests compared with the reference (``check.py``);
 8. the result: every metric the cell reports, the device, each compared
    number beside its limit.

The load generator is the engine's own ``feed``: it runs on the engine's
thread, between chain links and at each scheduler iteration, so no
client thread competes with the host-bound loop for the interpreter.
"""

from __future__ import annotations

import gc
import os
import re
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import torch

from benchmarks import check, weights
from benchmarks.reference import full_f32
from benchmarks.registry import Registry
from llmc_paged_tpu_torch.engine.engine import InferenceEngine
from llmc_paged_tpu_torch.engine.scheduler import Request

# the window closes by itself this long after its end if no delivery
# comes (an engine that stopped serving)
CLOSE_GRACE_S = 60.0
# a kernel's name in the breakdown (templated names run to kilobytes)
NAME_CHARS = 160


def _log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


class Loop:
    """The closed loop, the window and the trace slice, driven from the
    engine's callbacks. ``deliveries`` holds one entry a materialization
    and kind (first tokens of a wave, or decode tokens, handed out between
    two feed polls): its time, the time of the delivery of its kind before
    it, output tokens, prompt tokens scored, the FLOPs its real tokens
    needed (the ``model`` config's family's ``flops``), the feed poll and
    the kind."""

    def __init__(self, traffic, concurrency: int, seconds: float,
                 ramp_finished: int, model: dict, mix: dict,
                 trace_seconds: Optional[float], device: torch.device,
                 clock=time.monotonic, registry: Optional[Registry] = None):
        self.traffic, self.concurrency = traffic, concurrency
        self.seconds, self.ramp_finished = seconds, ramp_finished
        self.token_flops = (registry or Registry()).family_of(model).flops(
            model)
        self.score = bool(mix.get("prompt_logprobs", False))
        self.trace_seconds = trace_seconds
        self.device, self.clock = device, clock
        self.live: Dict[int, Request] = {}
        self.requests: List[Request] = []
        self.sent: Dict[int, int] = {}
        self.deliveries: List[List] = []
        self.last: Dict[str, List] = {}     # the newest delivery a kind
        self.epoch = 0
        self.finished = 0
        self.failed: List[int] = []
        self.t_start = clock()
        self.t_open = self.t_close = self.t_closed = None
        self.host: List[Dict[str, float]] = []
        self.prof = None
        self.prof_state = "off"
        self.t_slice = [None, None]

    # -- the engine's callbacks ----------------------------------------------
    def feed(self, block: bool):
        now = self.clock()
        self.epoch += 1
        if self.t_open is None and self.finished >= self.ramp_finished:
            self.t_open, self.t_close = now, now + self.seconds
            self.host = [host_sample()]
        if self.t_open is not None:
            self._trace_poll(now)
            # every kind of delivery past the end: the work that straddles
            # it has been handed out and can be counted in proportion
            past = self.last and all(d[0] >= self.t_close
                                     for d in self.last.values())
            if past or now >= self.t_close + CLOSE_GRACE_S:
                self._close(now)
                return [], False
        new = []
        while len(self.live) < self.concurrency:
            prompt, n_out, plp = self.traffic.next()
            rid = len(self.requests)
            r = Request(rid=rid, prompt=prompt, max_new_tokens=n_out,
                        prompt_logprobs=plp, t_submit=self.clock())
            self.requests.append(r)
            self.live[rid] = r
            new.append(r)
        return new, True

    def on_tokens(self, req: Request, toks) -> None:
        now = self.clock()
        k0 = self.sent.get(req.rid, 0)
        n = len(toks)
        self.sent[req.rid] = k0 + n
        flops = 0.0
        prompt_tokens = 0
        np_ = len(req.prompt)
        for k in range(k0, k0 + n):
            if k == 0:
                flops += self.token_flops.prefill(
                    np_, np_ if self.score else 1)
                prompt_tokens += np_ if self.score else 0
            else:
                flops += self.token_flops.decode(np_ + k)
        # a first token comes from an admission wave, later ones from
        # decode steps: each kind's deliveries are spread since the last
        # of the same kind (the engine hands a wave's first tokens out
        # after it has dispatched the next link, so the link's tokens were
        # computed over both intervals, not since the first tokens)
        kind = "first" if k0 == 0 else "decode"
        d = self.last.get(kind)
        if d is not None and d[5] == self.epoch:
            d[2] += n
            d[3] += prompt_tokens
            d[4] += flops
        else:
            prev = d[0] if d is not None else self.t_start
            self.last[kind] = [now, prev, n, prompt_tokens, flops,
                               self.epoch, kind]
            self.deliveries.append(self.last[kind])

    def on_finish(self, req: Request) -> None:
        self.live.pop(req.rid, None)
        if req.cancelled:
            return
        self.finished += 1
        ok = len(req.generated) == req.max_new_tokens and (
            not req.prompt_logprobs
            or len(req.prompt_logprob_values) == len(req.prompt) - 1)
        if not ok:
            self.failed.append(req.rid)

    # -- window end and trace slice ------------------------------------------
    def _close(self, now: float) -> None:
        self.t_closed = now
        self.host.append(host_sample())
        for r in self.live.values():
            r.cancelled = True
        if self.prof is not None and self.prof_state != "off":
            self._sync()
            self.t_slice[1] = self.clock()
            self.prof.stop()
            self.prof_state = "done"
            _log(f"profiler stopped {self.t_slice[1] - self.t_close:.3f} s "
                 f"after the window's end, in "
                 f"{self.clock() - self.t_slice[1]:.3f} s")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def activities(self):
        from torch.profiler import ProfilerActivity
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return acts

    def init_profiler(self) -> None:
        """One throwaway profiler session in set-up: the tracer's first
        start in a process takes seconds, which inside the window would
        stall the engine and close the window on an empty slice."""
        from torch.profiler import profile
        t0 = self.clock()
        with profile(activities=self.activities()):
            x = torch.zeros(8, device=self.device)
            for _ in range(8):
                x.add_(1)
            self._sync()
        _log(f"profiler initialised in {self.clock() - t0:.3f} s")

    def _trace_poll(self, now: float) -> None:
        if self.trace_seconds is None:
            return
        if self.prof_state == "off" and \
                now >= self.t_close - self.trace_seconds:
            from torch.profiler import profile, schedule
            self.prof = profile(activities=self.activities(),
                                schedule=schedule(wait=0, warmup=1, active=1,
                                                  repeat=1))
            self.prof.start()
            self.prof_state = "warmup"
            _log(f"profiler warm-up at {now - self.t_open:.3f} s of the "
                 f"window, started in {self.clock() - now:.3f} s")
        elif self.prof_state == "warmup":
            self.prof.step()
            self.prof_state = "active"
            self.t_slice[0] = now
            _log(f"profiler active at {now - self.t_open:.3f} s of the "
                 f"window, stepped in {self.clock() - now:.3f} s")

    # -- what the window saw --------------------------------------------------
    def in_window(self, t: Optional[float]) -> bool:
        return t is not None and self.t_open <= t <= self.t_close


def trace_summary(prof, spans, kernels: Dict[str, tuple]) -> Dict:
    """Busy time, the window, the breakdown, and each of the family's
    ``kernels`` (``{key: (regex, bound_s, expected)}``): its calls, the
    calls its spans imply, its bound and its device time, read from the
    profiled slice."""
    from benchmarks import trace_reader
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = trace_reader.load_events(path)
    finally:
        os.remove(path)
    tr = trace_reader.read_trace(events, top=10, gaps=10)
    att = trace_reader.attribute(events, {k: re.compile(v[0])
                                          for k, v in kernels.items()})
    recs = {(r["kind"], r["idx"]): r for r in spans.records}
    out = {"busy_s": tr["busy_ms"] / 1e3, "window_s": tr["window_ms"] / 1e3,
           "breakdown": {
               "device_ops": [[k["name"][:NAME_CHARS], k["ms"] / 1e3]
                              for k in tr["top_kernels"]],
               "idle_gaps": [[g["op"] or "none", g["ms"] / 1e3]
                             for g in tr["gaps"]]}}
    for key, (_, bound_fn, expected_fn) in kernels.items():
        calls = bound = time_us = 0.0
        expected = 0
        for span, (n, us) in att[key].items():
            r = recs.get(span)
            if r is None:
                continue
            calls += n
            time_us += us
            bound += n * bound_fn(r)
            expected += expected_fn(r)
        out[key] = {"calls": int(calls), "expected": int(expected),
                    "bound_s": bound, "time_s": time_us / 1e6}
        if key == "parts" and calls and calls != expected:
            print(f"[bench] parts kernels in the trace: {int(calls)}, "
                  f"the spans' steps imply {expected}", file=sys.stderr)
    return out


def build_kernels() -> None:
    """Every CUDA source of the program built (on a checkout's first run)
    and found in ``build/torch_kernels/`` before the window: the engine
    builds a library at its first launch, and a wave that first takes
    the flash kernel inside the window would otherwise compile there."""
    from llmc_paged_tpu_torch.ops import _build
    names = sorted(f[:-3] for f in os.listdir(_build.CSRC)
                   if f.endswith(".cu"))
    t0 = time.monotonic()
    _build.build_all(names)
    _log(f"{len(names)} CUDA libraries ready in "
         f"{time.monotonic() - t0:.3f} s")


def host_sample() -> Dict[str, float]:
    """The host's side of a window, for the log: this process's CPU
    seconds, and the machine's CPU seconds stolen by the hypervisor
    (/proc/stat), where they can be read."""
    out = {"t": time.monotonic(), "cpu_s": time.process_time()}
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        out["steal_s"] = int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        pass
    return out


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device="cuda", registry: Optional[Registry] = None,
             t_process: Optional[float] = None,
             control: bool = False) -> Dict:
    """One run of ``workload`` (a name in ``bench["workloads"]``). Returns
    {"result": the result line's dict, "record": what the metrics read,
    "readings": the comparison's numbers (``control``: the control's
    too), "sample": the requests compared}."""
    t_process = time.monotonic() if t_process is None else t_process
    registry = registry or Registry()
    entry = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg = registry.config(entry["config"])
    mix = registry.mix(entry["traffic"])
    cell = registry.cell(workload)
    conc = int(cell["concurrency"])
    family = registry.family_of(cfg)
    dev = torch.device(device)

    def phase(what: str) -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        _log(f"set-up: {what} at {time.monotonic() - t_process:.3f} s")

    phase("imports and CUDA")
    if dev.type == "cuda":
        build_kernels()
    params32 = family.make_weights(cfg, seed, dev)
    phase("weights")
    engine = InferenceEngine(params32, family.program_config(cfg),
                             family.engine_config(cfg, conc), device=dev)
    del params32
    phase("engine")

    traffic = registry.traffic(mix["kind"]).Traffic(
        mix, cfg["vocab_size"], weights.seed64(seed), conc)
    loop = Loop(traffic, conc, seconds,
                int(round(mix["ramp_finished_per_slot"] * conc)), cfg, mix,
                cell["trace_seconds"] if trace else None, dev,
                registry=registry)
    spans = None
    if trace:
        loop.init_profiler()
        from benchmarks.spans import Spans
        spans = Spans(family.span_targets())
        spans.install()
    phase("the ramp starts")
    try:
        engine.run([], feed=loop.feed, on_finish=loop.on_finish,
                   on_tokens=loop.on_tokens)
    finally:
        if spans is not None:
            spans.remove()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
    else:
        peak = 0
    stats = dict(engine.stats)

    record = {"seconds": seconds, "t_open": loop.t_open,
              "t_close": loop.t_close, "setup_s": loop.t_open - t_process,
              "deliveries": loop.deliveries, "requests": loop.requests,
              "stats": stats, "concurrency": conc, "trace": None}
    if trace and loop.prof is not None and loop.prof_state == "done":
        record["trace"] = trace_summary(loop.prof, spans,
                                        family.kernels(cfg))
    loop.prof = None

    # the metrics this cell reports
    group = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench[group]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        value = registry.metric(m["name"]).compute(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # the comparison, on the program's state freed
    del engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    finished = [r for r in loop.requests
                if not r.cancelled and loop.in_window(r.t_done)]
    chk = mix["check"]
    reqs = check.sample(finished, seed, chk["served_values"],
                        chk["min_requests"], loop.score)
    with torch.no_grad(), full_f32():
        params32 = family.make_weights(cfg, seed, dev)
        reference = family.served_model(params32, cfg, family.REFERENCE)
        ctrl = family.served_model(params32, cfg, family.CONTROL) \
            if control else None
        del params32
        readings = check.compare(reference, reqs, loop.score, control=ctrl)
        del reference, ctrl
    ok, compared = check.verdict(readings["program"], cell["limits"])
    ok = ok and bool(reqs) and not loop.failed

    attempted = sum(1 for r in loop.requests if not r.cancelled)
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
                "count": 1, "memory_peak_bytes": int(peak)}
    if dev.type == "cuda":
        dev_info["power_limit"] = power_limit()
    result = {"correct": ok, "attempted": attempted,
              "failed": len(loop.failed), "metrics": metrics,
              "device": dev_info}
    _log(f"window {loop.t_open - t_process:.3f} to "
         f"{loop.t_close - t_process:.3f} s of the process, closed at "
         f"{loop.t_closed - t_process:.3f} s; {len(loop.requests)} "
         f"requests sent, {len(finished)} finished in the window")
    h0, h1 = loop.host
    _log("host over the window: " + ", ".join(
        f"{k} {(h1[k] - h0[k]) / (h1['t'] - h0['t']):.3f} a second"
        for k in h0 if k != "t") + f"; load {os.getloadavg()[0]:.2f}, "
        f"{os.cpu_count()} CPUs, {torch.get_num_threads()} intra-op threads")
    if record["trace"] is not None:
        dev_info["busy_s"] = record["trace"]["busy_s"]
        dev_info["window_s"] = record["trace"]["window_s"]
        result["breakdown"] = record["trace"]["breakdown"]
    result["compared"] = compared
    return {"result": result, "record": record, "readings": readings,
            "sample": reqs}
