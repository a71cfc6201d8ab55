"""The port's native block managers (csrc/block_manager.cpp, bound in
kv/native.py) against its Python managers and against the JAX package's
two: the reference scenarios of tests/test_block_manager.py, the
randomized equivalence of the plain and the prefix state machines, the
window release, one op sequence through all four managers, the engine
with native_manager True, False and None against the JAX engine, and
the host build (concurrent first use, a missing compiler)."""

import os
import random
import subprocess
import sys
import time

import numpy as np
import pytest

from llmc_paged_tpu.config import EngineConfig as JEngineConfig
from llmc_paged_tpu.config import PageConfig as JPageConfig
from llmc_paged_tpu.engine.engine import InferenceEngine as JEngine
from llmc_paged_tpu.engine.scheduler import Request as JRequest
from llmc_paged_tpu.kv import native as jnative
from llmc_paged_tpu.kv.manager import BlockManager as JBlockManager
from llmc_paged_tpu.kv.manager import PrefixCachingBlockManager as JPrefix
from llmc_paged_tpu_torch.config import EngineConfig as TEngineConfig
from llmc_paged_tpu_torch.config import PageConfig as TPageConfig
from llmc_paged_tpu_torch.engine.engine import InferenceEngine as TEngine
from llmc_paged_tpu_torch.engine.scheduler import Request as TRequest
from llmc_paged_tpu_torch.kv import native
from llmc_paged_tpu_torch.kv.manager import BlockManager, \
    PrefixCachingBlockManager
from llmc_paged_tpu_torch.ops import _build
from test_torch_common import jax_cfg, params_np, port_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---- full metadata of any of the four managers ------------------------------

def _meta(m, page):
    if hasattr(m, "page_meta"):
        return tuple(m.page_meta(page))
    pg = m.pages[page]                       # the JAX package's Python one
    return pg.prompt_id, pg.filled, pg.lru_counter


def _holders(m, page):
    h = m.holders
    return sorted(h[page]) if isinstance(h, list) else h(page)


def state(m, num_pages, prompts, probes=()):
    """Everything a manager shows: epoch, free pages, every page's
    metadata, every prompt's table, and for a prefix manager the holder
    sets, the cached count and the matches of ``probes``."""
    s = dict(epoch=m.lru_epoch, free=m.num_free(),
             meta=[_meta(m, p) for p in range(num_pages)],
             tables=[m.block_table(p) for p in range(prompts)])
    if hasattr(m, "match_prefix"):
        s.update(holders=[_holders(m, p) for p in range(num_pages)],
                 cached=m.num_cached(),
                 match=[m.match_prefix(t) for t in probes])
    return s


def _plain(x):
    """A result with the packages' Segment classes as (page, offset,
    count) tuples, so results of the two packages compare."""
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if hasattr(x, "offset"):
        return (x.page, x.offset, x.count)
    return x


class Lockstep:
    """Calls every method on each manager in turn; the results (or the
    exception types) must agree, and so must the full state afterwards.
    Returns the first manager's result, Segments as tuples."""

    def __init__(self, mgrs, num_pages, prompts, probes=()):
        self.mgrs, self.num_pages = mgrs, num_pages
        self.prompts, self.probes = prompts, probes
        self.ops = 0

    def check(self):
        first = state(self.mgrs[0], self.num_pages, self.prompts,
                      self.probes)
        for m in self.mgrs[1:]:
            assert state(m, self.num_pages, self.prompts,
                         self.probes) == first, (self.ops, type(m))

    @property
    def lru_epoch(self):
        return self.mgrs[0].lru_epoch        # equal in all: check() held

    def __getattr__(self, name):
        def call(*args):
            outs = []
            for m in self.mgrs:
                try:
                    outs.append(("ok", _plain(getattr(m, name)(*args))))
                except (ValueError, RuntimeError) as e:
                    outs.append(("err", type(e).__name__))
            assert all(o == outs[0] for o in outs), (name, args, outs)
            self.ops += 1
            self.check()
            if outs[0][0] == "err":
                raise {"ValueError": ValueError,
                       "RuntimeError": RuntimeError}[outs[0][1]](name)
            return outs[0][1]
        return call


def port_pair(num_pages, page_size, max_seqs, prefix=False):
    py = (PrefixCachingBlockManager if prefix else BlockManager)(
        num_pages, page_size, max_seqs)
    nat = native.make_block_manager(num_pages, page_size, max_seqs,
                                    native=True, prefix=prefix)
    assert isinstance(nat, native.NativeBlockManager)
    return [py, nat]


# ---- the reference scenarios (tests/test_block_manager.py) ------------------

def sc_unit(m):
    """block_manager_test.c: two blocks for prompt 0, the first filled,
    the second partly, then freed (pool 100 x 32)."""
    b0, ev = m.request_block(0)
    assert b0 == 0 and ev == []
    segs, _ = m.append_tokens(0, 32)
    assert segs == [(0, 0, 32)]
    b1, _ = m.request_block(0)
    assert b1 == 1
    segs, _ = m.append_tokens(0, 5)
    assert segs == [(1, 0, 5)]
    assert m.seq_len(0) == 37
    assert m.block_table(0) == [0, 1]
    m.free_prompt(0)
    assert m.block_table(0) == []
    assert m.num_free() == 100


def sc_spanning(m):
    segs, ev = m.append_tokens(1, 10)
    assert ev == []
    assert [(o, c) for _, o, c in segs] == [(0, 4), (0, 4), (0, 2)]
    assert m.seq_len(1) == 10 and len(m.block_table(1)) == 3
    segs, _ = m.append_tokens(1, 3)
    assert [(o, c) for _, o, c in segs] == [(2, 2), (0, 1)]
    assert m.seq_len(1) == 13


def sc_lru_evict(m):
    m.append_tokens(0, 4)
    m.append_tokens(1, 4)
    segs, ev = m.append_tokens(2, 2)
    assert ev == [0], "prompt 0 (LRU) should be evicted wholesale"
    assert m.block_table(0) == []
    assert len(segs) == 1 and segs[0][2] == 2
    assert sorted(m.block_table(1)) == [2, 3]


def sc_self_evict(m):
    m.append_tokens(0, 4)
    segs, ev = m.append_tokens(0, 1)
    assert ev == [0] and segs == []


def sc_lru_touch(m):
    m.append_tokens(0, 1)
    e1 = m.page_meta(0)[2]
    m.append_tokens(0, 1)
    assert m.page_meta(0)[2] == e1 + 1
    assert m.lru_epoch == e1 + 1


def sc_truncate(m):
    m.append_tokens(0, 11)
    m.append_tokens(1, 2)
    assert m.truncate_to(0, 11) == 0
    assert m.truncate_to(0, 6) == 1
    assert m.seq_len(0) == 6 and m.block_table(0) == [0, 1]
    segs, _ = m.append_tokens(0, 3)
    assert segs == \
        [(1, 2, 2), (2, 0, 1)]
    assert m.seq_len(1) == 2 and m.block_table(1) == [3]
    assert m.truncate_to(0, 4) == 2 and m.block_table(0) == [0]
    assert m.truncate_to(0, 0) == 1
    assert m.seq_len(0) == 0 and m.block_table(0) == []
    with pytest.raises(ValueError):
        m.truncate_to(0, 1)


# scenario: (function, (num_pages, page_size, max_seqs))
SCENARIOS = {
    "unit": (sc_unit, (100, 32, 100)),
    "spanning": (sc_spanning, (8, 4, 5)),
    "lru_evict": (sc_lru_evict, (4, 2, 5)),
    "self_evict": (sc_self_evict, (2, 2, 3)),
    "lru_touch": (sc_lru_touch, (4, 4, 100)),
    "truncate": (sc_truncate, (8, 4, 5)),
}


@pytest.mark.parametrize("prefix", [False, True], ids=["plain", "prefix"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_reference_scenarios_native_equals_python(scenario, prefix):
    """Each scenario's expectations hold on the native and the Python
    manager driven in lockstep, with the full state equal after every op
    (the prefix managers behave as the plain ones when nothing is
    shared)."""
    fn, (P, ps, S) = SCENARIOS[scenario]
    m = Lockstep(port_pair(P, ps, S, prefix), P, S)
    fn(m)
    assert m.ops > 0


def test_randomized_equivalence_plain():
    """tests/test_block_manager.py:128, same seed and steps."""
    m = Lockstep(port_pair(6, 3, 4), 6, 4)
    py = m.mgrs[0]
    rng = random.Random(1234)
    for _ in range(500):
        op = rng.random()
        prompt = rng.randrange(4)
        if op < 0.55:
            segs, _ = m.append_tokens(prompt, rng.randrange(1, 5))
            if not segs:
                m.free_prompt(prompt)
        elif op < 0.75:
            m.request_block(prompt)
        elif op < 0.9:
            m.truncate_to(prompt, rng.randrange(py.seq_len(prompt) + 1))
        else:
            m.free_prompt(prompt)
    assert m.ops >= 500


def test_randomized_equivalence_prefix():
    """tests/test_prefix_cache.py:146, same seed and steps: admissions
    with template prefixes (content collisions), appends, truncations,
    requests and frees; holders, cache and matches compared too."""
    rng = random.Random(99)
    templates = [[rng.randrange(50) for _ in range(24)] for _ in range(3)]
    m = Lockstep(port_pair(8, 4, 4, prefix=True), 8, 4, probes=templates)
    py = m.mgrs[0]
    for _ in range(600):
        op = rng.random()
        prompt = rng.randrange(4)
        if op < 0.35 and not py.block_table(prompt):
            content = list(templates[rng.randrange(3)][
                : rng.randrange(4, 24)]) + \
                [rng.randrange(50) for _ in range(rng.randrange(0, 5))]
            hit = m.match_prefix(content)[: max(0, (len(content) - 1) // 4)]
            if hit:
                m.adopt(prompt, hit)
            segs, _ = m.append_tokens(prompt, len(content) - len(hit) * 4)
            if not segs:
                m.free_prompt(prompt)
            else:
                m.register_prompt(prompt, content)
        elif op < 0.55 and py.block_table(prompt):
            segs, _ = m.append_tokens(prompt, rng.randrange(1, 6))
            if not segs:
                m.free_prompt(prompt)
        elif op < 0.7:
            with _maybe_refused():
                m.truncate_to(prompt, rng.randrange(py.seq_len(prompt) + 1))
        elif op < 0.8:
            m.request_block(prompt)
        else:
            m.free_prompt(prompt)
    assert py.num_cached() + sum(
        1 for pr in range(4) if py.block_table(pr)) > 0


class _maybe_refused:
    """A truncation the prefix managers may refuse (shared or cached
    page): Lockstep already checked that all refused alike."""

    def __enter__(self):
        return self

    def __exit__(self, typ, exc, tb):
        return typ is ValueError


def test_release_below_agrees():
    """tests/test_window_reclaim.py:45: tombstones, the forward-filled
    device row, and the refusal at seq_len."""
    m = Lockstep(port_pair(10, 4, 3), 10, 3)
    m.append_tokens(0, 10)
    m.append_tokens(1, 6)
    m.append_tokens(0, 3)
    for start in (4, 8, 12):
        m.release_below(0, start)
        rows = [x.block_table_array(0, 8) for x in m.mgrs]
        np.testing.assert_array_equal(rows[0], rows[1])
        assert m.mgrs[0].state_dump(0) == m.mgrs[1].state_dump(0)
    assert m.block_table(0)[:3] == [-1, -1, -1]
    for mgr in m.mgrs:
        with pytest.raises(ValueError, match="tail page"):
            mgr.release_below(0, 13)
        with pytest.raises(ValueError, match="pages_per_seq"):
            mgr.block_table_array(0, 3)


def test_block_table_grows_past_num_pages():
    """A window-reclaimed table holds more entries than the pool has
    pages: the native binding's reused buffer grows to take it."""
    m = Lockstep(port_pair(3, 2, 2), 3, 2)
    for n in range(12):
        m.append_tokens(0, 2)
        if n >= 1:
            m.release_below(0, 2 * n + 1)
    assert len(m.block_table(0)) == 12 > 3
    rows = [x.block_table_array(0, 16, fill=2) for x in m.mgrs]
    np.testing.assert_array_equal(rows[0], rows[1])


# ---- across the packages ----------------------------------------------------

def _jax_native(P, ps, S, prefix):
    """The JAX package's native manager. Its library builds with make
    into csrc/ on first use; a second test process may be rewriting it
    at that moment, so a load that fails is tried again."""
    for attempt in range(5):
        try:
            return jnative.make_block_manager(P, ps, S, native=True,
                                              prefix=prefix)
        except OSError:
            jnative._lib = None
            time.sleep(1.0 + attempt)
    return jnative.make_block_manager(P, ps, S, native=True, prefix=prefix)


@pytest.mark.parametrize("prefix", [False, True], ids=["plain", "prefix"])
def test_four_managers_one_sequence(prefix):
    """One random op sequence through the JAX package's native and Python
    managers and the port's: the full metadata (block tables included)
    equal after every op; state_dump equal between the port's managers
    and the JAX package's Python one."""
    P, ps, S = (10, 4, 4)
    rng = random.Random(7 if prefix else 5)
    templates = [[rng.randrange(30) for _ in range(20)] for _ in range(2)]
    jpy = (JPrefix if prefix else JBlockManager)(P, ps, S)
    mgrs = [jpy, _jax_native(P, ps, S, prefix)] + port_pair(P, ps, S, prefix)
    assert not isinstance(mgrs[1], JBlockManager)
    m = Lockstep(mgrs, P, S, probes=templates if prefix else ())
    for step in range(400):
        op = rng.random()
        prompt = rng.randrange(S)
        table = jpy.block_table(prompt)
        if prefix and op < 0.3 and not table:
            content = templates[rng.randrange(2)][: rng.randrange(4, 20)]
            hit = m.match_prefix(content)[: (len(content) - 1) // ps]
            if hit:
                m.adopt(prompt, hit)
            segs, _ = m.append_tokens(prompt, len(content) - len(hit) * ps)
            if segs:
                m.register_prompt(prompt, content)
            else:
                m.free_prompt(prompt)
        elif op < 0.6:
            segs, _ = m.append_tokens(prompt, rng.randrange(1, 7))
            if not segs:
                m.free_prompt(prompt)
        elif op < 0.7:
            m.request_block(prompt)
        elif op < 0.8 and not prefix and jpy.seq_len(prompt) > 0:
            m.release_below(prompt, rng.randrange(jpy.seq_len(prompt)))
        elif op < 0.9:
            # a length whose page is live (the Python managers refuse a
            # reclaimed one only after changing the table)
            cur = jpy.seq_len(prompt)
            ok = [n for n in range(cur + 1)
                  if n == 0 or table[-(-n // ps) - 1] >= 0]
            with _maybe_refused():
                m.truncate_to(prompt, rng.choice(ok))
        else:
            m.free_prompt(prompt)
        for pr in range(S):
            dump = jpy.state_dump(pr)
            assert mgrs[2].state_dump(pr) == dump, step
            assert mgrs[3].state_dump(pr) == dump, step
    assert m.ops >= 400


# ---- the engine -------------------------------------------------------------

SMALL = dict(vocab_size=32, num_heads=4, channels=32)
PREFIX_STATS = ("prefix_hit_tokens", "prefix_hit_pages",
                "prefix_pages_registered", "prefix_cached_pages")


@pytest.fixture(scope="module")
def weights():
    return params_np(port_cfg(**SMALL), seed=3)


def _prompts(kind):
    rng = np.random.default_rng(12)
    if kind == "repeat":
        segs = [rng.integers(0, 32, n).tolist() for n in (4, 5, 3, 6, 4)]
        return [(s * 8)[: 10 + 2 * i] for i, s in enumerate(segs)]
    if kind == "system":
        sys_prompt = rng.integers(0, 32, 24).tolist()
        return [sys_prompt + rng.integers(0, 32, n).tolist()
                for n in (5, 9, 3, 7, 6)]
    return [rng.integers(0, 32, n).tolist() for n in (5, 17, 9, 30, 3)]


# case: prompts, new tokens, runs, window, page/engine config
ENGINE_CASES = {
    "plain": dict(kind="mixed", new=12),
    "preempt": dict(kind="mixed", new=16, num_pages=6),
    "window": dict(kind="mixed", new=30, window=16),
    "spec": dict(kind="repeat", new=16, spec_k=4),
    "prefix": dict(kind="system", new=10, prefix=True, runs=2),
}


def _econf(mod_page, mod_engine, c):
    page = mod_page(page_size=8, num_pages=c.get("num_pages", 40),
                    max_seqs=8, pages_per_seq=10,
                    prefix_cache=c.get("prefix", False))
    return mod_engine(cache_mode="paged", page=page, greedy=True,
                      max_batch=3, decode_chunk=4, spec_k=c.get("spec_k", 0))


def _runs(eng, R, c):
    out = []
    for _ in range(c.get("runs", 1)):
        done = eng.run([R(rid=i, prompt=list(p), max_new_tokens=c["new"])
                        for i, p in enumerate(_prompts(c["kind"]))],
                       window=c.get("window"))
        st = eng.stats
        out.append(({r.rid: r.generated for r in done},
                    {k: st.get(k) for k in ("preemptions", "peak_pages_used",
                                            "decode_tokens")
                     + PREFIX_STATS}))
    return out


def _managers_of(eng):
    """The types of the managers ``eng`` serves on, one a run()."""
    kinds, real = [], eng._paged_state

    def paged_state():
        mgr, pool = real()
        kinds.append(type(mgr))
        return mgr, pool

    eng._paged_state = paged_state
    return kinds


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_native_manager_equal_jax(weights, case):
    """The port's engine with native_manager True, False and None gives
    the JAX engine's (native_manager=True) streams and statistics."""
    c = ENGINE_CASES[case]
    _jax_native(4, 4, 2, False)          # the JAX library, loaded once
    jeng = JEngine(weights, jax_cfg(**SMALL),
                   _econf(JPageConfig, JEngineConfig, c), use_kernel=False,
                   native_manager=True)
    want = _runs(jeng, JRequest, c)
    for flag in (True, False, None):
        eng = TEngine(weights, port_cfg(**SMALL),
                      _econf(TPageConfig, TEngineConfig, c), device="cpu",
                      native_manager=flag)
        kinds = _managers_of(eng)
        assert _runs(eng, TRequest, c) == want, flag
        assert len(kinds) == c.get("runs", 1) and all(
            issubclass(k, native.NativeBlockManager) == (flag is not False)
            for k in kinds), (flag, kinds)
    stats = want[-1][1]
    if case == "preempt":
        assert stats["preemptions"] > 0
    if case == "prefix":
        assert stats["prefix_hit_pages"] > 0


def test_engine_builds_native_managers_by_default(weights, monkeypatch):
    """native_manager=None goes through kv.native.make_block_manager with
    native=None, and the manager it returns is the native one."""
    made = []
    real = native.make_block_manager

    def spy(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]

    monkeypatch.setattr(native, "make_block_manager", spy)
    c = dict(ENGINE_CASES["plain"], prefix=True)
    eng = TEngine(weights, port_cfg(**SMALL),
                  _econf(TPageConfig, TEngineConfig, c), device="cpu")
    _runs(eng, TRequest, dict(c, runs=1))
    eng = TEngine(weights, port_cfg(**SMALL),
                  _econf(TPageConfig, TEngineConfig, ENGINE_CASES["plain"]),
                  device="cpu")
    _runs(eng, TRequest, ENGINE_CASES["plain"])
    assert [type(m) for m in made] == [
        native.NativePrefixCachingBlockManager, native.NativeBlockManager]


# ---- the build --------------------------------------------------------------

BUILD_ONE = """
import sys
from llmc_paged_tpu_torch.ops import _build
from llmc_paged_tpu_torch.kv import native
_build.BUILD_DIR = sys.argv[1]
m = native.make_block_manager(8, 4, 2, native=True)
segs, _ = m.append_tokens(1, 6)
assert [(s.page, s.count) for s in segs] == [(0, 4), (1, 2)]
print(_build.library_path("block_manager", host=True))
"""


def test_concurrent_first_use_builds_one_library(tmp_path):
    """Two processes that build at once: one library is left, no
    temporary file, and both load and use it."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("CXX", None)
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_ONE,
                               str(tmp_path)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    assert os.listdir(tmp_path) == [os.path.basename(paths.pop())]


def test_missing_compiler_falls_back(tmp_path, monkeypatch):
    """No library built and CXX naming a compiler that is not there:
    native=None gives the Python managers, native=True raises
    ImportError, native=False never builds."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    assert type(native.make_block_manager(8, 4, 2)) is BlockManager
    assert type(native.make_block_manager(8, 4, 2, prefix=True)) is \
        PrefixCachingBlockManager
    with pytest.raises(ImportError, match="no-such-g"):
        native.make_block_manager(8, 4, 2, native=True)
    with pytest.raises(ImportError):
        native.NativePrefixCachingBlockManager(8, 4, 2)
    assert type(native.make_block_manager(8, 4, 2, native=False)) is \
        BlockManager
    assert os.listdir(tmp_path) == []
    # an engine under the same conditions serves on the Python manager
    eng = TEngine(params_np(port_cfg(**SMALL), seed=3), port_cfg(**SMALL),
                  _econf(TPageConfig, TEngineConfig, ENGINE_CASES["plain"]),
                  device="cpu")
    done = eng.run([TRequest(rid=0, prompt=[1, 2, 3], max_new_tokens=3)])
    assert len(done[0].generated) == 3
    with pytest.raises(ImportError):
        TEngine(params_np(port_cfg(**SMALL), seed=3), port_cfg(**SMALL),
                _econf(TPageConfig, TEngineConfig, ENGINE_CASES["plain"]),
                device="cpu", native_manager=True).run(
            [TRequest(rid=0, prompt=[1, 2, 3], max_new_tokens=3)])


def test_state_dump_matches_jax_python():
    """state_dump, restored in the port's Python manager, is the JAX
    package's text, tombstones included."""
    a, b = JBlockManager(8, 4, 2), BlockManager(8, 4, 2)
    for mgr in (a, b):
        mgr.append_tokens(0, 14)
        mgr.release_below(0, 5)
    assert a.state_dump(0) == b.state_dump(0)
    assert "reclaimed" in b.state_dump(0)
    assert b.block_table(0) == a.block_table(0) == [-1, 1, 2, 3]

