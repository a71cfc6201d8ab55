"""kv/manager.PrefixCachingBlockManager of the port against the JAX
package's class: a seeded random sequence of match_prefix + adopt,
append_tokens (with cached-page reclaim and LRU eviction),
register_prompt, free_prompt and truncate_to through both, with tables,
holder sets, content keys, the cache and page metadata equal after every
operation; and the guards."""

import numpy as np
import pytest

from llmc_paged_tpu.kv.manager import PrefixCachingBlockManager as JMgr
from llmc_paged_tpu_torch.kv.manager import PrefixCachingBlockManager as TMgr

PS = 4


def _state(m):
    return (
        {k: list(v) for k, v in m.tables.items()},
        [sorted(h) for h in m.holders],
        list(m.hashes),
        dict(m.cache),
        [(p.prompt_id, p.filled, p.lru_counter) for p in m.pages],
        m.lru_epoch,
        m.num_free(),
        m.num_cached(),
    )


def _plain(x):
    """Results as plain values: each package has its own Segment class."""
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    if hasattr(x, "offset"):
        return (x.page, x.offset, x.count)
    return x


def _both(mgrs, name, *args):
    """Call ``name`` on both managers: equal results, or the same
    exception type from both."""
    out = []
    for m in mgrs:
        try:
            out.append(("ok", _plain(getattr(m, name)(*args))))
        except (ValueError, RuntimeError) as e:
            out.append((type(e).__name__, None))
    assert out[0] == out[1], (name, args, out)
    return out[0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_operations_equal_jax(seed):
    rng = np.random.default_rng(seed)
    mgrs = (JMgr(num_pages=14, page_size=PS, max_seqs=5),
            TMgr(num_pages=14, page_size=PS, max_seqs=5))
    heads = [rng.integers(0, 6, 9).tolist() for _ in range(3)]
    tokens = {}      # the test's view of each live sequence's content
    hits = evictions = 0
    for _ in range(400):
        pid = int(rng.integers(0, 5))
        op = rng.choice(["admit", "grow", "free", "truncate", "register"],
                        p=[0.3, 0.35, 0.15, 0.1, 0.1])
        if op == "admit" and not mgrs[1].tables.get(pid):
            toks = (heads[int(rng.integers(0, 3))][: int(rng.integers(1, 10))]
                    + rng.integers(0, 6, int(rng.integers(1, 7))).tolist())
            _, hit = _both(mgrs, "match_prefix", toks)
            hit = hit[: (len(toks) - 1) // PS]
            if hit:
                hits += 1
                _both(mgrs, "adopt", pid, hit)
            _, (segs, evicted) = _both(mgrs, "append_tokens", pid,
                                       len(toks) - len(hit) * PS)
            evictions += len(evicted)
            for v in evicted:
                tokens.pop(v, None)
            if segs:
                tokens[pid] = toks
                _both(mgrs, "register_prompt", pid, toks)
            else:
                _both(mgrs, "free_prompt", pid)
                tokens.pop(pid, None)
        elif op == "grow" and pid in tokens:
            n = int(rng.integers(1, 7))
            _, (segs, evicted) = _both(mgrs, "append_tokens", pid, n)
            evictions += len(evicted)
            for v in evicted:
                tokens.pop(v, None)
            if segs:
                tokens[pid] = tokens[pid] + rng.integers(0, 6, n).tolist()
            else:
                _both(mgrs, "free_prompt", pid)
                tokens.pop(pid, None)
        elif op == "free":
            _both(mgrs, "free_prompt", pid)
            tokens.pop(pid, None)
        elif op == "truncate" and pid in tokens:
            new_len = int(rng.integers(0, len(tokens[pid]) + 1))
            kind, _ = _both(mgrs, "truncate_to", pid, new_len)
            if kind == "ok":
                tokens[pid] = tokens[pid][:new_len]
        elif op == "register" and pid in tokens:
            _both(mgrs, "register_prompt", pid, tokens[pid])
        assert _state(mgrs[0]) == _state(mgrs[1])
        for p in tokens:
            _both(mgrs, "block_table_array", p, 12)
    assert hits > 10 and evictions > 0


def test_guards():
    m = TMgr(num_pages=8, page_size=PS, max_seqs=4)
    segs, _ = m.append_tokens(0, 9)
    assert segs
    assert m.register_prompt(0, list(range(9))) == 2
    hit = m.match_prefix(list(range(9)))
    assert len(hit) == 2
    m.adopt(1, hit)
    with pytest.raises(ValueError, match="non-empty"):
        m.adopt(1, hit)
    with pytest.raises(ValueError, match="not a published"):
        m.adopt(2, [m.tables[0][2]])           # the partial third page
    with pytest.raises(ValueError, match="invalid prompt"):
        m.adopt(7, hit)
    with pytest.raises(RuntimeError, match="sliding-window"):
        m.release_below(0, 4)
    # a shared (and cached) page may not be freed or shortened
    with pytest.raises(ValueError, match="shared/cached"):
        m.truncate_to(1, 4)
    with pytest.raises(ValueError, match="shared/cached"):
        m.truncate_to(0, 2)
    with pytest.raises(ValueError, match="outside"):
        m.truncate_to(0, 10)
    # an exclusive tail rolls back
    assert m.truncate_to(0, 8) == 1
    assert m.seq_len(0) == 8
    # the owner leaves: the shared pages stay with the adopter, then
    # demote to the cache when it leaves too
    m.free_prompt(0)
    assert m.holders[hit[0]] == {1}
    m.free_prompt(1)
    assert m.num_cached() == 2 and m.match_prefix(list(range(9))) == hit
