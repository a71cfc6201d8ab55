"""kv/ of the port against the JAX package, bit for bit: pool coordinates,
prompt-page writes, token writes and the chunk commit (drop sentinels
included), and the host BlockManager under randomized op sequences."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_paged_tpu.kv import layouts as J
from llmc_paged_tpu.kv.manager import BlockManager as JBlockManager
from llmc_paged_tpu_torch.kv import layouts as T
from llmc_paged_tpu_torch.kv.manager import BlockManager as TBlockManager

P, NH, HS, PS = 12, 2, 64, 8


def _pool(rng, dtype):
    """Random (P, NH, HS, ps) pool in both frameworks (same values)."""
    if dtype == "int8":
        k = rng.integers(-127, 128, (P, NH, HS, PS)).astype(np.int8)
        s = rng.uniform(0.01, 0.1, (P, NH, PS)).astype(np.float32)
        return k, s
    return rng.standard_normal((P, NH, HS, PS)).astype(np.float32), None


def _jt(a, dtype="float32"):
    """numpy → (jax array, torch tensor) of the same values."""
    if dtype == "bfloat16":
        t = torch.from_numpy(a).to(torch.bfloat16)
        return jnp.asarray(t.float().numpy(), jnp.bfloat16), t
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _eq(j, t):
    jn = np.asarray(j.astype(jnp.float32) if j.dtype == jnp.bfloat16 else j)
    tn = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    np.testing.assert_array_equal(tn, jn)


def test_token_coords_and_prompt_page_ids():
    rng = np.random.default_rng(0)
    tables = rng.integers(0, P, (3, 4)).astype(np.int32)
    pos = np.array([[0, 7, 8, 31, 32, 40, -1],
                    [3, 9, 16, 17, 24, 25, 26],
                    [5, 6, 7, 8, 9, 10, 11]], np.int32)
    valid = np.ones_like(pos, bool)
    valid[2, 4:] = False
    jp, js = J.token_coords(jnp.asarray(tables), jnp.asarray(pos), PS,
                            jnp.asarray(valid), P)
    tp, ts = T.token_coords(torch.from_numpy(tables), torch.from_numpy(pos),
                            PS, torch.from_numpy(valid), P)
    _eq(jp, tp)
    _eq(js, ts)
    assert tp.dtype == ts.dtype == torch.int32
    assert (tp[0, 4:] == P).all() and tp[0, 6] == P   # beyond table / < 0
    for T_ in (7, 16, 3):
        _eq(J.prompt_page_ids(jp[:, :T_], T_, PS, P) if T_ <= 7 else
            J.prompt_page_ids(jnp.pad(jp, ((0, 0), (0, T_ - 7)),
                                      constant_values=P), T_, PS, P),
            T.prompt_page_ids(tp[:, :T_] if T_ <= 7 else
                              torch.nn.functional.pad(tp, (0, T_ - 7),
                                                      value=P), T_, PS, P))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_write_prompt_pages(dtype):
    rng = np.random.default_rng(1)
    B, Tp = 3, 2 * PS
    k = rng.standard_normal((B, Tp, NH, HS)).astype(np.float32)
    v = rng.standard_normal((B, Tp, NH, HS)).astype(np.float32)
    k[1, 3] = 0.0                                # a zero row quantizes too
    ids = np.array([[4, 7], [0, P], [P, P]], np.int32)   # sentinels drop
    kd = "bfloat16" if dtype == "bfloat16" else "float32"
    (jk, tk), (jv, tv) = _jt(k, kd), _jt(v, kd)
    if dtype == "int8":
        pk, sk = _pool(rng, "int8")
        pv, sv = _pool(rng, "int8")
        jpool = tuple(jnp.asarray(a) for a in (pk, pv, sk, sv))
        tpool = tuple(torch.from_numpy(a.copy()) for a in (pk, pv, sk, sv))
        jout = J.write_prompt_pages_quant(jpool, jk, jv, jnp.asarray(ids))
        tout = T.write_prompt_pages_quant(tpool, tk, tv, torch.from_numpy(ids))
    else:
        pk, _ = _pool(rng, "float32")
        pv, _ = _pool(rng, "float32")
        (jpk, tpk), (jpv, tpv) = _jt(pk, dtype), _jt(pv, dtype)
        jout = J.write_prompt_pages(jpk, jpv, jk, jv, jnp.asarray(ids))
        tout = T.write_prompt_pages(tpk, tpv, tk, tv, torch.from_numpy(ids))
    for j, t in zip(jout, tout):
        _eq(j, t)


def _chunk_coords(K, B, ln0, num_pages):
    """(K, B) commit coordinates as the engine reserves them: each column
    fills slots in order across its pages; column 2 stops early (trailing
    sentinels) and column 3 is inactive."""
    pages = np.full((K, B), num_pages, np.int32)
    slots = np.zeros((K, B), np.int32)
    owned = {0: [1, 5, 9], 1: [2, 3, 11], 2: [6, 0, 10]}
    for b, ln in enumerate(ln0):
        if b not in owned:
            continue
        steps = K if b != 2 else K - 3
        for j in range(steps):
            p = ln + j
            pages[j, b] = owned[b][p // PS]
            slots[j, b] = p % PS
    return pages, slots


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("K", [4, 11])
def test_commit_layer_kv(dtype, K):
    """The direct indexed write lands the same values as the JAX
    package's one-hot page blend, sentinel rows included."""
    rng = np.random.default_rng(2 + K)
    B = 4
    pages, slots = _chunk_coords(K, B, [3, 8, 6, 0], P)
    td = "bfloat16" if dtype == "bfloat16" else "float32"
    tk = rng.standard_normal((K, B, NH, HS)).astype(np.float32)
    tv = rng.standard_normal((K, B, NH, HS)).astype(np.float32)
    (jtk, ttk), (jtv, ttv) = _jt(tk, td), _jt(tv, td)
    jpg, jsl = jnp.asarray(pages), jnp.asarray(slots)
    tpg, tsl = torch.from_numpy(pages), torch.from_numpy(slots)
    if dtype == "int8":
        pk, sk = _pool(rng, "int8")
        pv, sv = _pool(rng, "int8")
        jpool = tuple(jnp.asarray(a) for a in (pk, pv, sk, sv))
        tpool = tuple(torch.from_numpy(a.copy()) for a in (pk, pv, sk, sv))
        jout = J.commit_layer_kv_quant(jpool, jtk, jtv, jpg, jsl)
        tout = T.commit_layer_kv_quant(tpool, ttk, ttv, tpg, tsl)
    else:
        pk, _ = _pool(rng, "float32")
        pv, _ = _pool(rng, "float32")
        (jpk, tpk), (jpv, tpv) = _jt(pk, dtype), _jt(pv, dtype)
        jout = J.commit_layer_kv(jpk, jpv, jtk, jtv, jpg, jsl)
        tout = T.commit_layer_kv(tpk, tpv, ttk, ttv, tpg, tsl)
    for j, t in zip(jout, tout):
        _eq(j, t)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_write_layer_kv(dtype):
    rng = np.random.default_rng(3)
    N = 6
    k = rng.standard_normal((N, NH, HS)).astype(np.float32)
    v = rng.standard_normal((N, NH, HS)).astype(np.float32)
    page = np.array([3, P, 0, 7, P, 11], np.int32)
    slot = np.array([0, 5, 7, 2, 1, 3], np.int32)
    args = (jnp.asarray(k), jnp.asarray(v), jnp.asarray(page),
            jnp.asarray(slot))
    targs = (torch.from_numpy(k), torch.from_numpy(v),
             torch.from_numpy(page), torch.from_numpy(slot))
    pk, sk = _pool(rng, dtype)
    pv, sv = _pool(rng, dtype)
    if dtype == "int8":
        jout = J.write_layer_kv_quant(
            tuple(jnp.asarray(a) for a in (pk, pv, sk, sv)), *args)
        tout = T.write_layer_kv_quant(
            tuple(torch.from_numpy(a.copy()) for a in (pk, pv, sk, sv)),
            *targs)
    else:
        jout = J.write_layer_kv(jnp.asarray(pk), jnp.asarray(pv), *args)
        tout = T.write_layer_kv(torch.from_numpy(pk.copy()),
                                torch.from_numpy(pv.copy()), *targs)
    for j, t in zip(jout, tout):
        _eq(j, t)


def test_quantize_dequant_gather():
    rng = np.random.default_rng(4)
    pages, _ = _pool(rng, "float32")
    jq, js = J.quantize_pages(jnp.asarray(pages))
    tq, ts = T.quantize_pages(torch.from_numpy(pages))
    _eq(jq, tq)
    _eq(js, ts)
    _eq(J.dequant_layer(jq, js), T.dequant_layer(tq, ts))
    tables = rng.integers(0, P, (3, 4)).astype(np.int32)
    jk, jv = J.gather_layer_kv(jnp.asarray(pages), jnp.asarray(pages[::-1]),
                               jnp.asarray(tables))
    tk, tv = T.gather_layer_kv(torch.from_numpy(pages),
                               torch.from_numpy(pages[::-1].copy()),
                               torch.from_numpy(tables))
    _eq(jk, tk)
    _eq(jv, tv)


def test_init_pool_shapes():
    from test_torch_common import port_cfg
    from llmc_paged_tpu_torch.config import PageConfig
    cfg = port_cfg()
    page = PageConfig(page_size=PS, num_pages=P)
    pool = T.init_pool(cfg, page, "int8", device="cpu")
    assert isinstance(pool, T.QuantPagePool)
    assert pool.num_layers == cfg.num_layers and pool.num_pages == P
    assert pool.page_size == PS
    assert pool.k[0].shape == (P, cfg.num_heads, cfg.head_dim, PS)
    assert pool.k_scale[0].shape == (P, cfg.num_heads, PS)
    assert bool((pool.k_scale[0] == 1).all())
    fpool = T.init_pool(cfg, page, "bfloat16", device="cpu")
    assert fpool.k[1].dtype == torch.bfloat16 and len(fpool.layer(0)) == 2


def test_init_pool_defaults_to_the_card():
    """init_pool without a device puts the pool on the card, and raises
    where there is none (no silent CPU pool)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from test_torch_common import port_cfg
    from llmc_paged_tpu_torch.config import PageConfig
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_pool(port_cfg(), PageConfig(page_size=PS, num_pages=P))


def _state(m):
    return ([(p.prompt_id, p.filled, p.lru_counter) for p in m.pages],
            {k: list(v) for k, v in m.tables.items()}, m.lru_epoch)


@pytest.mark.parametrize("seed", range(4))
def test_block_manager_randomized_equal(seed):
    """Random append / free / release_below / truncate_to sequences leave
    the port's manager in the JAX package's manager's exact state."""
    rng = np.random.default_rng(seed)
    jm, tm = JBlockManager(10, 4, 6), TBlockManager(10, 4, 6)
    for _ in range(300):
        pid = int(rng.integers(0, 6))
        op = rng.choice(["append", "append", "append", "free", "release",
                         "truncate", "table"])
        n, at = int(rng.integers(1, 9)), int(rng.integers(0, 20))
        results = []
        for m in (jm, tm):
            try:
                if op == "append":
                    r = m.append_tokens(pid, n)
                    r = ([(s.page, s.offset, s.count) for s in r[0]], r[1])
                elif op == "free":
                    r = m.free_prompt(pid)
                elif op == "release":
                    r = m.release_below(pid, at)
                elif op == "truncate":
                    r = m.truncate_to(pid, at)
                else:
                    r = m.block_table_array(pid, 8, fill=0).tolist()
            except (ValueError, RuntimeError, AssertionError) as e:
                r = type(e).__name__
            results.append(r)
        assert results[0] == results[1], (op, results)
        assert _state(jm) == _state(tm)
        assert jm.num_free() == tm.num_free()
        assert jm.seq_len(pid) == tm.seq_len(pid)
