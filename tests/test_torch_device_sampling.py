"""Device sampling in the port (EngineConfig.device_sampling): decode
chunks draw on the device from a torch.Generator seeded with
EngineConfig.seed (the Gumbel-max trick under the temperature/top-k
transform), so a sampled batch chains. Not bit-parity with the JAX
package's jax.random draws, as JAX's device sampling is not with the
xorshift stream; the checks mirror the JAX package's tests: top_k=1
equals greedy, every token lies in its position's top-k support,
per-request overrides on device chunks, the same seed gives the same
stream, top_k >= V keeps the whole vocabulary. The draw itself is held
against the softmax of the filtered logits on many rows."""

import numpy as np
import pytest
import torch

from llmc_paged_tpu_torch import convert
from llmc_paged_tpu_torch.config import EngineConfig, PageConfig
from llmc_paged_tpu_torch.engine.engine import InferenceEngine
from llmc_paged_tpu_torch.engine.scheduler import Request
from llmc_paged_tpu_torch.kv.layouts import init_pool
from llmc_paged_tpu_torch.models import gpt2, gpt2_paged
from test_torch_common import one_thread  # noqa: F401
from test_torch_common import params_np, port_cfg

pytestmark = pytest.mark.usefixtures("one_thread")


def _prompts(n, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, int(ln)).tolist()
            for ln in rng.integers(3, 12, n)]


@pytest.fixture(scope="module")
def params():
    return convert.params_from_numpy(params_np(port_cfg(), seed=0),
                                     port_cfg(), device="cpu")


def _engine(params, **kw):
    page = PageConfig(page_size=8, num_pages=64, max_seqs=8, pages_per_seq=8)
    econf = EngineConfig(**{**dict(cache_mode="paged", page=page,
                                   greedy=True, max_batch=4,
                                   decode_chunk=4), **kw})
    return InferenceEngine(params, port_cfg(), econf, device="cpu")


def _run(eng, specs, new):
    done = eng.run([Request(rid=i, prompt=list(p), max_new_tokens=new, **kw)
                    for i, (p, kw) in enumerate(specs)])
    return {r.rid: r for r in done}


@pytest.fixture(scope="module")
def greedy_ref(params):
    prompts = _prompts(4)
    return prompts, _run(_engine(params), [(p, {}) for p in prompts], 12)


def test_topk1_equals_greedy(params, greedy_ref):
    """A sampled engine with top_k=1 reproduces the greedy streams, and
    its batch chains (no single-token step)."""
    prompts, ref = greedy_ref
    eng = _engine(params, greedy=False, top_k=1, device_sampling=True)
    done = _run(eng, [(p, {}) for p in prompts], 12)
    assert {r: d.tokens for r, d in done.items()} == \
        {r: d.tokens for r, d in ref.items()}
    assert eng.stats["single_steps"] == 0 < eng.stats["decode_steps"]


def test_sampled_batch_chains_only_with_device_sampling(params):
    prompts = _prompts(2)
    for ds in (False, True):
        eng = _engine(params, greedy=False, top_k=40, temperature=0.8,
                      device_sampling=ds)
        done = _run(eng, [(p, {}) for p in prompts], 9)
        assert all(len(r.generated) == 9 for r in done.values())
        st = eng.stats
        if ds:
            assert st["single_steps"] == 0 and st["decode_steps"] == 8
        else:
            assert st["single_steps"] == st["decode_steps"] == 8


def test_tokens_lie_in_the_topk_support(params):
    """Teacher-forced: each sampled token is among its position's top-3
    logits of a dense forward."""
    cfg = port_cfg()
    K = 3
    prompt = _prompts(1)[0]
    eng = _engine(params, greedy=False, top_k=K, device_sampling=True,
                  max_batch=1, decode_chunk=8, seed=7)
    toks = eng.generate(prompt, 16)
    assert len(toks) == len(prompt) + 16
    logits = gpt2.forward(params, torch.tensor([toks[:-1]],
                                               dtype=torch.int32),
                          cfg)[0].numpy()
    for pos in range(len(prompt) - 1, len(toks) - 1):
        assert toks[pos + 1] in set(np.argsort(logits[pos])[-K:].tolist())


def test_overrides_on_device_chunks(params, greedy_ref):
    """A greedy engine with device sampling: rows without overrides keep
    the greedy stream next to a sampled override row; a top_k=1 override
    row equals its greedy stream."""
    prompts, ref = greedy_ref
    eng = _engine(params, device_sampling=True)
    done = _run(eng, [(prompts[0], {}),
                      (prompts[1], dict(temperature=0.8, top_k=5,
                                        greedy=False)),
                      (prompts[2], dict(top_k=1, greedy=False)),
                      (prompts[3], {})], 12)
    for rid in (0, 2, 3):
        assert done[rid].tokens == ref[rid].tokens
    assert len(done[1].generated) == 12
    assert done[1].tokens != ref[1].tokens
    assert eng.stats["single_steps"] == 0


def test_same_seed_same_stream(params):
    prompts = _prompts(3)
    specs = [(p, dict(temperature=1.3)) for p in prompts]
    runs = [_run(_engine(params, greedy=False, device_sampling=True,
                         seed=s), specs, 12) for s in (11, 11, 12)]
    a, b, c = ({r: d.tokens for r, d in run.items()} for run in runs)
    assert a == b
    assert a != c
    # the engine reseeds at every run
    eng = _engine(params, greedy=False, device_sampling=True, seed=11)
    assert {r: d.tokens for r, d in _run(eng, specs, 12).items()} == a
    assert {r: d.tokens for r, d in _run(eng, specs, 12).items()} == a


def test_topk_full_vocab_means_no_filter(params):
    prompts = _prompts(2)
    eng = _engine(params, device_sampling=True)
    done = _run(eng, [(prompts[0], dict(greedy=False,
                                        top_k=port_cfg().vocab_size)),
                      (prompts[1], dict(greedy=False, top_k=5))], 8)
    assert all(len(r.generated) == 8 for r in done.values())


def _chunk_args(params, B=2):
    cfg = port_cfg()
    page = PageConfig(page_size=8, num_pages=8, max_seqs=B, pages_per_seq=4)
    pool = init_pool(cfg, page, dtype="float32", device="cpu")
    return dict(params=params, first_tokens=torch.tensor([5, 9][:B]),
                positions0=torch.zeros(B, dtype=torch.int32),
                pages=torch.tensor([[0, 4][:B]] * 2, dtype=torch.int32),
                slots=torch.arange(2, dtype=torch.int32)[:, None].repeat(1,
                                                                         B),
                block_tables=torch.arange(4 * B, dtype=torch.int32).reshape(
                    B, 4), pool=pool, cfg=cfg, num_steps=2,
                window=cfg.max_seq_len, use_kernel=False)


def test_chunk_refuses_temperature_zero_with_an_rng(params):
    with pytest.raises(ValueError, match="temperature=0"):
        gpt2_paged.decode_chunk_paged(**_chunk_args(params),
                                      rng=torch.Generator(), temperature=0)


def test_chunk_returns_the_jax_tuple(params):
    """(out[, counts][, logps], pool): counts before logprobs."""
    V = port_cfg().vocab_size
    res = gpt2_paged.decode_chunk_paged(
        **_chunk_args(params), rng=torch.Generator().manual_seed(0),
        top_k=4, temperature=torch.tensor([0.5, 2.0]),
        k_arr=torch.tensor([0, 3]), greedy_rows=torch.tensor([True, False]),
        want_logprobs=True, pen_counts=torch.zeros(2, V, dtype=torch.int32),
        freq_pen=torch.zeros(2), pres_pen=torch.zeros(2))
    assert len(res) == 4
    out, cnt, lps, _ = res
    assert out.shape == lps.shape == (2, 2) and cnt.shape == (2, V)
    assert int(cnt.sum()) == 4 and bool((lps <= 0).all())
    greedy = gpt2_paged.decode_chunk_paged(**_chunk_args(params))
    assert len(greedy) == 2
    assert out[:, 0].tolist() == greedy[0][:, 0].tolist()


def test_draw_follows_the_filtered_softmax():
    """The Gumbel-max draw under temperature 0.7 and a per-row top-k (cap
    4): the frequencies over 40000 rows match softmax(filtered logits /
    T), and ties at the k-th value stay in."""
    from llmc_paged_tpu_torch.models.gpt2_paged import _pick
    g = torch.Generator().manual_seed(3)
    base = torch.tensor([2.0, 1.0, 1.0, 0.5, 0.0, -1.0, -3.0, 0.25])
    N = 40000
    logits = base.repeat(N, 1)
    karr = torch.tensor([2, 0]).repeat(N // 2)
    out = _pick(logits, None, g, 4, torch.full((N,), 0.7), karr, None,
                None, None)
    for k, rows in ((2, out[0::2]), (0, out[1::2])):
        lg = base / 0.7
        if k:
            lg = torch.where(lg < torch.topk(lg, k).values[-1], -torch.inf,
                             lg)
        want = torch.softmax(lg, -1).numpy()
        got = np.bincount(rows.numpy(), minlength=8) / rows.numel()
        np.testing.assert_allclose(got, want, atol=0.012)
    # top-2 of [2, 1, 1, ...] keeps the tie at the second value: 3 tokens
    assert set(out[0::2].tolist()) == {0, 1, 2}
