"""The serving front over tensor-parallel ranks on the CPU: ServingEngine's
broadcast of the leader's arrivals, cancels and close (engine/server.py),
the HTTP front on the leader (engine/http_server.py), driven by
parallel/mp_dryrun.serve_run in four gloo rank processes (one
module-scoped RankPool, every case a task; TP 4 is {"model": 4}, TP 2 is
{"data": 2, "model": 2}, two replicas, each leader serving its own
clients).

The tiny fixture (L=4, NH=4, C=64), fp32, greedy. Served tokens equal
exactly the TP engine's run() of the same requests in the same pool,
the port's single-rank engine's and the JAX package's single-device
batch run (use_kernel=False); every rank of a model group ends in the
same state, as the engine's host decisions must be the same there.
"""

import os

import pytest

from llmc_paged_tpu import formats as JF
from llmc_paged_tpu.config import EngineConfig as JEngineConfig
from llmc_paged_tpu.config import PageConfig as JPageConfig
from llmc_paged_tpu.engine.engine import InferenceEngine as JEngine
from llmc_paged_tpu.engine.scheduler import Request as JRequest
from llmc_paged_tpu_torch.config import EngineConfig, GPT2Config, PageConfig
from llmc_paged_tpu_torch.engine.engine import InferenceEngine
from llmc_paged_tpu_torch.engine.scheduler import Request
from llmc_paged_tpu_torch.parallel.mp_dryrun import RankPool
from test_torch_common import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

SERVE = "llmc_paged_tpu_torch.parallel.mp_dryrun:serve_run"
MESHES = {2: {"data": 2, "model": 2}, 4: {"model": 4}}
TP = pytest.mark.parametrize("tp", sorted(MESHES))
PAGE = dict(page_size=8, num_pages=32, max_seqs=4, pages_per_seq=6)
ECONF = dict(cache_mode="paged", greedy=True, max_batch=2, decode_chunk=4)
GAP_S = 0.003           # between a leader's client arrivals


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    with RankPool(4, workdir=str(tmp_path_factory.mktemp("ranks")),
                  timeout_s=300) as pool:
        yield pool


@pytest.fixture(scope="module")
def golden(fixtures_dir):
    cfg_j, p = JF.read_checkpoint(os.path.join(fixtures_dir,
                                               "model_tiny.bin"))
    stream = JF.read_token_stream(os.path.join(fixtures_dir,
                                               "tokens_tiny.bin"))
    cfg_t = GPT2Config(cfg_j.max_seq_len, cfg_j.vocab_size,
                       cfg_j.num_layers, cfg_j.num_heads, cfg_j.channels)
    return cfg_j, cfg_t, p, stream


def _reqs(stream, new=(10, 14, 8, 12)):
    return [dict(rid=i, prompt=stream[i * 5: i * 10 + 5].tolist(),
                 max_new_tokens=n) for i, n in enumerate(new)]


def _econf(tp, **kw):
    return EngineConfig(page=PageConfig(**PAGE), mesh_shape=MESHES[tp],
                        **dict(ECONF, **kw))


def _groups(res, tp):
    """The ranks' results by model group."""
    return [res[g: g + tp] for g in range(0, len(res), tp)]


def _tokens(served):
    return {rid: r["tokens"] for rid, r in served.items()}


_RUNS = {}


def _staggered(ranks, golden, tp):
    """The staggered submit run of each mesh, served once for the cases
    that read it."""
    if tp not in _RUNS:
        _, cfg_t, p, stream = golden
        _RUNS[tp] = ranks.run(SERVE, p, cfg_t, _econf(tp), _reqs(stream),
                              gap_s=GAP_S)
    return _RUNS[tp]


@TP
def test_served_streams_equal_batch_runs(ranks, golden, tp):
    """Arrivals from a client thread on each leader, 3 ms apart: every
    future's tokens equal the TP engine's run() in the same pool, the
    port's single-rank engine's and JAX's single-device batch run."""
    cfg_j, cfg_t, p, stream = golden
    reqs = _reqs(stream)
    res = _staggered(ranks, golden, tp)
    jeng = JEngine(p, cfg_j, JEngineConfig(page=JPageConfig(**PAGE),
                                           **ECONF), use_kernel=False)
    want = {r.rid: list(r.tokens)
            for r in jeng.run([JRequest(**r) for r in reqs])}
    single = InferenceEngine(p, cfg_t, EngineConfig(
        page=PageConfig(**PAGE), **ECONF), device="cpu")
    assert {r.rid: list(r.tokens)
            for r in single.run([Request(**r) for r in reqs])} == want
    leaders = [r for r in res if r["leader"]]
    assert len(leaders) == 4 // tp
    for r in res:
        assert r["batch"] == want
    for r in leaders:
        assert _tokens(r["served"]) == want


@TP
def test_every_rank_ends_in_the_same_state(ranks, golden, tp):
    """After the drain every rank finished the same streams, none
    cancelled, with equal finished_total, decode_tokens and pages_free
    (all free again); within a model group also the same broadcasts (one
    a feed call), decode steps, kernel launches and collectives."""
    res = _staggered(ranks, golden, tp)
    want = res[0]["batch"]
    for r in res:
        assert r["finished"] == {rid: [t, False] for rid, t in want.items()}
        live = r["live"]
        assert live["finished_total"] == len(want)
        assert live["pages_free"] == PAGE["num_pages"]
        assert live["running"] == live["waiting"] == 0
        assert live["decode_tokens"] == res[0]["live"]["decode_tokens"]
    for group in _groups(res, tp):
        for r in group[1:]:
            for key in ("broadcasts", "decode_tokens", "preemptions"):
                assert r["live"][key] == group[0]["live"][key], key
            assert r["stats"]["decode_steps"] == \
                group[0]["stats"]["decode_steps"]
            assert r["launches"] == group[0]["launches"]
            assert r["collectives"] == group[0]["collectives"]
        assert group[0]["live"]["broadcasts"] >= 2


@TP
def test_follower_submit_raises_and_close_ends_every_loop(ranks, golden, tp):
    """submit on a follower raises, naming its leader; the leader's
    close() ends every rank's loop (each task returned, no loop alive)."""
    res = _staggered(ranks, golden, tp)
    for rank, r in enumerate(res):
        leader = rank - rank % tp
        assert r["leader"] == (rank == leader)
        if rank == leader:
            assert r["follower_error"] is None
        else:
            assert f"follows rank {leader}, the leader" in \
                r["follower_error"]
        assert r["alive"] is False


@TP
def test_served_streams_concatenate_to_the_batch_run(ranks, golden, tp):
    """submit_stream on the leader: each stream's batches concatenate to
    the batch run's tokens."""
    _, cfg_t, p, stream = golden
    res = ranks.run(SERVE, p, cfg_t, _econf(tp), _reqs(stream),
                    client="stream", gap_s=GAP_S)
    for r in res:
        if r["leader"]:
            assert _tokens(r["served"]) == r["batch"]


@TP
def test_cancels_free_the_same_pages_on_every_rank(ranks, golden, tp):
    """A running stream cancelled after its first batch is a prefix of
    its uncancelled stream; a request cancelled behind a full batch
    raises CancelledError; the third request runs to its end. Every rank
    of a group finishes the same requests with the same flags, and every
    rank frees every page."""
    _, cfg_t, p, stream = golden
    reqs = _reqs(stream, new=(30, 30, 30))
    res = ranks.run(SERVE, p, cfg_t, _econf(tp), reqs, gap_s=0.002,
                    cancel_running=0, cancel_queued=2)
    for r in res:
        assert r["live"]["pages_free"] == PAGE["num_pages"]
        assert r["live"]["finished_total"] == 3
        if r["leader"]:
            served, full = r["served"], r["batch"]
            run0 = served[0]
            assert run0["cancelled"]
            assert len(reqs[0]["prompt"]) < len(run0["tokens"]) < len(full[0])
            assert run0["tokens"] == full[0][: len(run0["tokens"])]
            assert served[1]["tokens"] == full[1]
            assert served[2] == dict(served[2], tokens=None, cancelled=True)
    for group in _groups(res, tp):
        for r in group[1:]:
            assert r["finished"] == group[0]["finished"]
            assert r["live"]["decode_tokens"] == \
                group[0]["live"]["decode_tokens"]
        fin = group[0]["finished"]
        assert fin[0][1] and fin[2][1] and not fin[1][1]


@TP
def test_http_front_on_the_leader(ranks, golden, tp):
    """HttpServingFront on each leader: 3 concurrent POSTs give the batch
    run's tokens; a logprobs request, which the TP engine refuses, gets
    400."""
    _, cfg_t, p, stream = golden
    res = ranks.run(SERVE, p, cfg_t, _econf(tp), _reqs(stream)[:3],
                    client="http",
                    bad=[dict(prompt=[1, 2, 3], max_new_tokens=4,
                              logprobs=True)])
    for r in res:
        if r["leader"]:
            assert _tokens(r["served"]) == r["batch"]
            assert r["bad"] == [400]
        else:
            assert r["served"] == {} and r["bad"] == []


@TP
def test_device_sampling_topk1_served_equals_greedy(ranks, golden, tp):
    """Device sampling at top_k=1, served: the greedy streams (every rank
    seeds its generator alike and draws from the same gathered
    logits)."""
    _, cfg_t, p, stream = golden
    res = ranks.run(SERVE, p, cfg_t,
                    _econf(tp, greedy=False, top_k=1, device_sampling=True),
                    _reqs(stream), gap_s=GAP_S, batch=False)
    want = _staggered(ranks, golden, tp)[0]["batch"]
    for r in res:
        assert {rid: f[0] for rid, f in r["finished"].items()} == want
        if r["leader"]:
            assert _tokens(r["served"]) == want
