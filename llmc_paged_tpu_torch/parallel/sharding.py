"""Tensor parallelism over heads and data parallelism over
torch.distributed (port of llmc_paged_tpu/parallel/sharding.py).

Multi-controller SPMD in PyTorch's idiom: one OS process per rank, each
with its own device (a card, or the CPU). Every rank runs the same host
schedule: the engine's scheduler, block manager and block tables are
host state that evolves identically on every rank, as the JAX package's
multi-process path relies on (its ``mp_dryrun.py`` docstring). Process
groups over ``torch.distributed`` take the place of ``shard_map``, and
``dist.all_reduce`` / ``dist.all_gather`` that of ``psum`` /
``all_gather``.

Tensor parallelism (TP) over the attention heads, Megatron style: a rank
of the mesh's "model" axis holds NH/m heads of qkv and attproj, 4C/m of
the MLP, Vp/m rows of the vocab-sharded wte, and a KV pool of its own
NH/m heads, so the paged-attention kernels run unchanged on the local
heads. A layer takes two all-reduces (after attproj and after fcproj);
the embedding one more, the logits one all-gather. The row-parallel
linears (attproj, fcproj: their input features split over the ranks)
sum f32 partial products and then round, scale and add the bias once,
as the one-device linear does after its single f32 accumulation: TP and
one device then differ only in the order of f32 additions, also in bf16
(a bf16 partial product rounded on each rank before the sum would not).

Data parallelism (DP) for training: a rank of the "data" axis takes its
rows of the global batch; one all-reduce a step averages the flat
gradients (and the loss) over the data group before AdamW runs on every
rank, the reference's DDP pattern (train_gpt2.py:400-428, 519-521).

Device layout (the JAX package's, :16-21): the checkpoint packs qkv as
(3C, C) rows, so ``relayout_tp`` re-lays qkvw to (L, 3, NH, HS, C), qkvb
to (L, 3, NH, HS) and attprojw to (L, C, NH, HS), and pads wte with zero
rows to ``padded_vocab_size`` so that the vocab splits evenly; each rank
keeps its contiguous slice of every split leaf (``TP_PARAM_SPECS``).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from llmc_paged_tpu_torch import resolve_device
from llmc_paged_tpu_torch.config import GPT2Config, PageConfig
from llmc_paged_tpu_torch.kv.layouts import init_pool
from llmc_paged_tpu_torch.models import gpt2, gpt2_paged
from llmc_paged_tpu_torch.ops import layers as L
from llmc_paged_tpu_torch.ops.int8 import (
    int8_linear,
    int8_product,
    quantize_rows,
)

# collectives issued by the TP forward, by kind (plain ints; reset by
# callers, like the kernels' LAUNCHES)
COLLECTIVES = {"all_reduce": 0, "all_gather": 0}

# the timeout of a host group's collectives: a serving leader whose
# follower died fails its requests after this long instead of waiting
# for ever; an idle leader broadcasts every 20 ms, far inside it
HOST_TIMEOUT_S = 120.0


def require_group(what: str, ranks: int) -> None:
    """Raise, naming torchrun and init_distributed, unless this process
    is in an initialized process group of ``ranks`` ranks."""
    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() == ranks):
        raise RuntimeError(
            f"{what} needs an initialized torch.distributed process group "
            f"of {ranks} ranks: start one process a rank with torchrun "
            f"(torchrun --nproc-per-node {ranks} -m <module> ...) or call "
            "llmc_paged_tpu_torch.parallel.init_distributed in each")


def local_rank() -> int:
    """This process's rank on its host (torchrun's LOCAL_RANK; 0 when
    unset)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def init_distributed(backend: str, init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     timeout_s: Optional[float] = None) -> None:
    """Join this process to the default process group (the NCCL
    ``init_process_group`` of the reference, train_gpt2.py:400-408).

    ``backend`` is stated, never guessed: "nccl" when each rank has a
    card of its own, "gloo" on the CPU and for ranks that share a card.
    With no other argument it reads torchrun's environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT through ``env://``); under NCCL
    the rank's card is ``cuda:LOCAL_RANK``. A no-op if the group is
    already initialized."""
    if dist.is_initialized():
        return
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        rank=-1 if rank is None else rank,
        world_size=-1 if world_size is None else world_size, **kw)


def join_ranks(parser, flag: str, n: int, device, module: str) -> int:
    """A CLI's ``flag N``: join the process group of N ranks from
    torchrun's environment (a lone process makes its own group of 1),
    over gloo on the CPU (``device`` "cpu") and NCCL on the cards;
    returns this rank. Exits through ``parser.error`` (code 2), naming
    the torchrun command, when the process is not one of N ranks."""
    world = os.environ.get("WORLD_SIZE")
    if (world is None and n > 1) or (world is not None and int(world) != n):
        parser.error(
            f"{flag} {n} runs one process a rank (WORLD_SIZE={world}): "
            f"start it with torchrun --nproc-per-node {n} -m {module} ... "
            f"{flag} {n}")
    backend = "gloo" if device == "cpu" else "nccl"
    if world is None:
        init_distributed(backend, "file://" + os.path.join(
            tempfile.mkdtemp(), "rendezvous"), rank=0, world_size=1)
    else:
        init_distributed(backend)
    return dist.get_rank()


class Mesh:
    """The (data, model) grid of global ranks, laid out as the JAX
    package's ``make_mesh`` lays out devices (:83), with this rank's place
    in it and the process group of its row (``model_group``, the TP axis)
    and of its column (``data_group``, the DP axis). ``host_group`` is a
    gloo group of the row's ranks, for host messages (the serving
    front's broadcasts; under NCCL the model group's would need device
    tensors), and ``leader`` the row's rank with model_rank 0. A mesh
    from ``Mesh.local`` has no groups: it serves the layout functions,
    and a collective over more than one rank raises."""

    def __init__(self, grid, rank: int, model_group=None, data_group=None,
                 host_group=None):
        self.grid = np.asarray(grid)
        self.data_size, self.model_size = self.grid.shape
        where = np.argwhere(self.grid == rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} is not in the mesh {self.grid}")
        self.rank = rank
        self.data_rank, self.model_rank = (int(i) for i in where[0])
        self.model_group = model_group
        self.data_group = data_group
        self.host_group = host_group
        self.leader = int(self.grid[self.data_rank, 0])

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data_size, "model": self.model_size}

    @classmethod
    def local(cls, model_rank: int = 0, model_size: int = 1,
              data_rank: int = 0, data_size: int = 1) -> "Mesh":
        """A mesh with no process group, for the layout functions."""
        grid = np.arange(data_size * model_size).reshape(data_size,
                                                         model_size)
        return cls(grid, int(grid[data_rank, model_rank]))


# meshes already built over the current default group, by (model, data):
# a group is created once and reused by every engine of the process
_MESHES: Dict[tuple, Mesh] = {}


def make_mesh(model: int = 1, data: int = 1) -> Mesh:
    """The mesh of ``data`` x ``model`` ranks over the default process
    group, which must have exactly that many ranks. Every rank creates
    every group, in the same order (a rank that skipped one would hang
    the next collective): each row's model group and its gloo host group
    (``HOST_TIMEOUT_S``), then each column's data group. A mesh is built
    once a group."""
    require_group(f"a mesh of data={data} x model={model}", model * data)
    world = dist.group.WORLD
    hit = _MESHES.get((model, data))
    if hit is not None and hit.world is world:
        return hit
    grid = np.arange(model * data).reshape(data, model)
    rank = dist.get_rank()
    model_group = data_group = host_group = None
    host_timeout = datetime.timedelta(seconds=HOST_TIMEOUT_S)
    for row in grid:
        g = dist.new_group(row.tolist())
        h = dist.new_group(row.tolist(), timeout=host_timeout,
                           backend="gloo")
        if rank in row:
            model_group, host_group = g, h
    for col in grid.T:
        g = dist.new_group(col.tolist())
        if rank in col:
            data_group = g
    mesh = Mesh(grid, rank, model_group, data_group, host_group)
    mesh.world = world
    _MESHES[(model, data)] = mesh
    return mesh


# ---- the layout ---------------------------------------------------------------

# The axis of each leaf that splits over the mesh's "model" axis in the TP
# device layout (None: every rank holds the whole leaf), JAX's
# PartitionSpecs (:88-112). INT8 per-output-row scales follow their
# weight's OUTPUT rows: rows on a split output axis split with it; rows of
# a row-parallel (all-reduced) product stay whole, since the scale
# multiplies the summed product.
TP_PARAM_SPECS: Dict[str, Optional[int]] = {
    "wte": 0,                      # (Vp, C), vocab-sharded
    "wpe": None,
    "ln1w": None, "ln1b": None,
    "qkvw": 2,                     # (L, 3, NH, HS, C)
    "qkvb": 2,                     # (L, 3, NH, HS)
    "attprojw": 2,                 # (L, C, NH, HS)
    "attprojb": None,
    "ln2w": None, "ln2b": None,
    "fcw": 1,                      # (L, 4C, C): 4C split
    "fcb": 1,
    "fcprojw": 2,                  # (L, C, 4C)
    "fcprojb": None,
    "lnfw": None, "lnfb": None,
    "wte_scale": 0,                # (Vp,)
    "qkvw_scale": 2,               # (L, 3, NH, HS)
    "attprojw_scale": None,        # (L, C)
    "fcw_scale": 1,                # (L, 4C)
    "fcprojw_scale": None,         # (L, C)
}


def relayout_tp(params: Dict[str, torch.Tensor], cfg: GPT2Config
                ) -> Dict[str, torch.Tensor]:
    """The port's device layout (wte V rows) → the TP device layout
    (module docstring): qkv and attproj split by head, wte padded with
    zero rows to ``padded_vocab_size``."""
    Lc, C, NH, HS = (cfg.num_layers, cfg.channels, cfg.num_heads,
                     cfg.head_dim)
    out = dict(params)
    out["qkvw"] = params["qkvw"].reshape(Lc, 3, NH, HS, C)
    out["qkvb"] = params["qkvb"].reshape(Lc, 3, NH, HS)
    out["attprojw"] = params["attprojw"].reshape(Lc, C, NH, HS)
    wte = params["wte"][: cfg.vocab_size]
    pad = cfg.padded_vocab_size - wte.shape[0]
    out["wte"] = torch.cat([wte, wte.new_zeros((pad, C))]) if pad else wte
    return out


def quantize_tp(tp: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per-output-row INT8 quantization of a TP-layout dict (the TP twin
    of ``ops.int8.quantize_params``). The rows are each matmul's output
    rows, so shards and scales partition together; the quantized VALUES
    equal the single-device quantizer's (the relayout reshapes never mix
    a row's elements; JAX :158-160), so int8 TP and int8 on one device
    differ only in the order of the all-reduced sums."""
    def q(w, row_ndim):
        wq, s = quantize_rows(w.reshape(*w.shape[:row_ndim], -1))
        return wq.reshape(w.shape), s

    out = dict(tp)
    out["qkvw"], out["qkvw_scale"] = q(tp["qkvw"], 4)       # (L,3,NH,HS,C)
    out["attprojw"], out["attprojw_scale"] = q(tp["attprojw"], 2)
    out["fcw"], out["fcw_scale"] = q(tp["fcw"], 2)
    out["fcprojw"], out["fcprojw_scale"] = q(tp["fcprojw"], 2)
    out["wte"], out["wte_scale"] = q(tp["wte"], 1)
    return out


def _shard(t: torch.Tensor, axis: Optional[int], mesh: Mesh) -> torch.Tensor:
    if axis is None:
        return t.contiguous()
    n = t.shape[axis] // mesh.model_size
    return t.narrow(axis, mesh.model_rank * n, n).contiguous()


def prepare_tp_params(params_np, cfg: GPT2Config, mesh: Mesh,
                      param_dtype: str = "float32",
                      activation_dtype: str = "float32", device=None
                      ) -> Dict[str, torch.Tensor]:
    """This rank's shard of a FLOAT parameter dict (numpy arrays, as the
    JAX package and ``formats.read_checkpoint`` hold them, or tensors):
    cast as ``convert.params_from_numpy`` casts them, re-laid out,
    quantized for ``param_dtype="int8"`` (layernorms, biases and wpe stay
    float, in ``activation_dtype``), cut to the rank's slice of each
    split leaf, all on the host, and only that slice placed on
    ``device`` (the card by default), contiguous. ``param_dtype``:
    "float32" (parity), "bfloat16" or "int8"."""
    _check_divides(cfg, mesh)
    if param_dtype == "bfloat16":
        dtype = torch.bfloat16
    elif param_dtype == "int8":
        dtype = {"float32": torch.float32,
                 "bfloat16": torch.bfloat16}[activation_dtype]
    else:
        dtype = torch.float32
    device = resolve_device(device)
    host = gpt2.to_device(params_np, cfg, dtype, "cpu")
    if param_dtype == "int8" and any(v.dtype == torch.int8
                                     for v in host.values()):
        raise ValueError("prepare_tp_params needs FLOAT params for int8 "
                         "TP serving (it quantizes in the TP layout "
                         "itself)")
    tp = relayout_tp(host, cfg)
    del host
    if param_dtype == "int8":
        tp = quantize_tp(tp)
    return {k: _shard(v, TP_PARAM_SPECS[k], mesh).to(device)
            for k, v in tp.items()}


def init_tp_pool(cfg: GPT2Config, page: PageConfig, mesh: Mesh,
                 dtype="float32", device=None):
    """This rank's KV pool: pages (P, NH/m, HS, ps) and int8 scales
    (P, NH/m, ps), allocated whole on the rank (a head slice of a full
    pool would be a strided view, which the kernels refuse)."""
    _check_divides(cfg, mesh)
    m = mesh.model_size
    local = dataclasses.replace(cfg, num_heads=cfg.num_heads // m,
                                channels=cfg.channels // m)
    return init_pool(local, page, dtype=dtype, device=device)


def _check_divides(cfg: GPT2Config, mesh: Mesh) -> None:
    m = mesh.model_size
    if cfg.num_heads % m or cfg.padded_vocab_size % m:
        raise ValueError(
            f"tensor parallelism over {m} ranks needs num_heads "
            f"({cfg.num_heads}) and padded_vocab_size "
            f"({cfg.padded_vocab_size}) divisible by {m}")


# ---- collectives on the model axis ----------------------------------------------

def _model_group(mesh: Mesh):
    if mesh.model_group is None:
        raise RuntimeError("this mesh has no process group (Mesh.local): "
                           "build it with make_mesh to run collectives")
    return mesh.model_group


def _all_reduce(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """psum over the model axis (in place on ``t``, a fresh tensor)."""
    if mesh.model_size == 1:
        return t
    t = t.contiguous()
    dist.all_reduce(t, group=_model_group(mesh))
    COLLECTIVES["all_reduce"] += 1
    return t


def _all_gather_last(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """JAX's tiled all_gather over the last axis (:299): the ranks' (...,
    n) blocks gathered into one (m, N, n) buffer, then the rank axis
    moved next to the last, giving (..., m·n). ``dist.all_gather`` takes
    both backends on both devices."""
    m = mesh.model_size
    if m == 1:
        return t
    lead, n = t.shape[:-1], t.shape[-1]
    flat = t.reshape(-1, n).contiguous()
    buf = flat.new_empty((m,) + tuple(flat.shape))
    dist.all_gather(list(buf.unbind(0)), flat, group=_model_group(mesh))
    COLLECTIVES["all_gather"] += 1
    return buf.permute(1, 0, 2).reshape(*lead, m * n)


# ---- the per-rank bodies ---------------------------------------------------------

def _tp_qkv(lp, h):
    """h (..., C) → q, k, v (..., NHl, HS) through the local heads' qkv
    rows (a (3·NHl·HS, C) view: the rows are the quantization rows)."""
    w = lp["qkvw"]                              # (3, NHl, HS, C)
    t, nhl, hs, C = w.shape
    flat = {"w": w.reshape(t * nhl * hs, C), "b": lp["qkvb"].reshape(-1)}
    if w.dtype == torch.int8:
        flat["w_scale"] = lp["qkvw_scale"].reshape(-1)
    qkv = gpt2._lin(flat, "w", h, "b")
    return qkv.reshape(*h.shape[:-1], t, nhl, hs).unbind(-3)


def _f32_product(x, w):
    """x (..., IC) @ w (OC, IC)^T, accumulated and returned in f32 (not
    rounded to x's dtype). On the card a bf16 x and w go through one bf16
    GEMM with an f32 output, with no f32 copy of either; elsewhere the
    operands are upcast, which gives the same products (a product of two
    bf16 values is exact in f32)."""
    if x.device.type != "cuda" or not x.dtype == w.dtype == torch.bfloat16:
        return torch.matmul(x.float(), w.t().float())
    out = torch.mm(x.reshape(-1, x.shape[-1]), w.t(),
                   out_dtype=torch.float32)
    return out.reshape(*x.shape[:-1], w.shape[0])


def _row_parallel(lp, wkey: str, x, bkey: str, mesh: Mesh):
    """A linear whose input features split over the model axis (attproj,
    fcproj): f32 partial products summed over the ranks, then the
    single-device linear's epilogue once: the int8 scale, or the rounding
    to x's dtype, then the bias."""
    w = lp[wkey]
    w = w.reshape(w.shape[0], -1)
    if w.dtype == torch.int8:
        out = _all_reduce(int8_product(x, w), mesh) * lp[wkey + "_scale"]
    else:
        out = _all_reduce(_f32_product(x, w), mesh).to(x.dtype)
    return out + lp[bkey]


def _tp_block(x, lp, mesh: Mesh, attend):
    """One transformer block on this rank's shard; ``attend(q, k, v)``
    gets the local heads and returns them (..., NHl, HS). Two
    all-reduces (attproj, fcproj), the Megatron pattern."""
    h = L.layernorm(x, lp["ln1w"], lp["ln1b"])
    att = attend(*_tp_qkv(lp, h))
    x = x + _row_parallel(lp, "attprojw", att.reshape(*att.shape[:-2], -1),
                          "attprojb", mesh)
    h2 = L.layernorm(x, lp["ln2w"], lp["ln2b"])
    ff = L.gelu_tanh(gpt2._lin(lp, "fcw", h2, "fcb"))     # (..., 4C/m)
    return x + _row_parallel(lp, "fcprojw", ff, "fcprojb", mesh)


def _tp_embed(params, tokens, wpe_pos, mesh: Mesh):
    """Embedding from the vocab-sharded wte: each rank contributes the
    rows it owns, the all-reduce combines them (exact: one nonzero
    term); int8 rows dequantize on the fly."""
    wte = params["wte"]
    vs = wte.shape[0]
    local = tokens.long() - mesh.model_rank * vs
    in_range = (local >= 0) & (local < vs)
    safe = torch.where(in_range, local, 0)
    if wte.dtype == torch.int8:
        rows = wte[safe].float() * params["wte_scale"][safe][..., None]
    else:
        rows = wte[safe]
    emb = _all_reduce(torch.where(in_range[..., None], rows,
                                  torch.zeros((), dtype=rows.dtype,
                                              device=rows.device)), mesh)
    return emb + params["wpe"][wpe_pos.long()]


def _tp_logits(x, params, mesh: Mesh, cfg: GPT2Config):
    """Final layernorm, the vocab-sharded lm_head, the vocab shards
    gathered, cut to V."""
    x = L.layernorm(x, params["lnfw"], params["lnfb"])
    if params["wte"].dtype == torch.int8:
        local = int8_linear(x, params["wte"], params["wte_scale"])
    else:
        local = L.linear(x, params["wte"])      # (..., Vp/m)
    return _all_gather_last(local, mesh)[..., : cfg.vocab_size]


class TPModel(gpt2_paged.SingleDevice):
    """The paged forward's model pieces on one rank of a TP mesh (the
    one-device ones are ``models/gpt2_paged.SINGLE``): the local heads,
    the vocab-sharded embedding and logits, the block with its two
    all-reduces. As in the JAX package, the prompt attends through the
    plain causal attention (:504; the flash route under TP is later
    work) and a suffix prefill reads the pool through the multi-query
    kernel only for T <= 64 (:571). Its chained step holds collectives,
    so it never replays as a CUDA graph."""

    graphs = False

    def __init__(self, cfg: GPT2Config, mesh: Mesh):
        _check_divides(cfg, mesh)
        self.mesh = mesh

    def heads(self, cfg: GPT2Config) -> int:
        return cfg.num_heads // self.mesh.model_size

    def new_pool(self, cfg, page, dtype, device, max_seqs: int):
        return init_tp_pool(cfg, page, self.mesh, dtype=dtype, device=device)

    def embed(self, params, tokens, wpe_pos):
        return _tp_embed(params, tokens, wpe_pos, self.mesh)

    def block(self, x, lp, cfg: GPT2Config, attend):
        return _tp_block(x, lp, self.mesh, attend)

    def logits(self, x, params, cfg: GPT2Config):
        return _tp_logits(x, params, self.mesh, cfg)

    @staticmethod
    def prompt_attention(q, k, v, use_kernel: bool):
        return L.causal_attention(q, k, v)

    @staticmethod
    def suffix_kernel(T: int) -> bool:
        return T <= 64


# ---- the step builders (JAX's signatures; the bodies are the paged
# forward's own, run on the local heads) -------------------------------------------

def make_tp_decode_step(cfg: GPT2Config, mesh: Mesh, use_kernel: bool = True):
    """step(params_tp, tokens, wpe_pos, page, slot, tables, lengths,
    starts, pool) -> (logits (B, V), pool): ``decode_step_paged`` on this
    rank's heads and pool (from ``prepare_tp_params`` and
    ``init_tp_pool``); the logits are whole on every rank."""
    model = TPModel(cfg, mesh)

    def step(params, tokens, wpe_pos, page, slot, tables, lengths, starts,
             pool):
        return gpt2_paged.decode_step_paged(
            params, tokens, wpe_pos, page, slot, tables, lengths, pool, cfg,
            use_kernel=use_kernel, starts=starts, model=model)
    return step


def make_tp_decode_chunk(cfg: GPT2Config, mesh: Mesh, num_steps: int,
                         window: int, use_kernel: bool = True,
                         top_k: Optional[int] = None,
                         temperature: float = 1.0):
    """chunk(params_tp, first (B,), pos0 (B,), pages (K, B), slots (K, B),
    tables (B, pps), pool, rng=None) -> (tokens (K, B), pool):
    ``decode_chunk_paged`` on the local heads (the pool prefix plus
    in-flight tail, the tails holding the local heads). ``rng`` None is
    greedy; a torch.Generator seeded alike on every rank draws the same
    token on every rank, since the gathered logits are the same there."""
    model = TPModel(cfg, mesh)

    def chunk(params, first, pos0, pages, slots, tables, pool, rng=None):
        out, pool = gpt2_paged.decode_chunk_paged(
            params, first, pos0, pages, slots, tables, pool, cfg,
            num_steps=num_steps, window=window, use_kernel=use_kernel,
            rng=rng, top_k=top_k, temperature=temperature, model=model)
        return out, pool
    return chunk


def make_tp_prefill(cfg: GPT2Config, mesh: Mesh):
    """prefill(params_tp, tokens (B, T), page (B, T), slot (B, T), pool,
    last_pos (B,)) -> (logits (B, V), pool): ``prefill_paged`` on the
    local heads, the logits only at each row's last prompt position."""
    model = TPModel(cfg, mesh)

    def prefill(params, tokens, page, slot, pool, last_pos):
        return gpt2_paged.prefill_paged(params, tokens, page, slot, pool, cfg,
                                        last_pos=last_pos, model=model)
    return prefill


def make_tp_prefill_suffix(cfg: GPT2Config, mesh: Mesh,
                           use_kernel: bool = True):
    """suffix_run(params_tp, tokens (B, T), page, slot, pool, tables,
    pool_len (B,), last_pos (B,)) -> (logits (B, V), pool):
    ``prefill_suffix_paged`` on the local heads (prefix caching)."""
    model = TPModel(cfg, mesh)

    def suffix_run(params, tokens, page, slot, pool, tables, pool_len,
                   last_pos):
        return gpt2_paged.prefill_suffix_paged(
            params, tokens, page, slot, pool, tables, pool_len, cfg,
            last_pos=last_pos, use_kernel=use_kernel, model=model)
    return suffix_run


def make_tp_decode_chunk_spec(cfg: GPT2Config, mesh: Mesh, num_steps: int,
                              spec_k: int, ngram: int = 3,
                              use_kernel: bool = True):
    """chunk_spec(params_tp, first (B,), pos0 (B,), hist (B, H), pool,
    tables (B, pps), active) -> (out, counts, hist, last_tok,
    new_positions, pool): ``decode_chunk_spec`` on the local heads.
    Every rank drafts the same tokens (the history is the same) and
    picks the same argmax (the gathered logits are), so acceptance and
    the stream are the same on every rank and equal plain TP greedy."""
    model = TPModel(cfg, mesh)

    def chunk_spec(params, first, pos0, hist, pool, tables, active):
        return gpt2_paged.decode_chunk_spec(
            params, first, pos0, hist, pool, tables, cfg,
            num_steps=num_steps, spec_k=spec_k, ngram=ngram,
            use_kernel=use_kernel, active=active, model=model)
    return chunk_spec


# ---- data parallelism ------------------------------------------------------------

def make_dp_train_step(cfg: GPT2Config, mesh: Mesh, optimizer):
    """Data-parallel AdamW training (the reference's DDP, train_gpt2.py:
    519-521). ``optimizer`` is a torch.optim.Optimizer over the leaf
    tensors of the params dict the step is given. Returns (step,
    shard_batch, replicate):

    - ``shard_batch(x, y)``: this rank's rows of the global batch (B
      divisible by the data axis);
    - ``replicate(params)``: the params and the optimizer's state
      broadcast, in place, from the data group's first rank;
    - ``step(params, x, y)``: the loss on the local rows, backward, ONE
      all-reduce over the data group of the flat gradients with the loss
      beside them, divided by the group size, then the optimizer step;
      returns the mean of the ranks' losses (the global batch's loss,
      since the ranks' row counts are equal)."""
    d = mesh.data_size
    src = int(mesh.grid[0, mesh.model_rank])    # the data group's first rank

    def shard_batch(x, y):
        B = x.shape[0]
        if B % d:
            raise ValueError(f"batch {B} does not split over {d} ranks")
        lo = mesh.data_rank * (B // d)
        return x[lo: lo + B // d], y[lo: lo + B // d]

    def replicate(params):
        if d == 1:
            return params
        tensors = [p.data for p in params.values()]
        tensors += [v for st in optimizer.state.values()
                    for v in st.values() if torch.is_tensor(v)]
        dev = next(iter(params.values())).device
        for t in tensors:
            buf = t if t.device == dev else t.to(dev)
            dist.broadcast(buf, src=src, group=mesh.data_group)
            if buf is not t:
                t.copy_(buf)
        return params

    def step(params, x, y):
        optimizer.zero_grad(set_to_none=True)
        loss = gpt2.loss_fn(params, x, y, cfg)
        loss.backward()
        leaves = list(params.values())
        flat = torch.cat([p.grad.reshape(-1).float() for p in leaves]
                         + [loss.detach().float().reshape(1)])
        if d > 1:
            dist.all_reduce(flat, group=mesh.data_group)
            flat /= d
        off = 0
        for p in leaves:
            p.grad.copy_(flat[off: off + p.numel()].view_as(p))
            off += p.numel()
        optimizer.step()
        return flat[-1]

    return step, shard_batch, replicate
