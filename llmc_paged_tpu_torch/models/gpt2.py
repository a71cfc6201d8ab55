"""L2: GPT-2 as plain functions over a dict of tensors (port of
llmc_paged_tpu/models/gpt2.py: init, device placement, the shared block
skeleton, logits, and the reference's two cache-free and dense-cache
modes):
  * ``forward``     : full recompute, no cache   (infer.c path); its
    body ``_forward`` is what ``loss_fn`` and ``grad_fn`` differentiate
  * ``prefill``     : forward that also fills a dense KV cache
  * ``decode_step`` : one-token step over the dense cache
    (cached_infer.c path, without its rebuild-qkv copy)
The paged path lives in models/gpt2_paged.py.

Parameters keep the JAX package's names and its stacked layout: each
per-layer tensor has a leading L axis, weights are stored (OC, IC). The
vocab is not padded (wte is (V, C)); logits are V wide.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from llmc_paged_tpu_torch import resolve_device
from llmc_paged_tpu_torch.config import GPT2Config
from llmc_paged_tpu_torch.formats import param_shapes, read_checkpoint
from llmc_paged_tpu_torch.ops import layers as L
from llmc_paged_tpu_torch.ops.int8 import int8_linear

Params = Dict[str, torch.Tensor]

LAYER_KEYS = ("ln1w", "ln1b", "qkvw", "qkvb", "attprojw", "attprojb",
              "ln2w", "ln2b", "fcw", "fcb", "fcprojw", "fcprojb")
LN_KEYS = ("ln1w", "ln1b", "ln2w", "ln2b", "lnfw", "lnfb")


class DenseKVCache(NamedTuple):
    """Contiguous per-layer KV cache (cached_infer.c:453-454,554 redesigned
    as tensors): k and v are (L, B, NH, S, HS), updated in place."""
    k: torch.Tensor
    v: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k.shape[3]


def init_cache(cfg: GPT2Config, batch: int, max_len: int,
               dtype=torch.float32, device=None) -> DenseKVCache:
    """Zeroed dense cache on ``device`` (the card by default)."""
    device = resolve_device(device)
    shape = (cfg.num_layers, batch, cfg.num_heads, max_len, cfg.head_dim)
    return DenseKVCache(torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=dtype, device=device))


def load_params(path: str):
    """(config, numpy params) of a model .bin (fp32 or bf16 checkpoint)."""
    return read_checkpoint(path)


def init_params(cfg: GPT2Config, generator: torch.Generator,
                dtype=torch.float32, device=None) -> Params:
    """Random init: N(0, 0.02) for matmul/embedding weights, ones for
    layernorm weights, zeros for biases. Values are drawn on the
    generator's device and moved to ``device`` (the card by default)."""
    device = resolve_device(device)
    gdev = generator.device
    params: Params = {}
    for name, shape in param_shapes(cfg).items():
        if name in ("ln1w", "ln2w", "lnfw"):
            t = torch.ones(shape, device=gdev)
        elif name.endswith("b"):
            t = torch.zeros(shape, device=gdev)
        else:
            t = 0.02 * torch.randn(shape, generator=generator, device=gdev)
        params[name] = t.to(device=device, dtype=dtype)
    return params


def to_device(params, cfg: GPT2Config, dtype=torch.float32,
              device=None) -> Params:
    """Place a params dict (numpy arrays or tensors) on ``device`` (the
    card by default) in ``dtype``. Layernorm parameters and int8 scales
    stay fp32 and int8 weights stay int8; wte padded by the JAX package is
    cut back to V rows."""
    device = resolve_device(device)
    out: Params = {}
    for k, v in params.items():
        t = v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
        if k == "wte":
            t = t[: cfg.vocab_size]
        if t.dtype == torch.int8:
            dt = torch.int8
        elif k in LN_KEYS or k.endswith("_scale"):
            dt = torch.float32
        else:
            dt = dtype
        out[k] = t.to(device=device, dtype=dt)
    return out


def _layer_stack(params: Params) -> Params:
    return {k: v for k, v in params.items()
            if k in LAYER_KEYS or (k.endswith("_scale")
                                   and k[:-6] in LAYER_KEYS)}


def _lin(lp: Params, wkey: str, x: torch.Tensor,
         bkey: str | None = None) -> torch.Tensor:
    """Linear through a float weight or an int8 (weight, scale) pair."""
    b = lp[bkey] if bkey else None
    w = lp[wkey]
    if w.dtype == torch.int8:
        return int8_linear(x, w, lp[wkey + "_scale"], b)
    return L.linear(x, w, b)


def _embed(params: Params, tokens: torch.Tensor,
           wpe_pos: torch.Tensor) -> torch.Tensor:
    """wte[tokens] + wpe[pos], dequantizing int8 wte rows on the fly."""
    wte = params["wte"]
    tokens, wpe_pos = tokens.long(), wpe_pos.long()
    if wte.dtype == torch.int8:
        emb = wte[tokens].float() * params["wte_scale"][tokens][..., None]
    else:
        emb = wte[tokens]
    return emb + params["wpe"][wpe_pos]


def _split_qkv(qkv: torch.Tensor, cfg: GPT2Config):
    """(..., 3C) → three (..., NH, HS) views; K at +C, V at +2C."""
    shape = qkv.shape[:-1] + (cfg.num_heads, cfg.head_dim)
    q, k, v = qkv.split(cfg.channels, dim=-1)
    return q.reshape(shape), k.reshape(shape), v.reshape(shape)


def _block(x: torch.Tensor, lp: Params, cfg: GPT2Config, attend):
    """One transformer block with a caller-supplied attention middle:
    ``attend(q, k, v)`` gets the heads (..., NH, HS), owns any pool
    writes, and returns (..., C)."""
    h = L.layernorm(x, lp["ln1w"], lp["ln1b"])
    q, k, v = _split_qkv(_lin(lp, "qkvw", h, "qkvb"), cfg)
    x = x + _lin(lp, "attprojw", attend(q, k, v), "attprojb")
    h2 = L.layernorm(x, lp["ln2w"], lp["ln2b"])
    return x + _lin(lp, "fcprojw",
                    L.gelu_tanh(_lin(lp, "fcw", h2, "fcb")), "fcprojb")


def _layer(stack: Params, i: int) -> Params:
    return {name: w[i] for name, w in stack.items()}


def _logits(x: torch.Tensor, params: Params, cfg: GPT2Config):
    """Final layernorm + weight-tied lm_head, V wide."""
    x = L.layernorm(x, params["lnfw"], params["lnfb"])
    if params["wte"].dtype == torch.int8:
        logits = int8_linear(x, params["wte"], params["wte_scale"])
    else:
        logits = L.linear(x, params["wte"])
    return logits[..., : cfg.vocab_size]


def _forward(params: Params, tokens, cfg: GPT2Config) -> torch.Tensor:
    """The full no-cache forward that autograd can differentiate: tokens
    (B, T) → logits (B, T, V). Attention is the dense causal one, never
    the flash kernel (it has no backward), as in the JAX package."""
    dev = params["wpe"].device
    tokens = torch.as_tensor(tokens, device=dev)
    B, T = tokens.shape
    x = _embed(params, tokens, torch.arange(T, device=dev)[None])
    stack = _layer_stack(params)

    def attend(q, k, v):
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))   # (B,NH,T,HS)
        return L.causal_attention(q, k, v).transpose(1, 2).reshape(
            B, T, cfg.channels)

    for i in range(cfg.num_layers):
        x = _block(x, _layer(stack, i), cfg, attend)
    return _logits(x, params, cfg)


@torch.no_grad()
def forward(params: Params, tokens: torch.Tensor,
            cfg: GPT2Config) -> torch.Tensor:
    """Full no-cache forward: tokens (B, T) → logits (B, T, V)."""
    return _forward(params, tokens, cfg)


def loss_fn(params: Params, x, y, cfg: GPT2Config) -> torch.Tensor:
    """Mean next-token NLL of inputs x (B, T) against targets y (B, T),
    a 0-dim tensor that autograd can differentiate (JAX gpt2.py:208-211).
    x and y may be tensors or numpy arrays; they move to the params'
    device."""
    logits = _forward(params, x, cfg)
    return L.softmax_cross_entropy(
        logits, torch.as_tensor(y, device=logits.device))


def grad_fn(params: Params, x, y, cfg: GPT2Config):
    """(loss, grads) like ``jax.value_and_grad(loss_fn)``: grads is a
    dict with the params' keys. The caller's tensors are left as they
    are. The tied wte gets the sum of its embedding and lm_head uses."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(leaves, x, y, cfg)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


@torch.no_grad()
def prefill(params: Params, tokens: torch.Tensor, cache: DenseKVCache,
            cfg: GPT2Config, use_kernel: bool = True):
    """Forward over the prompt that also fills the dense KV cache at
    positions [0, T). Returns (logits (B, T, V), cache). Rows shorter than
    T are right-padded; their K/V past the true length is masked by the
    decode step's length. ``use_kernel=False`` keeps the attention dense
    where ``ops/layers.prefill_attention`` would take the flash kernel."""
    dev = params["wpe"].device
    tokens = tokens.to(dev)
    B, T = tokens.shape
    x = _embed(params, tokens, torch.arange(T, device=dev)[None])
    stack = _layer_stack(params)

    for i in range(cfg.num_layers):
        def attend(q, k, v, i=i):
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (B,NH,T,HS)
            cache.k[i, :, :, :T] = k
            cache.v[i, :, :, :T] = v
            att = L.prefill_attention(q, k, v, use_kernel)
            return att.transpose(1, 2).reshape(B, T, cfg.channels)

        x = _block(x, _layer(stack, i), cfg, attend)
    return _logits(x, params, cfg), cache


@torch.no_grad()
def decode_step(params: Params, tokens: torch.Tensor, pos: torch.Tensor,
                cache: DenseKVCache, cfg: GPT2Config, wpe_pos=None,
                starts=None):
    """One decode step over the dense cache.

    tokens (B,) new ids; pos (B,) their cache positions (== the row's
    current length). Returns (logits (B, V), cache). Sliding-window parity
    (cached_infer.c:606 pointer bump): ``starts`` are per-row window lower
    bounds and ``wpe_pos`` the clamped position-embedding indices (a
    post-window token sits at window position W-1)."""
    dev = params["wpe"].device
    tokens, pos = tokens.to(dev), pos.to(dev).long()
    wpe_pos = pos if wpe_pos is None else wpe_pos.to(dev)
    starts = None if starts is None else starts.to(dev)
    B = tokens.shape[0]
    rows = torch.arange(B, device=dev)
    x = _embed(params, tokens, wpe_pos)
    stack = _layer_stack(params)

    for i in range(cfg.num_layers):
        def attend(q, k, v, i=i):                       # (B, NH, HS)
            cache.k[i, rows, :, pos] = k.to(cache.k.dtype)
            cache.v[i, rows, :, pos] = v.to(cache.v.dtype)
            att = L.decode_attention(q, cache.k[i], cache.v[i], pos + 1,
                                     start=starts)
            return att.reshape(B, cfg.channels)

        x = _block(x, _layer(stack, i), cfg, attend)
    return _logits(x, params, cfg), cache
