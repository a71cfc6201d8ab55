"""The port's causal flash attention (ops/flash_attention.py) and the
prefill routing around it, on the CPU, against the JAX package: the
plain version against JAX's bundled Pallas TPU kernel run in interpret
mode, against the dense attention at f32, the routing rule of
``prefill_attention``, and the whole bf16 prefill with an int8 pool
through both packages' flash functions. Inputs are numpy, from a seed.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_flash_attention.py
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from llmc_paged_tpu.config import PageConfig as JPageConfig
from llmc_paged_tpu.kv.layouts import init_pool as j_init_pool
from llmc_paged_tpu.kv.layouts import token_coords as j_token_coords
from llmc_paged_tpu.models import gpt2 as JG
from llmc_paged_tpu.models import gpt2_paged as JGP
from llmc_paged_tpu.ops import layers as JL
from llmc_paged_tpu_torch.config import PageConfig as TPageConfig
from llmc_paged_tpu_torch.convert import params_from_numpy
from llmc_paged_tpu_torch.kv.layouts import init_pool as t_init_pool
from llmc_paged_tpu_torch.models import gpt2_paged as TGP
from llmc_paged_tpu_torch.ops import flash_attention as TF
from llmc_paged_tpu_torch.ops import layers as TL
from test_torch_common import jax_cfg, params_np, port_cfg, to_np


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _bf16_ulp(x):
    """One bf16 ulp of each element of x (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def _mass(q, k, v):
    """sum_k p_k |v_k| / l of each output element, from the f32 softmax of
    the inputs: the size of the terms an output element sums."""
    T = q.shape[2]
    s = (q.float() @ k.float().transpose(-1, -2)) / np.sqrt(q.shape[-1])
    s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool).tril(),
                      float("-inf"))
    return (torch.softmax(s, -1) @ v.float().abs()).numpy()


@pytest.mark.parametrize("shape", [(1, 3, 256, 64), (2, 2, 384, 64)])
def test_flash_matches_the_interpreted_tpu_kernel(shape):
    """The port's causal_attention_flash (on the CPU: its plain version)
    against JAX's causal_attention_flash, the bundled Pallas TPU kernel
    in interpret mode, on the same bf16 inputs. Tolerance: one bf16 ulp
    of the JAX output, plus 2^-8 of the element's mass sum p|v|/l (p
    rounds to bf16 in both, where the f32 scores of XLA's and torch's
    products may round it to neighbouring values), + 1e-6. Measured at
    most a quarter of it; the dense bf16 route breaks it."""
    q, k, v = _qkv(shape)
    with pltpu.force_tpu_interpret_mode():
        want = JL.causal_attention_flash(
            *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
        want = to_np(want)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = TF.causal_attention_flash(tq, tk, tv)
    assert got.dtype == torch.bfloat16 and got.shape == shape
    tol = _bf16_ulp(want) + 2.0 ** -8 * _mass(tq, tk, tv) + 1e-6
    assert np.all(np.abs(to_np(got) - want) <= tol)


@pytest.mark.parametrize("T", [128, 200, 256, 384])
def test_plain_flash_equals_dense_attention_at_f32(T):
    """At f32 nothing rounds between the blocks, so the blocked online
    softmax is the dense causal_attention up to f32 sums in another
    order: within 1e-5. T = 200 leaves a ragged last block."""
    q, k, v = (torch.from_numpy(a) for a in _qkv((2, 3, T, 64), seed=T))
    got = TF.causal_attention_flash_ref(q, k, v)
    want = TL.causal_attention(q, k, v)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def _fake_q(is_cuda=True, dtype=torch.bfloat16, T=256):
    return types.SimpleNamespace(is_cuda=is_cuda, dtype=dtype,
                                 shape=(2, 3, T, 64))


def test_takes_flash_is_the_jax_rule():
    """bf16 q on the card with T >= 256 and T % 128 == 0, and use_kernel;
    anything else stays dense."""
    assert TL.takes_flash(_fake_q())
    assert TL.takes_flash(_fake_q(T=896))
    assert not TL.takes_flash(_fake_q(), use_kernel=False)
    assert not TL.takes_flash(_fake_q(is_cuda=False))
    assert not TL.takes_flash(_fake_q(dtype=torch.float32))
    assert not TL.takes_flash(_fake_q(T=128))
    assert not TL.takes_flash(_fake_q(T=320))


@pytest.mark.parametrize("dtype,T,use_kernel", [
    (torch.bfloat16, 256, True),        # on the CPU
    (torch.float32, 256, True),
    (torch.bfloat16, 128, True),
    (torch.bfloat16, 320, True),
    (torch.bfloat16, 256, False)])
def test_prefill_attention_stays_dense_off_the_rule(monkeypatch, dtype, T,
                                                    use_kernel):
    """CPU tensors, f32, T < 256, T % 128 != 0 and use_kernel=False take
    the dense causal_attention (equal to it) and never the flash entry
    (patched to fail if called); no launch is counted."""
    def refuse(*a):
        raise AssertionError("the flash route was taken")

    monkeypatch.setattr(TL, "causal_attention_flash", refuse)
    before = dict(TF.LAUNCHES)
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in _qkv((1, 2, T, 64), seed=1))
    got = TL.prefill_attention(q, k, v, use_kernel=use_kernel)
    assert torch.equal(got, TL.causal_attention(q, k, v))
    assert TF.LAUNCHES == before


def test_prefill_attention_hands_the_kernel_contiguous_heads(monkeypatch):
    """Where the rule holds (forced here), prefill_attention hands the
    kernel the model's transposed head views uncopied (only each head's
    last dim is contiguous): every data_ptr lies in the qkv buffer's
    storage, at the offsets of the views. It returns the flash result."""
    seen = []

    def record(q, k, v):
        seen.append([(t.data_ptr(), t.stride(), t.untyped_storage()
                      .data_ptr()) for t in (q, k, v)])
        return TF.causal_attention_flash_ref(q, k, v)

    monkeypatch.setattr(TL, "takes_flash", lambda q, use_kernel: True)
    monkeypatch.setattr(TL, "causal_attention_flash", record)
    B, T, NH = 1, 256, 2
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((B, T, 3 * NH * 64))
                           .astype(np.float32)).bfloat16()
    q, k, v = (t.reshape(B, T, NH, 64).transpose(1, 2)
               for t in qkv.split(NH * 64, dim=-1))    # (B, NH, T, HS)
    assert not q.is_contiguous()
    got = TL.prefill_attention(q, k, v)
    base, size = qkv.data_ptr(), qkv.element_size()
    assert seen == [[(base + i * NH * 64 * size, (T * 3 * NH * 64, 64,
                                                  3 * NH * 64, 1), base)
                     for i in range(3)]]
    assert torch.equal(got, TF.causal_attention_flash_ref(q, k, v))


def _qkv_views(B, T, NH, device="meta"):
    """The heads as the model cuts them from its (B, T, 3C) qkv product."""
    buf = torch.empty((B, T, 3 * NH * 64), dtype=torch.bfloat16,
                      device=device)
    return [t.reshape(B, T, NH, 64).transpose(1, 2)
            for t in buf.split(NH * 64, dim=-1)]


@pytest.mark.parametrize("B,T,NH", [(8, 896, 12), (8, 896, 25),
                                    (1, 256, 12), (2, 1024, 25)])
def test_tensor_map_geometry_of_the_qkv_views(B, T, NH):
    """The tensor maps over the 124M (NH 12, C 768) and 1558M (NH 25,
    C 1600) qkv views: dims (HS, T, NH, B); byte strides of a token (one
    qkv row, 3C bf16), a head (64 bf16) and a batch row (T qkv rows; at
    B 1 the dense stride); one box of 128 rows of 64. The same for q, k
    and v (only the base differs), and for a contiguous (B, NH, T, 64)
    tensor its dense strides."""
    C = NH * 64
    for t in _qkv_views(B, T, NH):
        dims, strides, box = TF.tensor_map_geometry(t.shape, t.stride())
        assert dims == (64, T, NH, B)
        batch = T * 3 * C * 2 if B > 1 else NH * T * 128   # B 1: dense
        assert strides == (3 * C * 2, 128, batch)
        assert box == (64, 128, 1, 1)
    dense = torch.empty((B, NH, T, 64), device="meta")
    assert TF.tensor_map_geometry(dense.shape, dense.stride())[1] == (
        128, T * 128, NH * T * 128)


def test_tensor_map_geometry_of_a_single_head_and_batch():
    """A dim of size 1 is never stepped: its stride, whatever it is, is
    replaced by the contiguous one."""
    assert TF.tensor_map_geometry((1, 1, 256, 64), (5, 3, 64, 1))[1] == (
        128, 256 * 128, 256 * 128)


@pytest.mark.parametrize("stride,what", [
    ((3 * 256 * 192, 64, 192, 2), "last dim"),      # every other element
    ((3 * 256 * 192, 64, 196, 1), "token stride"),  # 392 bytes a row
    ((3 * 256 * 192, 60, 192, 1), "head stride"),
    ((3 * 256 * 192 + 4, 64, 192, 1), "batch stride"),
    ((3 * 256 * 192, 64, 0, 1), "token stride"),    # broadcast rows
    ((2 ** 39, 64, 192, 1), "batch stride")])       # 2^40 bytes
def test_tensor_map_geometry_refuses_what_tma_cannot_read(stride, what):
    """A ValueError, naming the operand and the dim, on each stride the
    kernel refuses: a last dim that is not contiguous, a stride that is
    not a positive multiple of 8 elements (16 bytes), one of 2^40 bytes."""
    with pytest.raises(ValueError, match=what.split()[0]) as e:
        TF.tensor_map_geometry((2, 3, 256, 64), stride, "k")
    assert str(e.value).startswith("k:")


@pytest.mark.parametrize("B,T,NH,qkv", [
    (8, 896, 12, True), (8, 896, 25, True), (1, 256, 12, True),
    (2, 1024, 25, True), (3, 128, 12, True), (8, 896, 12, False),
    (1, 256, 25, False)])
def test_kernel_geometry_is_what_the_c_entry_reads(B, T, NH, qkv):
    """The 36 values of the C entry's ``geom`` for the qkv views (or
    contiguous heads) and the (B, T, NH, 64) output the wrapper
    allocates: per operand the 11 of its tensor map in the order the C
    entry reads them, dims (64, T, NH, B), byte strides of T, NH and B,
    box (64, 128, 1, 1); then the output's element strides of B, NH, T."""
    C = NH * 64
    if qkv:
        q, k, v = _qkv_views(B, T, NH)
        strides = (3 * C * 2, 128, T * 3 * C * 2 if B > 1 else NH * T * 128)
    else:
        q = k = v = torch.empty((B, NH, T, 64), dtype=torch.bfloat16,
                                device="meta")
        strides = (128, T * 128, NH * T * 128)
    out = torch.empty((B, T, NH, 64), dtype=torch.bfloat16,
                      device="meta").transpose(1, 2)
    one = (64, T, NH, B) + strides + (64, 128, 1, 1)
    assert TF.kernel_geometry(q, k, v, out) == one * 3 + (T * C, 64, C)


@pytest.mark.parametrize("bad", ["q", "k", "v"])
def test_kernel_geometry_names_the_operand_it_refuses(bad):
    """A stride the kernel cannot read in any one operand raises a
    ValueError that names that operand."""
    good = _qkv_views(2, 256, 3)
    ops = {n: t for n, t in zip("qkv", good)}
    ops[bad] = torch.empty((2, 3, 256, 68), dtype=torch.bfloat16,
                           device="meta")[..., :64]       # 136-byte rows
    with pytest.raises(ValueError, match="token stride 68") as e:
        TF.kernel_geometry(ops["q"], ops["k"], ops["v"], good[0])
    assert str(e.value).startswith(f"{bad}:")


def test_flash_refuses_other_devices():
    q = torch.empty((1, 1, 128, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no causal_attention_flash route"):
        TF.causal_attention_flash(q, q, q)


def test_prefill_paged_through_both_flash_kernels(monkeypatch):
    """The slice end to end at a tiny size: prefill_paged with bf16
    weights (the engine's prefill copy) and an int8 pool, T = 256 (two
    pages of 128 a row, 2 layers, HS 64), in both packages with their
    prefill_attention routed to their flash functions (JAX's kernel in
    interpret mode, under a fresh jit so no earlier trace is reused; the
    port's plain version). Tolerances of test_torch_model's int8/bf16
    test: logits within 2e-2 (bf16 matmul outputs round different
    elements in XLA and torch), pools dequantized within its bound of 4
    quantization steps (measured: 2.48 here, 2.18 with both packages on
    their dense route; layer 0, before any attention, 2.0)."""
    T, PS, B = 256, 128, 2
    jcfg, tcfg = jax_cfg(max_seq_len=T), port_cfg(max_seq_len=T)
    p = params_np(tcfg, seed=0)
    jp = JG.to_device(p, jcfg, jnp.bfloat16)
    tp = params_from_numpy(p, tcfg, device="cpu", dtype=torch.bfloat16)
    rng = np.random.default_rng(2)
    xs = rng.integers(0, tcfg.vocab_size, (B, T)).astype(np.int32)
    tables = np.array([[3, 0], [1, 4]], np.int32)
    NP = 6
    pg, sl = j_token_coords(jnp.asarray(tables),
                            jnp.asarray(np.tile(np.arange(T, dtype=np.int32),
                                                (B, 1))),
                            PS, jnp.ones((B, T), bool), NP)
    pg, sl = np.array(pg), np.array(sl)

    monkeypatch.setattr(JL, "prefill_attention", JL.causal_attention_flash)
    jpool = j_init_pool(jcfg, JPageConfig(page_size=PS, num_pages=NP,
                                          pages_per_seq=2, kv_dtype="int8"),
                        dtype="int8")
    fresh = jax.jit(JGP.prefill_paged.__wrapped__, static_argnames=("cfg",))
    with pltpu.force_tpu_interpret_mode():
        jl, jpool = fresh(jp, jnp.asarray(xs), jnp.asarray(pg),
                          jnp.asarray(sl), jpool, jcfg)
        jl = to_np(jl)

    calls = []

    def flash_route(q, k, v, use_kernel=True):
        calls.append(q.dtype)
        return TL.causal_attention_flash(q, k, v)

    monkeypatch.setattr(TL, "prefill_attention", flash_route)
    tpool = t_init_pool(tcfg, TPageConfig(page_size=PS, num_pages=NP,
                                          pages_per_seq=2, kv_dtype="int8"),
                        dtype="int8", device="cpu")
    tl, tpool = TGP.prefill_paged(tp, torch.from_numpy(xs),
                                  torch.from_numpy(pg), torch.from_numpy(sl),
                                  tpool, tcfg)
    assert calls == [torch.bfloat16] * tcfg.num_layers
    assert tl.shape == (B, T, tcfg.vocab_size)
    np.testing.assert_allclose(to_np(tl), jl[..., :tcfg.vocab_size],
                               atol=2e-2, rtol=0)
    for i in range(tcfg.num_layers):
        jk, jv, jks, jvs = (to_np(a).astype(np.float32)
                            for a in jpool.layer(i))
        tk, tv, tks, tvs = (to_np(a).astype(np.float32)
                            for a in tpool.layer(i))
        for jq, js, tq, ts in ((jk, jks, tk, tks), (jv, jvs, tv, tvs)):
            step = np.maximum(js, ts)[:, :, None, :]
            assert np.all(np.abs(jq * js[:, :, None, :]
                                 - tq * ts[:, :, None, :])
                          <= 4 * step + 1e-6)
