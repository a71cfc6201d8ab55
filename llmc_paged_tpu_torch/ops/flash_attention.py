"""Causal flash attention for the long-prompt prefill (port of
llmc_paged_tpu/ops/layers.py::causal_attention_flash, which calls JAX's
bundled Pallas TPU kernel ``jax.experimental.pallas.ops.tpu.
flash_attention`` with ``causal=True``), with its hand-written CUDA
kernel ``csrc/flash_attention.cu``.

    out = softmax(q kᵀ / sqrt(HS), causal) v,    q, k, v: (B, NH, T, HS)

``ops/layers.py::prefill_attention`` takes it on the card for bf16 q
with T >= 256 and T % 128 == 0, the JAX package's rule; every other
prefill stays on the dense ``causal_attention``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from llmc_paged_tpu_torch.ops._build import check_operand, entry, launch

# launches of the CUDA kernel (a plain int; reset by callers)
LAUNCHES = {"causal_attention_flash": 0}
# the TPU kernel's additive mask (DEFAULT_MASK_VALUE) and tiles
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
BLOCK = 128
HEAD_SIZE = 64      # the only head size the kernel takes (every GPT-2 size)


def causal_attention_flash_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor) -> torch.Tensor:
    """Plain version: the TPU kernel's arithmetic in blocks of 128 query
    rows by 128 keys (key blocks wholly above the diagonal skipped): s in
    f32 from the inputs, scaled after the product, the additive mask, an
    online softmax whose accumulator is renormalized every block, p
    rounded to v's dtype before p·v, one rounding of the output to q's
    dtype. Any T (a ragged last block) and HS. At f32 inputs nothing
    rounds and it equals the dense ``causal_attention``."""
    B, NH, T, HS = q.shape
    sm_scale = 1.0 / math.sqrt(HS)
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.empty_like(qf)
    pos = torch.arange(T, device=q.device)
    for q0 in range(0, T, BLOCK):
        qb, rows = qf[:, :, q0:q0 + BLOCK], pos[q0:q0 + BLOCK]
        nq = qb.shape[2]
        m = torch.full((B, NH, nq, 1), -math.inf, device=q.device)
        l = torch.zeros((B, NH, nq, 1), device=q.device)
        acc = torch.zeros((B, NH, nq, HS), device=q.device)
        for k0 in range(0, q0 + nq, BLOCK):
            cols = pos[k0:k0 + BLOCK]
            mask = torch.where(cols[None, :] <= rows[:, None], 0.0,
                               MASK_VALUE)
            s = (qb @ kf[:, :, k0:k0 + BLOCK].transpose(-1, -2)) * sm_scale
            s = s + mask
            m_next = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_next)
            l_corr = torch.exp(m - m_next) * l
            l_next = p.sum(-1, keepdim=True) + l_corr
            inv = torch.where(l_next == 0, 1.0, 1.0 / l_next)
            pv = p.to(v.dtype).float() @ vf[:, :, k0:k0 + BLOCK]
            acc = acc * (l_corr * inv) + pv * inv
            m, l = m_next, l_next
        out[:, :, q0:q0 + nq] = acc
    return out.to(q.dtype)


def tensor_map_geometry(shape, stride, name="q", itemsize=2):
    """The TMA tensor map the kernel reads one (B, NH, T, HS) operand
    through, from its shape and element strides: ``(dims, byte_strides,
    box)`` with dims (HS, T, NH, B), the byte strides of T, NH and B, and
    the box of one 128-row tile, (HS, 128, 1, 1). Raises ``ValueError``
    for what TMA cannot read: a last dim that is not contiguous, or a
    stride that is not a positive multiple of 8 elements (16 bytes) or
    reaches 2^40 bytes. A dim of size 1 is never stepped: its stride is
    replaced by a contiguous one."""
    B, NH, T, HS = shape
    sb, sh, st, sd = stride
    if sd != 1:
        raise ValueError(f"{name}: the last dim must be contiguous "
                         f"(stride {sd})")
    out = []
    for dim, size, s, dense in (("token", T, st, HS), ("head", NH, sh, T * HS),
                                ("batch", B, sb, NH * T * HS)):
        if size == 1:
            s = dense
        if s <= 0 or s % 8 or s * itemsize >= 2 ** 40:
            raise ValueError(f"{name}: {dim} stride {s} is not a positive "
                             "multiple of 8 elements (16 bytes) below 2^40 "
                             "bytes")
        out.append(s * itemsize)
    return (HS, T, NH, B), tuple(out), (HS, BLOCK, 1, 1)


def kernel_geometry(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor) -> tuple:
    """The C entry's ``geom`` array: for q, then k, then v, the 11 values
    of its tensor map (``tensor_map_geometry``: dims, byte strides, box),
    then out's element strides of B, NH and T. Raises ``ValueError`` on a
    stride the kernel cannot read."""
    geom = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        for part in tensor_map_geometry(t.shape, t.stride(), name):
            geom += part
    return tuple(geom) + tuple(out.stride()[:3])


def causal_attention_flash(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """Causal attention over (B, NH, T, HS) in O(T) memory. A CPU tensor
    takes the plain version; a CUDA tensor launches
    ``csrc/flash_attention.cu`` (bf16, HS 64, T % 128 == 0; q, k and v
    may be strided views, as the heads cut from a (B, T, 3C) qkv product
    are, with the last dim contiguous, strides a multiple of 8 elements
    and 16-byte aligned bases) or raises. On the card the result is the
    (B, NH, T, HS) view of a (B, T, NH, HS) tensor, so its
    ``transpose(1, 2).reshape(B, T, NH * HS)`` is a view too."""
    if q.device.type == "cpu":
        return causal_attention_flash_ref(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"no causal_attention_flash route for device "
                         f"{q.device}")
    if q.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)} is not (B, NH, T, HS)")
    B, NH, T, HS = q.shape
    if HS != HEAD_SIZE:
        raise ValueError(f"head size {HS}: the kernel takes {HEAD_SIZE}")
    if T == 0 or T % BLOCK:
        raise ValueError(f"T = {T}: the kernel takes a positive multiple "
                         f"of {BLOCK}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_operand(name, t, (torch.bfloat16,), (B, NH, T, HS), q.device,
                      contiguous=False)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    out = torch.empty((B, T, NH, HS), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    geom = kernel_geometry(q, k, v, out)
    if out.numel() == 0:
        return out
    fn = entry("flash_attention", "causal_attention_flash",
               [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong),
                                        ctypes.c_float, ctypes.c_void_p])
    launch(fn, q.device, (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), (ctypes.c_longlong * 36)(*geom),
                          1.0 / math.sqrt(HS)), "causal_attention_flash")
    LAUNCHES["causal_attention_flash"] += 1
    return out
