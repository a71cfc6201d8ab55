"""L0: byte-exact readers/writers for the reference's binary artifacts (a
copy of llmc_paged_tpu/formats.py: numpy only, so a file written by
either package reads back identically in the other).

Three formats, each with a 256×int32 little-endian header:

* model checkpoint  — magic 20240326, version 1 (fp32) or 2 (bf16);
  header[2..6] = (max_seq_len, vocab_size, num_layers, num_heads, channels);
  then the 16 parameter tensors in the fixed order of the reference writer
  (train_gpt2.py:237-265 fp32; :267-298 bf16 keeps layernorms fp32 at the
  end). Reference reader: train_gpt2.c:592-658.
* debug state       — magic 20240327, version 1; header[2..3] = (B, T);
  then x(B,T) i32, y(B,T) i32, logits(B,T,V) f32, loss f32, grads in the
  fp32 tensor order (train_gpt2.py:328-351).
* tokenizer         — magic 20240328, version 1; header[2] = n_tokens; then
  n length-prefixed raw byte strings (train_gpt2.py:353-367; reader
  train_gpt2.c:1090-1122).

Token streams (prepro_tinyshakespeare.py:56-78) are headerless raw int32.

Parameters are a dict of numpy arrays with per-layer tensors STACKED on a
leading L axis, weights (OC, IC): the layout both packages take
(``models.gpt2.to_device`` places it on the device).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

from llmc_paged_tpu_torch.config import GPT2Config

MODEL_MAGIC = 20240326
STATE_MAGIC = 20240327
TOKENIZER_MAGIC = 20240328
HEADER_INTS = 256

# bf16 checkpoints (version 2) write matmul params first in bf16, then all
# layernorm params in fp32 at the end (train_gpt2.py:267-298).
BF16_ORDER = ["wte", "wpe", "qkvw", "qkvb", "attprojw", "attprojb",
              "fcw", "fcb", "fcprojw", "fcprojb"]
BF16_FP32_TAIL = ["ln1w", "ln1b", "ln2w", "ln2b", "lnfw", "lnfb"]


def param_shapes(cfg: GPT2Config) -> Dict[str, Tuple[int, ...]]:
    """Parameter shapes in the reference's fp32 write order
    (train_gpt2.py:237-265 / ParameterTensors train_gpt2.c:467-484)."""
    V, C, L, T = (cfg.vocab_size, cfg.channels, cfg.num_layers,
                  cfg.max_seq_len)
    return {"wte": (V, C), "wpe": (T, C),
            "ln1w": (L, C), "ln1b": (L, C),
            "qkvw": (L, 3 * C, C), "qkvb": (L, 3 * C),
            "attprojw": (L, C, C), "attprojb": (L, C),
            "ln2w": (L, C), "ln2b": (L, C),
            "fcw": (L, 4 * C, C), "fcb": (L, 4 * C),
            "fcprojw": (L, C, 4 * C), "fcprojb": (L, C),
            "lnfw": (C,), "lnfb": (C,)}


def num_params(cfg: GPT2Config) -> int:
    return sum(int(np.prod(s)) for s in param_shapes(cfg).values())


def _read_header(f) -> np.ndarray:
    raw = f.read(HEADER_INTS * 4)
    if len(raw) != HEADER_INTS * 4:
        raise ValueError("truncated header")
    return np.frombuffer(raw, dtype="<i4")


def _make_header(values: Dict[int, int]) -> bytes:
    header = np.zeros(HEADER_INTS, dtype="<i4")
    for idx, val in values.items():
        header[idx] = val
    return header.tobytes()


def _read_f32(f, shape) -> np.ndarray:
    n = int(np.prod(shape))
    raw = f.read(n * 4)
    if len(raw) != n * 4:
        raise ValueError(f"truncated fp32 tensor of shape {shape}")
    return np.frombuffer(raw, dtype="<f4").reshape(shape).copy()


def _read_bf16_as_f32(f, shape) -> np.ndarray:
    n = int(np.prod(shape))
    raw = f.read(n * 2)
    if len(raw) != n * 2:
        raise ValueError(f"truncated bf16 tensor of shape {shape}")
    u16 = np.frombuffer(raw, dtype="<u2").astype(np.uint32)
    return (u16 << 16).view(np.float32).reshape(shape).copy()


def _f32_to_bf16_bytes(arr: np.ndarray) -> bytes:
    u32 = np.ascontiguousarray(arr, dtype="<f4").view(np.uint32)
    # round-to-nearest-even, matching torch .to(bfloat16)
    rounded = ((u32 + 0x7FFF + ((u32 >> 16) & 1)) >> 16).astype("<u2")
    return rounded.tobytes()


def read_checkpoint(path: str) -> Tuple[GPT2Config, Dict[str, np.ndarray]]:
    """Parse a model .bin (either fp32 v1 or bf16 v2) into (config, params).

    bf16 params are upcast to fp32 numpy (the engine picks its own compute
    dtype); mirrors gpt2_build_from_checkpoint (train_gpt2.c:592-658)."""
    with open(path, "rb") as f:
        header = _read_header(f)
        if header[0] != MODEL_MAGIC:
            raise ValueError(f"bad model magic {header[0]}")
        version = int(header[1])
        if version not in (1, 2):
            raise ValueError(f"unsupported checkpoint version {version}")
        cfg = GPT2Config(max_seq_len=int(header[2]), vocab_size=int(header[3]),
                         num_layers=int(header[4]), num_heads=int(header[5]),
                         channels=int(header[6]))
        shapes = param_shapes(cfg)
        params: Dict[str, np.ndarray] = {}
        if version == 1:
            for name, shape in shapes.items():
                params[name] = _read_f32(f, shape)
        else:
            for name in BF16_ORDER:
                params[name] = _read_bf16_as_f32(f, shapes[name])
            for name in BF16_FP32_TAIL:
                params[name] = _read_f32(f, shapes[name])
        return cfg, params


def write_checkpoint(path: str, cfg: GPT2Config,
                     params: Dict[str, np.ndarray],
                     dtype: str = "float32") -> None:
    """Write a model .bin byte-identical to the reference writer
    (train_gpt2.py:300-326)."""
    version = {"float32": 1, "bfloat16": 2}[dtype]
    shapes = param_shapes(cfg)
    with open(path, "wb") as f:
        f.write(_make_header({0: MODEL_MAGIC, 1: version,
                              2: cfg.max_seq_len, 3: cfg.vocab_size,
                              4: cfg.num_layers, 5: cfg.num_heads,
                              6: cfg.channels}))
        if version == 1:
            for name, shape in shapes.items():
                arr = np.ascontiguousarray(params[name], dtype="<f4")
                if arr.shape != shape:
                    raise ValueError(f"{name}: shape {arr.shape}, expected "
                                     f"{shape}")
                f.write(arr.tobytes())
        else:
            for name in BF16_ORDER:
                f.write(_f32_to_bf16_bytes(params[name]))
            for name in BF16_FP32_TAIL:
                arr = np.ascontiguousarray(params[name], dtype="<f4")
                f.write(arr.tobytes())


def read_debug_state(path: str, cfg: GPT2Config) -> Dict[str, object]:
    """Parse a debug-state .bin into {x, y, logits, loss, grads}
    (reference reader: test_gpt2.c:39-66)."""
    with open(path, "rb") as f:
        header = _read_header(f)
        if header[0] != STATE_MAGIC:
            raise ValueError(f"bad state magic {header[0]}")
        if header[1] != 1:
            raise ValueError(f"unsupported state version {header[1]}")
        B, T = int(header[2]), int(header[3])
        x = np.frombuffer(f.read(B * T * 4), dtype="<i4").reshape(B, T).copy()
        y = np.frombuffer(f.read(B * T * 4), dtype="<i4").reshape(B, T).copy()
        logits = _read_f32(f, (B, T, cfg.vocab_size))
        loss = float(_read_f32(f, (1,))[0])
        grads = {name: _read_f32(f, shape)
                 for name, shape in param_shapes(cfg).items()}
        return {"x": x, "y": y, "logits": logits, "loss": loss, "grads": grads}


def write_debug_state(path: str, x: np.ndarray, y: np.ndarray,
                      logits: np.ndarray, loss: float,
                      grads: Dict[str, np.ndarray]) -> None:
    """Write a debug-state .bin (reference writer: train_gpt2.py:328-351);
    grads in the fp32 parameter order."""
    B, T = x.shape
    order = list(param_shapes(GPT2Config()))
    with open(path, "wb") as f:
        f.write(_make_header({0: STATE_MAGIC, 1: 1, 2: B, 3: T}))
        f.write(np.ascontiguousarray(x, dtype="<i4").tobytes())
        f.write(np.ascontiguousarray(y, dtype="<i4").tobytes())
        f.write(np.ascontiguousarray(logits, dtype="<f4").tobytes())
        f.write(np.float32(loss).tobytes())
        for name in order:
            f.write(np.ascontiguousarray(grads[name], dtype="<f4").tobytes())


def read_tokenizer_bin(path: str) -> List[bytes]:
    """Parse a tokenizer .bin into a token-id → raw-bytes table
    (reference reader: train_gpt2.c:1090-1122)."""
    with open(path, "rb") as f:
        header = _read_header(f)
        if header[0] != TOKENIZER_MAGIC:
            raise ValueError(f"bad tokenizer magic {header[0]}")
        if header[1] != 1:
            raise ValueError(f"unsupported tokenizer version {header[1]}")
        n = int(header[2])
        table: List[bytes] = []
        for _ in range(n):
            (length,) = struct.unpack("<B", f.read(1))
            if length == 0:
                raise ValueError("zero-length token")
            table.append(f.read(length))
        return table


def write_tokenizer_bin(path: str, table: List[bytes]) -> None:
    """Write a tokenizer .bin (reference writer: train_gpt2.py:353-367)."""
    for b in table:
        if not 0 < len(b) < 256:
            raise ValueError(f"token of {len(b)} bytes: the format holds "
                             "1 to 255")
    with open(path, "wb") as f:
        f.write(_make_header({0: TOKENIZER_MAGIC, 1: 1, 2: len(table)}))
        for b in table:
            f.write(struct.pack("<B", len(b)))
            f.write(b)


def read_token_stream(path: str) -> np.ndarray:
    """Raw int32 token stream (prepro_tinyshakespeare.py:56-78 output)."""
    return np.fromfile(path, dtype="<i4")


def write_token_stream(path: str, tokens: np.ndarray) -> None:
    np.ascontiguousarray(tokens, dtype="<i4").tofile(path)
