"""formats.py and tokenizer.py of the port against the JAX package's: a
file written by either package is byte-identical to the other's and
reads back to the same arrays (checkpoint v1 fp32 and v2 bf16 with
round-to-nearest-even, the debug state, the tokenizer .bin, the raw
token stream); the tokenizer decodes the same text (safe_printf
semantics)."""

import numpy as np
import pytest

from llmc_paged_tpu import formats as JF
from llmc_paged_tpu import tokenizer as JT
from llmc_paged_tpu_torch import formats as TF
from llmc_paged_tpu_torch import tokenizer as TT
from test_torch_common import jax_cfg, params_np, port_cfg


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_cross_package(tmp_path, dtype):
    cfg = port_cfg(num_layers=1)
    params = params_np(cfg, seed=2)
    assert TF.param_shapes(cfg) == JF.param_shapes(jax_cfg(num_layers=1))
    assert TF.num_params(cfg) == JF.num_params(jax_cfg(num_layers=1))
    tp, jp = tmp_path / "t.bin", tmp_path / "j.bin"
    TF.write_checkpoint(str(tp), cfg, params, dtype=dtype)
    JF.write_checkpoint(str(jp), jax_cfg(num_layers=1), params, dtype=dtype)
    assert _bytes(tp) == _bytes(jp)
    for path in (tp, jp):
        tcfg, tpar = TF.read_checkpoint(str(path))
        jcfg, jpar = JF.read_checkpoint(str(path))
        assert (tcfg.max_seq_len, tcfg.vocab_size, tcfg.num_layers,
                tcfg.num_heads, tcfg.channels) == \
            (jcfg.max_seq_len, jcfg.vocab_size, jcfg.num_layers,
             jcfg.num_heads, jcfg.channels)
        assert list(tpar) == list(jpar)
        for k in jpar:
            np.testing.assert_array_equal(tpar[k], jpar[k], err_msg=k)
    if dtype == "bfloat16":
        # round to nearest even: a value halfway between two bf16 numbers
        # goes to the even one
        x = np.array([1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8], np.float32)
        assert TF._f32_to_bf16_bytes(x) == JF._f32_to_bf16_bytes(x)
        np.testing.assert_array_equal(
            np.frombuffer(TF._f32_to_bf16_bytes(x), "<u2"),
            [0x3F80, 0x3F82])


def test_checkpoint_errors(tmp_path):
    cfg = port_cfg(num_layers=1)
    bad = dict(params_np(cfg), wte=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError, match="wte"):
        TF.write_checkpoint(str(tmp_path / "x.bin"), cfg, bad)
    (tmp_path / "short.bin").write_bytes(b"\0" * 12)
    with pytest.raises(ValueError, match="truncated"):
        TF.read_checkpoint(str(tmp_path / "short.bin"))


def test_debug_state_cross_package(tmp_path):
    cfg = port_cfg(num_layers=1)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 512, (2, 5)).astype(np.int32)
    y = rng.integers(0, 512, (2, 5)).astype(np.int32)
    logits = rng.standard_normal((2, 5, cfg.vocab_size)).astype(np.float32)
    grads = params_np(cfg, seed=4)
    TF.write_debug_state(str(tmp_path / "t.bin"), x, y, logits, 2.5, grads)
    JF.write_debug_state(str(tmp_path / "j.bin"), x, y, logits, 2.5, grads)
    assert _bytes(tmp_path / "t.bin") == _bytes(tmp_path / "j.bin")
    got = TF.read_debug_state(str(tmp_path / "j.bin"), cfg)
    want = JF.read_debug_state(str(tmp_path / "t.bin"),
                               jax_cfg(num_layers=1))
    for k in ("x", "y", "logits"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["loss"] == want["loss"] == 2.5
    for k in want["grads"]:
        np.testing.assert_array_equal(got["grads"][k], want["grads"][k])


def test_tokenizer_and_token_stream_cross_package(tmp_path):
    table = TT.byte_fallback_table(300)
    assert table == JT.byte_fallback_table(300)
    table[65] = "héllo".encode()
    table[66] = b"\xff\xfe"                 # invalid UTF-8: replaced
    TF.write_tokenizer_bin(str(tmp_path / "t.bin"), table)
    JF.write_tokenizer_bin(str(tmp_path / "j.bin"), table)
    assert _bytes(tmp_path / "t.bin") == _bytes(tmp_path / "j.bin")
    assert TF.read_tokenizer_bin(str(tmp_path / "j.bin")) == \
        JF.read_tokenizer_bin(str(tmp_path / "t.bin")) == table
    tt = TT.Tokenizer.from_file(str(tmp_path / "t.bin"))
    jt = JT.Tokenizer.from_file(str(tmp_path / "t.bin"))
    ids = list(range(-2, 305)) + [65, 10, 7, 9, 66]
    assert tt.decode_string(ids) == jt.decode_string(ids)
    assert tt.decode_safe(7) == "" and tt.decode_safe(10) == "\n"
    assert tt.decode(400) is None and tt.vocab_size == 300
    with pytest.raises(ValueError):
        TF.write_tokenizer_bin(str(tmp_path / "x.bin"), [b""])

    toks = np.random.default_rng(1).integers(0, 50257, 1000).astype(np.int32)
    TF.write_token_stream(str(tmp_path / "s_t.bin"), toks)
    JF.write_token_stream(str(tmp_path / "s_j.bin"), toks)
    assert _bytes(tmp_path / "s_t.bin") == _bytes(tmp_path / "s_j.bin")
    np.testing.assert_array_equal(
        TF.read_token_stream(str(tmp_path / "s_j.bin")), toks)
