"""The FLOP and byte counters and the window's spreading of deliveries,
against counts made by hand."""

import math

import pytest

from benchmarks import roofline, window


def test_linear_and_lm_head_flops_by_hand():
    # GPT-2 124M: 12 layers of 12·768² weights, two operations a MAC
    assert roofline.linear_flops(12, 768) == 2 * 12 * (
        768 * 2304 + 768 * 768 + 768 * 3072 + 3072 * 768)
    assert roofline.lm_head_flops(768, 50257) == 2 * 768 * 50257


def test_prefill_flops_by_hand():
    L, C, V, n = 2, 8, 10, 3
    lin = 3 * roofline.linear_flops(L, C)
    # queries attend 1, 2 and 3 keys: 4·ctx·C·L each
    att = 4 * (1 + 2 + 3) * C * L
    assert roofline.prefill_flops(L, C, V, n, 1) == lin + att + 2 * C * V
    assert roofline.prefill_flops(L, C, V, n, 3) == lin + att + 3 * 2 * C * V


def test_decode_flops_by_hand():
    assert roofline.decode_flops(2, 8, 10, 5) == (
        2 * 12 * 2 * 64 + 4 * 5 * 8 * 2 + 2 * 8 * 10)


def test_kv_bytes_per_token_matches_the_int8_page_layout():
    # 1558M: K and V int8 (2 x 64 bytes a head) and two f32 scales a head
    assert roofline.kv_bytes_per_token(48, 25, 64, "int8") == \
        48 * 25 * (2 * 64 + 8)
    assert roofline.kv_bytes_per_token(12, 12, 64, "bfloat16") == \
        12 * 12 * 64 * 2 * 2
    # bench.py's formula: L·NH·HS·(2 + 8/HS)
    assert roofline.kv_bytes_per_token(48, 25, 64, "int8") == \
        pytest.approx(48 * 25 * 64 * (2.0 + 8.0 / 64))


def test_parts_call_bytes_by_hand():
    # two live rows of 130 and 5 tokens, one idle row; NH 2, HS 4, ps 128
    got = roofline.parts_call_bytes([130, 5, 0], B=3, NH=2, HS=4, ps=128)
    kv = (130 + 5) * 2 * (2 * 4 + 2 * 4)         # int8 K, V and two scales
    tables = 4 * (2 + 1)                           # live pages' entries
    q = 2 * 2 * 4 * 4                              # f32 q of live rows
    out = 3 * 2 * (4 + 2) * 4                      # acc, m, l of all rows
    assert got == kv + tables + q + out
    assert roofline.parts_call_flops([130, 5, 0], 2, 4) == 4 * 135 * 2 * 4


def test_bounds_take_the_larger_side():
    b = roofline.parts_call_bound_s([1000], 1, 25, 64, 128)
    assert b == pytest.approx(
        roofline.parts_call_bytes([1000], 1, 25, 64, 128)
        / roofline.PEAK_HBM_BYTES)
    n, NH, HS = 1000, 25, 64
    C = NH * HS
    flops = 2 * n * (n + 1) * C
    nbytes = 8 * n * C
    assert roofline.flash_call_bound_s([n], NH, HS) == pytest.approx(
        max(flops / roofline.PEAK_BF16_FLOPS, nbytes / roofline.PEAK_HBM_BYTES))


def _record(deliveries, lo, hi):
    return {"deliveries": deliveries, "t_open": lo, "t_close": hi,
            "seconds": hi - lo}


def test_window_spreads_each_delivery_over_its_interval():
    # [t, prev, out, prompt, flops]
    d = [[2.0, 0.0, 100, 0, 0.0],     # half inside [1, 11]
         [6.0, 2.0, 40, 0, 0.0],      # inside
         [12.0, 6.0, 60, 0, 0.0],     # 5 of its 6 s inside
         [14.0, 12.0, 999, 0, 0.0]]   # outside
    rec = _record(d, 1.0, 11.0)
    assert window.in_window(rec, window.OUT) == pytest.approx(50 + 40 + 50)
    assert window.rate(rec, window.OUT) == pytest.approx(14.0)


def test_window_counts_an_instant_delivery_inside_it_whole():
    rec = _record([[3.0, 3.0, 7, 0, 0.0], [20.0, 20.0, 5, 0, 0.0]], 1, 11)
    assert window.in_window(rec, window.OUT) == 7


def test_p95():
    assert window.p95([]) is None
    assert window.p95(list(range(101))) == pytest.approx(95.0)


def test_each_kind_of_delivery_is_spread_since_its_own_last():
    # a wave's first tokens come out after the host has dispatched the
    # link that follows; the link's tokens are spread since the last
    # link's, over the whole time they were computed
    import torch

    from benchmarks.harness import Loop
    from llmc_paged_tpu_torch.engine.scheduler import Request

    t = [0.0]
    loop = Loop(None, 1, 10.0, 0, {"n_layer": 1, "n_embd": 8,
                                   "vocab_size": 10}, {}, None,
                torch.device("cpu"), clock=lambda: t[0])
    r = Request(rid=0, prompt=[1, 2], max_new_tokens=99)
    for when, toks in ((4.0, [5]), (5.0, [6, 7]), (9.0, [8] * 4),
                       (10.0, [9] * 4)):
        t[0] = when
        loop.epoch += 1
        loop.on_tokens(r, toks)
    got = [(d[0], d[1], d[2], d[6]) for d in loop.deliveries]
    assert got == [(4.0, 0.0, 1, "first"), (5.0, 0.0, 2, "decode"),
                   (9.0, 5.0, 4, "decode"), (10.0, 9.0, 4, "decode")]
