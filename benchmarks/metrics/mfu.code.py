"""The FLOPs the window's real tokens need (roofline.prefill_flops and
decode_flops), over the window's seconds and the card's bf16 peak, in %."""
from benchmarks import roofline, window


def compute(record):
    return 100.0 * window.rate(record, window.FLOPS) / roofline.PEAK_BF16_FLOPS
