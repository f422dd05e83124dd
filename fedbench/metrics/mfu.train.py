"""The whole round's share of the card's bf16 dense peak, %.

The model FLOPs of the traced rounds (``bounds.train_flops``: forward
and backward of every local step, no recompute counted) over the traced
window's length times 989 TFLOP/s, an H100 SXM's bf16 dense peak at
700 W."""

from fedbench.bounds import BF16_DENSE_FLOP_PER_S


def read(trace, counters):
    rounds = trace.span_count("train_step")
    if rounds == 0 or trace.window_s <= 0:
        return None
    return 100.0 * rounds * counters["flops_per_round"] / (trace.window_s * BF16_DENSE_FLOP_PER_S)
