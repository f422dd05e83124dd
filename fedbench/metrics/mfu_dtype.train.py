"""The round's model FLOPs over the traced window, as a share of the card's
peak in the configuration's dtype, %.

The FLOPs are ``bounds.train_flops`` (forward and backward of every token
through a local step, no recompute counted) of the port's counter
``train.tokens`` over the window.  The peak is an H100 SXM's at 700 W:
989 TFLOP/s dense in bfloat16, and in float32 the CUDA cores' fused
multiply-add rate, 2 × 132 SMs × 128 lanes × 1.98 GHz = 66.9 TFLOP/s
(the port turns TF32 off, so float32 products stay off the tensor
cores).  Read only where the trace holds the harness's ``train_step``
spans, so the counter's tally is this window's."""

from fedbench.bounds import BF16_DENSE_FLOP_PER_S, train_flops

FP32_FLOP_PER_S = 2 * 132 * 128 * 1.98e9
PEAK_FLOP_PER_S = {"float32": FP32_FLOP_PER_S, "bfloat16": BF16_DENSE_FLOP_PER_S}


def read(trace, counters):
    if trace.span_count("train_step") == 0 or trace.window_s <= 0:
        return None
    from repro_torch import obs

    tokens = obs.traced()["train.tokens"]
    if tokens <= 0:
        return None
    m = counters["model"]
    flops = train_flops(m["n_nonembed"], m["d_model"], m["vocab"], m["layers"], m["heads"],
                        m["head_dim"], counters["seq_len"], tokens)
    return 100.0 * flops / (trace.window_s * PEAK_FLOP_PER_S[counters["dtype"]])
