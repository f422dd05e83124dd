"""The client encode's share of its roofline over the traced rounds, %.

The least time of each client's encode (``bounds.encode_bound_s``: δ
read once in its dtype, one client, one block), summed over the traced
rounds' encodes, over the summed device time of the encode's tree
launch and its reduction, matched by name."""

from fedbench.bounds import encode_bound_s


def read(trace, counters):
    t = sum(trace.op_seconds(k) for k in counters["encode_kernels"])
    rounds = trace.span_count("train_step")
    if t <= 0 or rounds == 0:
        return None
    one = encode_bound_s(counters["encode_shapes"], 1, 1, counters["elem_bytes"])
    return 100.0 * rounds * counters["encodes_per_round"] * one / t
