"""The training round's close against its roofline over the traced rounds, %.

The least time of each round's close (``bounds.decode_bound_s``: x read
and the new x written once in its dtype, the round's N clients, one
block), times the traced rounds (the harness's ``train_step`` spans),
over the summed device time of the per-client decode kernel's launches,
matched by name."""

from fedbench.bounds import decode_bound_s


def read(trace, counters):
    t = trace.op_seconds(counters["decode_kernel"])
    rounds = trace.span_count("train_step")
    if t <= 0 or rounds == 0:
        return None
    one = decode_bound_s(counters["decode_shapes"], counters["clients"], 1,
                         counters["elem_bytes"])
    return 100.0 * rounds * one / t
