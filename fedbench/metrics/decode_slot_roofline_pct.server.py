"""The per-client decode kernel's share of its roofline over the slots it
ran, %: ``decode_roofline_pct.server`` with the bound taken over every
slot launched, bucket padding included, so padding no longer reads as
the kernel's loss.  The bound of one launch at the mean slots a launch
(the port's counters ``decode.slots`` / ``decode.launches`` over the
traced window), times the launches, over the summed device time of the
kernel's launches, matched by name."""

from fedbench.bounds import decode_bound_s


def read(trace, counters):
    t = trace.op_seconds(counters["decode_kernel"])
    if t <= 0 or trace.span_count("server.offer") == 0:
        return None
    from repro_torch import obs

    tally = obs.traced()
    launches = tally["decode.launches"]
    if launches == 0:
        return None
    per_launch = decode_bound_s(counters["decode_shapes"], tally["decode.slots"] / launches,
                                1, counters["elem_bytes"])
    return 100.0 * per_launch * launches / t
