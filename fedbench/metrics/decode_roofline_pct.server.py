"""The per-client decode kernel's share of its roofline over the traced window, %.

The least time of each round's decode (``bounds.decode_bound_s``: the
uploads that applied, x read and written once in its dtype), summed,
over the summed device time of the kernel's launches, matched by name.
Padded slots of the cohort's bucket count as work the inputs do not
need, so they read as lost share."""

from fedbench.bounds import decode_bound_s


def read(trace, counters):
    t = trace.op_seconds(counters["decode_kernel"])
    if t <= 0:
        return None
    shapes, elem = counters["decode_shapes"], counters["elem_bytes"]
    bound = sum(decode_bound_s(shapes, a, 1, elem) for a in counters["applied"])
    return 100.0 * bound / t
