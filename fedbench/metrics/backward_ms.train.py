"""Milliseconds of a local step's backward: the port's span
``train.backward`` (``autograd.grad``, the periods' recompute included;
it waits for the card at its ends while traced) summed over the traced
window, over its count."""


def read(trace, counters):
    n = trace.span_count("train.backward")
    if n == 0:
        return None
    return 1e3 * trace.span_seconds("train.backward") / n
