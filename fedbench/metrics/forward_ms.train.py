"""Milliseconds of a local step's forward, the loss: the port's span
``train.forward`` (which waits for the card at its ends while traced, so
its length is the device's time for the forward) summed over the traced
window, over its count."""


def read(trace, counters):
    n = trace.span_count("train.forward")
    if n == 0:
        return None
    return 1e3 * trace.span_seconds("train.forward") / n
