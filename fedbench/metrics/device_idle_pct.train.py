"""Share of the traced training window in which no operation ran on the card, %.

100 − the union of the device's operation intervals over the window."""


def read(trace, counters):
    if trace.window_s <= 0 or not trace.device_ops:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
