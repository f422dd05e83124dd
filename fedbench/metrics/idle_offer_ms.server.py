"""Device-idle ms a round while the host is inside the port's offer loop
(span ``server.offer``): idle time that moves uploads/s but lies outside
``close_ms_p95``'s timer.  Each instant of each idle gap goes to the
innermost port span covering it (``fedbench/spans.py``)."""

from fedbench.spans import port_idle_ms


def read(trace, counters):
    return port_idle_ms(trace, ("server.offer",))
