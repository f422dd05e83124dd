"""Device-idle ms a round while the host is inside the timed close before
the decode runs: the port's spans ``server.close`` (the aggregator's
close), ``server.stage`` (bucket padding, host → device copies) and
``server.launch`` (``server_apply`` up to its return).  Each instant of
each idle gap goes to the innermost port span covering it
(``fedbench/spans.py``)."""

from fedbench.spans import port_idle_ms


def read(trace, counters):
    return port_idle_ms(trace, ("server.close", "server.stage", "server.launch"))
