"""Share of the decode's slots that carried no upload, %: 100 × (1 −
the applied uploads / the cohort rows the tree decode ran over the
traced window, the port's counter ``decode.slots``, bucket padding
included).  Read only where the trace holds the port's spans, so the
counter's tally is this window's."""


def read(trace, counters):
    if trace.span_count("server.offer") == 0:
        return None
    from repro_torch import obs

    slots = obs.traced()["decode.slots"]
    if slots <= 0:
        return None
    return 100.0 * (1.0 - sum(counters["applied"]) / slots)
