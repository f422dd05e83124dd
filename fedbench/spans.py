"""The port's own spans in a traced window, and the device's idle time
charged to them.

The port (``repro_torch/obs.py``) opens ``record_function`` ranges
inside the harness's: ``server.offer`` around the offer loop,
``server.close`` around the aggregator's close, ``server.stage`` around
the apply's bucket padding and host → device copies, ``server.launch``
around ``server_apply`` up to its return.  A program without them gives
no such span, and the readers that need them read nothing.
"""
from __future__ import annotations

from fedbench.harness import idle_gaps

PORT_SPANS = ("server.offer", "server.close", "server.stage", "server.launch")


def idle_by_span(gaps, spans) -> dict:
    """Each instant of each idle gap ``(a, b)`` charged to the innermost
    (shortest) of ``spans`` ``(name, start, end)`` that covers it, or to
    ``None`` outside them all → {name or None: seconds}."""
    marks = [(a, 2, -1) for a, _ in gaps] + [(b, -2, -1) for _, b in gaps]
    for i, (_, s0, s1) in enumerate(spans):
        marks += [(s0, 1, i), (s1, -1, i)]
    out: dict = {}
    active, idle, t_prev = set(), False, None
    for t, kind, i in sorted(marks):
        if idle and t > t_prev:
            inner = min(((spans[j][2] - spans[j][1], spans[j][0]) for j in active),
                        default=(0.0, None))[1]
            out[inner] = out.get(inner, 0.0) + (t - t_prev)
        t_prev = t
        if kind == 1:
            active.add(i)
        elif kind == -1:
            active.discard(i)
        else:
            idle = kind == 2
    return out


def port_idle_ms(trace, names) -> float | None:
    """Device-idle ms a round while the host was inside one of the port
    spans ``names``, each instant charged to the innermost port span over
    it (not to the span the host was in when the gap began); rounds are
    the ``server.offer`` spans.  None without device operations or port
    spans."""
    rounds = trace.span_count("server.offer")
    if rounds == 0 or not trace.device_ops:
        return None
    gaps = idle_gaps([(a, b) for _, a, b in trace.device_ops], trace.window)
    idle = idle_by_span(gaps, [s for s in trace.spans if s[0] in PORT_SPANS])
    return 1e3 * sum(idle.get(n, 0.0) for n in names) / rounds
