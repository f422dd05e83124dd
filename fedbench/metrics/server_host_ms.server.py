"""The server's host time a round, ms: the offer loop, the aggregator's
close and the apply's wall time less the decode kernel's device time,
from the harness's spans around each call, over the traced rounds."""


def read(trace, counters):
    n = trace.span_count("apply_round")
    if n == 0:
        return None
    host = (trace.span_seconds("offer") + trace.span_seconds("close_round")
            + trace.span_seconds("apply_round") - trace.op_seconds(counters["decode_kernel"]))
    return 1e3 * host / n
