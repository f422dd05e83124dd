"""Share of the attention calls that autograd records on the card which
train through the float32 flash kernels, %: 100 × the port's counter
``flash_train.calls`` / its counter ``attn.grad_calls`` over the traced
window (the forward's calls and the period checkpoints' recompute alike).
Read only where the trace holds the port's ``train.forward`` spans, so the
counters' tallies are this window's; a program without those counters
reads nothing."""


def read(trace, counters):
    if trace.span_count("train.forward") == 0:
        return None
    from repro_torch import obs

    tally = obs.traced()
    calls = tally.get("attn.grad_calls", 0)
    if calls <= 0:
        return None
    return 100.0 * tally.get("flash_train.calls", 0) / calls
