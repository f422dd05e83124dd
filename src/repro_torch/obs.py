"""Spans and counters of the port, read through ``torch.profiler``.

The profiler is the one switch.  While none records, :func:`span` hands
back a shared null context after one flag check, and :func:`count` adds
to a process total.  While one records, a span is a
``record_function`` range, a CPU user annotation on the trace's clock
beside the device's operations (it nests inside whatever range the
caller holds), and a count also adds to that recording's tally.

Names in use, each read by a per-layer metric of the benchmark or named
in its trace's breakdown of the device's idle time:

* spans ``server.offer`` (``EngineCore.offer_uploads``), ``server.close``
  (``StreamingAggregator.close_round``), ``server.stage`` (the apply's
  staging: bucket padding on the routes that pad, and host → device
  copies) and ``server.launch`` (the protocol's ``server_apply`` up to
  its return, before the synchronise);
* spans of the training round (``launch/train.py``; each waits for the
  device at its ends while traced): ``train.forward`` (a local step's
  loss), ``train.backward`` (its ``autograd.grad``, which holds the
  periods' recompute), ``train.update`` (the in-place step ``w −= α·g``,
  and δ = ψ − x after the last step), ``train.encode`` (a client's
  encode) and ``train.close`` (the round's close); the counter
  ``train.tokens`` (the tokens through local steps);
* counters ``decode.slots`` (the cohort rows a tree decode computes: the
  applied uploads on the engine's decode-kernel route on the card, bucket
  padding included on the routes that pad), and the kernel launches
  ``decode.launches``, ``close.launches``, ``encode.launches``,
  ``qsgd.launches``, ``flash.launches`` (the calls of ``flash_attention``
  that launched), ``flash_prefill.launches``, ``flash_decode.launches``,
  ``flash_f32.launches`` and ``flash_bwd.launches``;
* counters of attention under autograd (``models/attention.py``):
  ``attn.grad_calls`` (every call autograd records on the card or meta)
  and ``flash_train.calls`` (those that train through the float32 flash
  kernels).

:func:`device_time` reads a finished recording: the device's busy time
as the union of its operations' intervals, and its idle time split by
the span the host was in.
"""
from __future__ import annotations

import collections
import contextlib

import torch

_NULL = contextlib.nullcontext()
_enabled = torch._C._autograd._profiler_enabled

_totals: collections.Counter = collections.Counter()
_traced: collections.Counter = collections.Counter()
_recording = False          # whether the last call found a profiler recording


def _tracing() -> bool:
    """Whether a profiler records; a recording is new when the last call
    found none, and its tally then starts from zero."""
    global _recording
    on = _enabled()
    if on and not _recording:
        _traced.clear()
    _recording = on
    return on


def span(name: str, sync=None):
    """A ``record_function(name)`` range while a profiler records, else a
    shared null context.  With ``sync`` (a device), a recorded range also
    waits for that device at its start and at its end, so that its length
    is the device's time for the work enqueued inside it; a range that
    does not wait measures the host's enqueue, which runs ahead of the
    device."""
    if not _tracing():
        return _NULL
    if sync is None or torch.device(sync).type != "cuda":
        return torch.profiler.record_function(name)
    return _synced(name, torch.device(sync))


@contextlib.contextmanager
def _synced(name: str, device: torch.device):
    torch.cuda.synchronize(device)
    with torch.profiler.record_function(name):
        yield
        torch.cuda.synchronize(device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the process total of ``name``, and to the recording's
    tally while a profiler records."""
    _totals[name] += n
    if _tracing():
        _traced[name] += n


def totals() -> collections.Counter:
    """A copy of the process totals (0 for a name never counted)."""
    return collections.Counter(_totals)


def traced() -> collections.Counter:
    """A copy of the tally of the latest recording."""
    return collections.Counter(_traced)


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


def _merged(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def device_time(prof) -> dict:
    """Device time of a finished ``torch.profiler`` recording, seconds on
    the trace's clock over its window (first event to last):
    ``window_s``; ``busy_s``, the union of the device operations'
    intervals (operations that overlap count once); ``idle_s``, the rest
    of the window, by the innermost span (``record_function`` range) the
    host was in at each instant (``None``: outside every span)."""
    from torch.autograd import DeviceType

    host, dev = [], []
    for e in prof.events():
        a, b = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == DeviceType.CPU:
            host.append((e.name, a, b, getattr(e, "is_user_annotation", False)))
        elif e.device_type == DeviceType.CUDA:
            dev.append((e.name, a, b))
    if not host and not dev:
        return {"window_s": 0.0, "busy_s": 0.0, "idle_s": {}}
    # A span's device mirror carries its name: it is no device operation.
    names = {n for n, _, _, user in host if user}
    busy = _merged([(a, b) for n, a, b in dev if n not in names])
    lo = min(a for _, a, *_ in host + dev)
    hi = max(b for _, _, b, *_ in host + dev)
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    spans = [(n, a, b) for n, a, b, user in host if user]
    return {"window_s": hi - lo, "busy_s": sum(b - a for a, b in busy),
            "idle_s": idle_by_span(gaps, spans)}


def print_device_time(prof, label: str) -> None:
    """Print :func:`device_time` of ``prof`` on one line."""
    t = device_time(prof)
    w = t["window_s"]
    idle = ", ".join(f"{n or 'outside spans'} {s * 1e3:.3f} ms"
                     for n, s in sorted(t["idle_s"].items(), key=lambda kv: -kv[1]))
    print(f"{label}: traced window {w * 1e3:.3f} ms, device busy "
          f"{t['busy_s'] * 1e3:.3f} ms ({100 * t['busy_s'] / w if w else 0.0:.2f}%), "
          f"idle by span: {idle or 'none'}")
