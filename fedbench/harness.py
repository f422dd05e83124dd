"""What every driver shares: the run's context, its spans, the trace and the weights.

A driver builds its system in set-up, calls :meth:`Run.window_begin`,
drives the window, calls :meth:`Run.window_end`, then checks what the
window produced.  With ``--trace 1`` the run's spans, around the
harness's calls into each layer of the program, are ``record_function``
ranges in the profiler's trace, which :class:`Trace` reads back with the
device's operations.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import numpy as np
import torch

from fedbench.traffic import M64


@dataclasses.dataclass
class Trace:
    """A traced window: device operations and host spans, seconds on one clock."""

    window: tuple                      # (start, end)
    device_ops: list                   # [(name, start, end)]
    spans: list                        # [(name, start, end)]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        return union_s([(a, b) for _, a, b in self.device_ops], self.window)

    def op_seconds(self, match: str) -> float:
        """Summed device seconds of operations whose name holds ``match``."""
        return sum(b - a for n, a, b in self.device_ops if match in n)

    def span_seconds(self, name: str) -> float:
        return sum(b - a for n, a, b in self.spans if n == name)

    def span_count(self, name: str) -> int:
        return sum(1 for n, _, _ in self.spans if n == name)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        the innermost span the host was in when each gap began."""
        by_op: dict[str, float] = {}
        for n, a, b in self.device_ops:
            by_op[n] = by_op.get(n, 0.0) + (b - a)
        gaps: dict[str, float] = {}
        for a, b in idle_gaps([(a, b) for _, a, b in self.device_ops], self.window):
            inner = [(s1 - s0, n) for n, s0, s1 in self.spans
                     if s0 <= a < s1 and n not in ("window_open", "window_close")]
            name = min(inner)[1] if inner else "outside spans"
            gaps[name] = gaps.get(name, 0.0) + (b - a)
        order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa: E731
        return {"device_ops": [[n, s] for n, s in order(by_op)],
                "idle_gaps": [[n, s] for n, s in order(gaps)]}


def merged(intervals, window):
    """Intervals clipped to ``window``, sorted and merged."""
    lo, hi = window
    out = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def union_s(intervals, window) -> float:
    """Seconds of ``window`` covered by at least one interval."""
    return sum(b - a for a, b in merged(intervals, window))


def idle_gaps(intervals, window):
    """The stretches of ``window`` that no interval covers."""
    out, t = [], window[0]
    for a, b in merged(intervals, window):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if window[1] > t:
        out.append((t, window[1]))
    return out


class Run:
    """One run of one cell."""

    def __init__(self, *, config: dict, traffic: dict, seed: int, seconds: float,
                 trace: bool, device: torch.device, t_start: float):
        self.config, self.traffic = config, traffic
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device, self.t_start = device, t_start
        self._prof = None
        self.t_window = None
        self.setup_s = None
        self.window_s = None
        self.peak_bytes = None
        self.traced: Trace | None = None
        self.marks: list = [("start", t_start)]

    def mark(self, name: str) -> None:
        """Note the end of a stage of set-up (printed on standard error)."""
        self.sync()
        self.marks.append((name, time.perf_counter()))

    def stages(self) -> str:
        return ", ".join(f"{n} {b - a:.3f} s" for (_, a), (n, b) in
                         zip(self.marks, self.marks[1:]))

    def span(self, name: str):
        """A call into the program: a ``record_function`` range when traced."""
        if self._prof is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window_begin(self) -> None:
        self.sync()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        if self.trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
        with self.span("window_open"):
            pass
        self.mark("window starts")
        self.t_window = self.marks[-1][1]
        self.setup_s = self.t_window - self.t_start

    def window_end(self) -> None:
        """Close the window after the device has finished its work."""
        self.sync()
        self.window_s = time.perf_counter() - self.t_window
        if self.device.type == "cuda":
            self.peak_bytes = torch.cuda.max_memory_allocated(self.device)
        if self._prof is not None:
            with self.span("window_close"):
                pass
            self._prof.stop()
            self.traced = _read_trace(self._prof)
            self._prof = None


def _read_trace(prof) -> Trace:
    """Device operations and the harness's spans from the profiler's events
    (microseconds on the trace's own clock), in seconds; the window runs
    from the start of ``window_open`` to the end of ``window_close``."""
    from torch.autograd import DeviceType

    spans, dev = [], []
    for e in prof.events():
        a, b = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if getattr(e, "is_user_annotation", False) and e.device_type == DeviceType.CPU:
            spans.append((e.name, a, b))
        elif e.device_type == DeviceType.CUDA:
            dev.append((e.name, a, b))
    names = {n for n, _, _ in spans}
    dev = [op for op in dev if op[0] not in names]      # the spans' device mirrors
    lo = min(a for n, a, _ in spans if n == "window_open")
    hi = max(b for n, _, b in spans if n == "window_close")
    return Trace(window=(lo, hi), device_ops=dev, spans=spans)


def leaf_paths(tree, prefix: str = "") -> list:
    """[(path, leaf)] in sorted-key order, the protocol's leaf ordinals."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in leaf_paths(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def init_std(path: str, shape: tuple) -> float | None:
    """The draw's scale for a leaf: None for a norm's scale (ones) or a
    bias (zeros); d^-½ for an embedding; fan-in^-½ for a matrix."""
    if path.endswith("/scale") or path.endswith("/bias") or path.endswith("/b"):
        return None
    if path.endswith("/embedding"):
        return shape[-1] ** -0.5
    return shape[-2] ** -0.5


def leaf_weights(path: str, shape: tuple, seed: int, tag: int, dtype, device):
    """One leaf drawn on ``device`` from ``(seed, tag)`` in one call."""
    std = init_std(path, shape)
    if std is None:
        fill = 1.0 if path.endswith("/scale") else 0.0
        return torch.full(shape, fill, dtype=dtype, device=device)
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 0x9E3779B97F4A7C15 + tag + 1) & (M64 >> 1))
    w = torch.randn(shape, generator=g, dtype=dtype, device=device)
    return w.mul_(std)


def make_weights(like, seed: int, device):
    """A tree shaped like ``like`` (meta tensors), drawn leaf by leaf."""
    tags = {id(leaf): (t, p) for t, (p, leaf) in enumerate(leaf_paths(like))}

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        tag, path = tags[id(node)]
        return leaf_weights(path, tuple(node.shape), seed, tag, node.dtype, device)

    return build(like)


def gather(params, tags: np.ndarray, flat: np.ndarray) -> np.ndarray:
    """The sampled elements' values of a tree, float64 (E,), in the sample's order."""
    out = []
    for tag, (_, leaf) in enumerate(leaf_paths(params)):
        idx = torch.from_numpy(flat[tags == tag]).to(leaf.device)
        out.append(leaf.reshape(-1)[idx].to(torch.float64).cpu().numpy())
    return np.concatenate(out)


def sample_elements(leaves, count: int, floor: int, seed: int):
    """A sample, drawn from the seed, of elements in every leaf →
    (tags, flat indices, rows, cols) as int64 numpy arrays."""
    sizes = np.array([int(np.prod(s)) for s in leaves], np.int64)
    total = sizes.sum()
    g = np.random.default_rng([int(seed) & M64, 7])
    tags, flat, rows, cols = [], [], [], []
    for tag, (shape, size) in enumerate(zip(leaves, sizes)):
        n = int(min(size, max(floor, round(count * size / total))))
        idx = np.sort(g.choice(size, n, replace=False)).astype(np.int64)
        c = int(shape[-1]) if len(shape) else 1
        tags.append(np.full(n, tag, np.int64))
        flat.append(idx)
        rows.append(idx // c)
        cols.append(idx % c)
    return tuple(np.concatenate(a) for a in (tags, flat, rows, cols))
