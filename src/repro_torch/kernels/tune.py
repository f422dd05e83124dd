"""Autotuner of the fused close's bits-invariant knobs (port of ``repro/kernels/tune.py``).

The fused close has two performance knobs, and neither moves a bit
(``kernels/reconstruct_apply.py``'s docstring):

* the CUDA kernel's tile, one of :data:`CUDA_TILES` (``tree.CLOSE_TILES``:
  rows, threads across a row, and a 16-byte vector or one column a
  thread): live lanes on a narrow leaf against blocks in flight on a wide
  one.  It takes the place of the reference's Pallas ``(br, bc)``;
* the plain version's ``row_slab``, the rows it computes at once on the
  CPU: the size of its temporaries.

What could move bits (FUSED_CHUNK, the chunk order, the scale fold) is
fixed by the numeric spec and is not swept, so a tuned configuration is
always safe to swap in.

Winners are cached in a JSON file keyed by :func:`cache_key`, a **pure
function** of the workload ``(backend, rows, cols, cohort bucket, k,
distribution, dtype bits)``.  The backend comes from the explicit device
(:func:`backend_of`: ``cuda-sm_90a`` for a card of compute capability
9.0, ``cpu`` for the CPU), never from whether a card happens to be
present.  No clock, host or process enters the key.  A cache hit returns
the stored winner without timing anything; the first winner stored for a
key is never replaced (the file is read again just before a write), so
every process that asks sees the same knobs; writes are atomic (a
temporary file, then ``os.replace``).

The cohort is bucketed to the next power of two, at least FUSED_CHUNK,
as in the reference: the time is smooth in N, and the bucket keeps the
scheduler's varying round sizes on one entry.

Unlike the reference, no candidate is pruned by a compile budget: the
reference's jnp mirror unrolls (rows / slab) · (cohort / 16) bodies
under XLA, and eager PyTorch compiles nothing.  A slab larger than the
rows is still skipped.

The cache file is ``~/.cache/fedscalar-kernels/fused_tune_torch.json``,
or ``$REPRO_TORCH_TUNE_CACHE``.  It is not the reference's file: both
packages write ``cpu|…`` keys, with other candidates.
"""
from __future__ import annotations

import json
import os
import statistics
import time

import numpy as np
import torch

from repro_torch.kernels.reconstruct_apply import FUSED_CHUNK, fused_reconstruct_apply
from repro_torch.kernels.tree import CLOSE_TILES

__all__ = [
    "cache_key",
    "cohort_bucket",
    "backend_of",
    "autotune_fused",
    "cached_fused_params",
    "DEFAULT_CACHE_PATH",
    "MIRROR_ROW_SLABS",
    "CUDA_TILES",
]

DEFAULT_CACHE_PATH = os.environ.get(
    "REPRO_TORCH_TUNE_CACHE",
    os.path.join(os.path.expanduser("~"), ".cache", "fedscalar-kernels",
                 "fused_tune_torch.json"),
)

# Candidate spaces.  Plain slabs: None = the memory-bounded default.
MIRROR_ROW_SLABS = (None, 16, 64, 256)
CUDA_TILES = CLOSE_TILES


def cohort_bucket(cohort: int) -> int:
    """Next power of two ≥ cohort, floored at FUSED_CHUNK."""
    b = FUSED_CHUNK
    while b < cohort:
        b *= 2
    return b


def cache_key(backend: str, rows: int, cols: int, cohort: int, k: int,
              distribution: str, dtype_bits: int = 32) -> str:
    """Deterministic cache key — pure in its arguments, no ambient state."""
    return (f"{backend}|r{int(rows)}|c{int(cols)}|n{cohort_bucket(cohort)}"
            f"|k{int(k)}|{distribution}|b{int(dtype_bits)}")


def backend_of(device) -> str:
    """The backend field of a key for ``device``: ``cpu``, or ``cuda-sm_90a``
    for a card of compute capability 9.0 (``cuda-sm_<major><minor>`` for
    another card, which the kernels are not built for)."""
    device = torch.device(device)
    if device.type == "cpu":
        return "cpu"
    if device.type != "cuda":
        raise ValueError(f"no fused close on {device}")
    major, minor = torch.cuda.get_device_capability(device)
    return f"cuda-sm_{major}{minor}" + ("a" if (major, minor) == (9, 0) else "")


def _path(cache_path: str | None) -> str:
    return DEFAULT_CACHE_PATH if cache_path is None else cache_path


def _load(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _store(path: str, cache: dict) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(cache, f, indent=0, sort_keys=True)
    os.replace(tmp, path)


def _candidates(backend: str, rows: int, cols: int,
                cohort: int = FUSED_CHUNK) -> list[dict]:
    if backend.startswith("cuda"):
        return [{"impl": "cuda", "block": list(t), "row_slab": None}
                for t in CUDA_TILES]
    # The CPU: the plain version is the serving path.
    return [{"impl": "plain", "block": None, "row_slab": s}
            for s in MIRROR_ROW_SLABS if s is None or s <= rows]


def _default_measure(rows: int, cols: int, cohort: int, k: int,
                     distribution: str, dtype_bits: int, device):
    """Median of 3 times of one fused close under a candidate, after a
    warm-up: CUDA events on a card, ``perf_counter`` on the CPU."""
    device = torch.device(device)
    dtype = torch.bfloat16 if dtype_bits == 16 else torch.float32
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(rows, cols).astype(np.float32)).to(
        device=device, dtype=dtype)
    seeds = torch.from_numpy(
        rng.randint(0, 2**32, cohort, dtype=np.uint32).astype(np.int64)).to(device)
    rs = torch.from_numpy(rng.randn(cohort, k).astype(np.float32)).to(device)

    def call(cand: dict):
        return fused_reconstruct_apply(x, seeds, rs, 0, 0.01, distribution,
                                       block=cand["block"],
                                       row_slab=cand["row_slab"])

    def once(cand: dict) -> float:
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call(cand)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        call(cand)
        return time.perf_counter() - t0

    def measure(cand: dict) -> float:
        once(cand)                       # warm-up (and the kernels' build)
        return statistics.median(once(cand) for _ in range(3))

    return measure


def cached_fused_params(rows: int, cols: int, cohort: int, k: int,
                        distribution: str, dtype_bits: int = 32,
                        backend: str | None = None,
                        cache_path: str | None = None,
                        device="cuda") -> dict | None:
    """Cache-only lookup: the stored winner, or None.  Never times.

    ``backend`` defaults to :func:`backend_of` ``(device)``; ``cache_path``
    to :data:`DEFAULT_CACHE_PATH`."""
    if backend is None:
        backend = backend_of(device)
    key = cache_key(backend, rows, cols, cohort, k, distribution, dtype_bits)
    return _load(_path(cache_path)).get(key)


def autotune_fused(rows: int, cols: int, cohort: int, k: int,
                   distribution: str = "rademacher", dtype_bits: int = 32,
                   backend: str | None = None,
                   cache_path: str | None = None,
                   measure=None, device="cuda") -> dict:
    """Winner knobs for a fused workload, sweeping once and caching.

    Returns ``{"impl": "cuda"|"plain", "block": [rows, threads, vector]|None,
    "row_slab": int|None}``; ``block`` and ``row_slab`` go to
    ``ops.server_update_fused``.  A cache hit returns the stored winner as
    it is, without timing.  ``measure(candidate) -> seconds`` is
    injectable for tests; the default times the fused close on ``device``
    at the bucketed cohort (median of 3 after a warm-up), and then
    ``backend`` must be ``device``'s.
    """
    if backend is None:
        backend = backend_of(device)
    path = _path(cache_path)
    key = cache_key(backend, rows, cols, cohort, k, distribution, dtype_bits)
    hit = _load(path).get(key)
    if hit is not None:
        return hit
    cands = _candidates(backend, rows, cols, cohort)
    if measure is None:
        if backend != backend_of(device):
            raise ValueError(f"cannot time backend {backend} on {device}")
        measure = _default_measure(rows, cols, cohort_bucket(cohort), k,
                                   distribution, dtype_bits, device)
    timed = [(measure(c), i) for i, c in enumerate(cands)]
    best = cands[min(timed)[1]]
    # Read again before writing: another process may have stored keys (or
    # this one) while we timed.  The first stored winner stays.
    cache = _load(path)
    cache.setdefault(key, best)
    _store(path, cache)
    return cache[key]
