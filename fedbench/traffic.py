"""The one traffic generator: reads a traffic file's parameters, draws from ``--seed``.

Every draw comes from ``numpy.random.default_rng([seed, stream, index])``,
so the same seed gives the same inputs, and a round can be drawn alone.

``uploads`` — a federation's synchronous rounds as the server sees them.
The population's sample counts are lognormal; each round draws a cohort
by probability-proportional-to-size systematic sampling with its exact
inclusion probabilities π (the arithmetic of the port's weighted
``CohortSampler``, copied), and each upload carries the Horvitz–Thompson
weight w = 1/(N·π).  A fixed number of uploads is lost on the channel;
a straggler share of the cohort arrives past the deadline.  The shares
are a fixed grid over the traffic's range, each block of rounds taking
every grid point once in an order drawn from the seed: every seed gets
the same set of straggler shares, so a seed does not change the work.

``tokens`` — next-token training batches: ids uniform over the
vocabulary, labels the next ids; every row of every round drawn fresh.
"""
from __future__ import annotations

import numpy as np

M64 = (1 << 64) - 1
_POP, _ROUND, _BLOCK = 1, 2, 3


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & M64, *(int(s) & M64 for s in stream)])


def pps_inclusion_probs(p: np.ndarray, c: int) -> np.ndarray:
    """π for PPS sampling of expected size ``c`` by iterative capping:
    clients with c·p ≥ 1 are certain, the rest share what is left."""
    n = len(p)
    pi = np.zeros(n)
    certain = np.zeros(n, dtype=bool)
    budget = float(c)
    for _ in range(n):
        rest = ~certain
        scale = p[rest].sum()
        if scale <= 0 or budget <= 0:
            break
        cand = budget * p[rest] / scale
        newly = cand >= 1.0
        if not newly.any():
            pi[rest] = cand
            break
        idx = np.where(rest)[0][newly]
        certain[idx] = True
        pi[idx] = 1.0
        budget = c - certain.sum()
    pi[certain] = 1.0
    return np.clip(pi, 0.0, 1.0)


class Uploads:
    """The rounds of an ``uploads`` traffic file under one seed."""

    def __init__(self, tp: dict, seed: int):
        self.tp = tp
        self.seed = int(seed)
        n = int(tp["population"])
        g = rng(seed, _POP)
        self.sizes = g.lognormal(0.0, float(tp["sizes_lognormal_sigma"]), n)
        self.cohort = max(1, int(round(float(tp["participation"]) * n)))
        self.pi = pps_inclusion_probs(self.sizes / self.sizes.sum(), self.cohort)
        self.cum = np.cumsum(self.pi)
        lo, hi = tp["straggler_share"]
        self.grid = np.linspace(float(lo), float(hi), int(tp["straggler_levels"]))

    def straggler_share(self, k: int) -> float:
        levels = len(self.grid)
        order = rng(self.seed, _BLOCK, k // levels).permutation(levels)
        return float(self.grid[order[k % levels]])

    def round(self, k: int) -> dict:
        """Round ``k``: ids (C,) sorted, seeds uint32, r float32 (C, 1),
        weights float64, latency_s, lost."""
        tp, n = self.tp, len(self.pi)
        g = rng(self.seed, _ROUND, k)
        start = g.uniform(0.0, 1.0)
        ticks = start + np.arange(int(np.ceil(self.cum[-1] - start)))
        ids = np.searchsorted(self.cum, ticks, side="right")
        ids = np.unique(ids[ids < n]).astype(np.int64)
        c = len(ids)
        weights = 1.0 / (n * self.pi[ids])
        seeds = g.integers(0, 1 << 32, c, dtype=np.uint64).astype(np.uint32)
        r = (g.standard_normal(c) * float(tp["r_std"])).astype(np.float32)
        lost = np.zeros(c, bool)
        lost[g.choice(c, int(round(float(tp["loss_prob"]) * c)), replace=False)] = True
        live = np.flatnonzero(~lost)
        late = g.choice(live, min(len(live), int(round(self.straggler_share(k) * c))),
                        replace=False)
        deadline = float(tp["deadline_s"])
        latency = deadline * g.uniform(0.05, 0.95, c)
        latency[late] = deadline * g.uniform(1.05, 3.0, len(late))
        return {"ids": ids, "seeds": seeds, "r": r, "weights": weights,
                "latency_s": latency, "lost": lost}


def token_batch(tp: dict, vocab: int, seed: int, k: int):
    """Round ``k``'s ``(tokens, labels)``, int64 (rows, seq) each."""
    rows, seq = int(tp["rows_per_round"]), int(tp["seq_len"])
    ids = rng(seed, _ROUND, k).integers(0, vocab, (rows, seq + 1), dtype=np.int64)
    return ids[:, :-1], ids[:, 1:]
