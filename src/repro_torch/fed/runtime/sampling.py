"""Client-population registry + per-round cohort sampling with IPW.

Copy of ``repro/fed/runtime/sampling.py`` (numpy only): the same
``np.random.RandomState`` per round, so cohorts are identical.

The server never touches per-client model state (a FedScalar upload is
two scalars), so the population registry is just numpy arrays — a
100k-client registry is ~1 MB.  What the sampler must get right is the
*statistics*: under partial participation the aggregated update

    ĝ = Σ_{n ∈ S_k}  w_n · r_n · v(ξ_n)

is an unbiased estimate of the full-participation mean (1/N)·Σ_n δ̂_n
iff  w_n = 1 / (N · π_n)  with π_n the inclusion probability of client
n (Horvitz–Thompson).  Each sampler below therefore reports its exact
inclusion probabilities alongside the cohort.

Samplers:

* ``uniform`` — C = round(q·N) clients drawn uniformly without
  replacement; π_n = C/N (so w_n = 1/C: the plain cohort mean).
* ``weighted`` — probability-proportional-to-size systematic sampling
  over the registry weights (e.g. shard sizes); π_n = min(1, C·p_n)
  after the standard iterative capping.
* ``poisson`` — every client tosses an independent coin with
  π_n = q (cohort size varies, including possibly zero).

Cohort ids are returned **sorted ascending** so the floating-point
aggregation order is a pure function of the sampled set — replaying a
round is bit-reproducible.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "ClientPopulation",
    "Cohort",
    "CohortSampler",
    "realized_cohort_weights",
    "sampling_diagnostic",
]


@dataclasses.dataclass(frozen=True)
class ClientPopulation:
    """Registry of the client universe.

    ``weights`` are relative sampling weights (e.g. local dataset
    sizes) used by the ``weighted`` sampler; None = uniform.
    """

    num_clients: int
    weights: np.ndarray | None = None

    def __post_init__(self):
        if self.num_clients <= 0:
            raise ValueError(f"empty population: {self.num_clients}")
        if self.weights is not None:
            w = np.asarray(self.weights, np.float64)
            if w.shape != (self.num_clients,) or np.any(w < 0) or w.sum() <= 0:
                raise ValueError("weights must be (N,) non-negative, not all zero")
            object.__setattr__(self, "weights", w)

    def probabilities(self) -> np.ndarray:
        """Normalized sampling weights p_n (uniform when weights=None)."""
        if self.weights is None:
            return np.full(self.num_clients, 1.0 / self.num_clients)
        return self.weights / self.weights.sum()


@dataclasses.dataclass(frozen=True)
class Cohort:
    """One round's sampled participants, with Horvitz–Thompson weights."""

    round_idx: int
    client_ids: np.ndarray        # (C,) int64, sorted ascending
    inclusion_probs: np.ndarray   # (C,) π_n of each member
    agg_weights: np.ndarray       # (C,) w_n = 1/(N·π_n)

    @property
    def size(self) -> int:
        return len(self.client_ids)


def _pps_inclusion_probs(p: np.ndarray, c: int) -> np.ndarray:
    """π_n for PPS sampling of expected size ``c``: iterative capping.

    π_n = min(1, c·p_n) is only consistent after redistributing the
    mass clipped at 1 — the standard fixed point: clients with
    c·p_n ≥ 1 are certainties, the remaining budget is spread
    proportionally over the rest.
    """
    n = len(p)
    pi = np.zeros(n)
    certain = np.zeros(n, dtype=bool)
    budget = float(c)
    for _ in range(n):  # converges in ≤ #certain iterations
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


class CohortSampler:
    """Deterministic per-round cohort draws over a :class:`ClientPopulation`."""

    KINDS = ("uniform", "weighted", "poisson")

    def __init__(self, population: ClientPopulation, participation: float,
                 kind: str = "uniform", seed: int = 0):
        if kind not in self.KINDS:
            raise ValueError(f"unknown sampler {kind!r}; want one of {self.KINDS}")
        if not 0.0 < participation <= 1.0:
            raise ValueError(f"participation must be in (0, 1]: {participation}")
        self.population = population
        self.participation = float(participation)
        self.kind = kind
        self.seed = int(seed)
        n = population.num_clients
        self._cohort_size = max(1, int(round(self.participation * n)))
        if kind == "weighted":
            self._pps_pi = _pps_inclusion_probs(
                population.probabilities(), self._cohort_size)

    def _rng(self, round_idx: int) -> np.random.RandomState:
        # splitmix-style fold of (seed, round) → independent per-round streams
        mask = 0xFFFFFFFF
        x = ((self.seed * 0x9E3779B9) & mask) ^ (round_idx & mask)
        x ^= x >> 16
        x = (x * 0x21F0AAAD) & mask
        return np.random.RandomState(x)

    def sample(self, round_idx: int) -> Cohort:
        n = self.population.num_clients
        rng = self._rng(round_idx)
        if self.kind == "uniform":
            c = self._cohort_size
            ids = np.sort(rng.choice(n, size=c, replace=False))
            pi = np.full(c, c / n)
        elif self.kind == "weighted":
            pi_all = self._pps_pi
            # systematic PPS: inclusion probability is exactly π_n
            cum = np.cumsum(pi_all)
            start = rng.uniform(0.0, 1.0)
            ticks = start + np.arange(int(np.ceil(cum[-1] - start)))
            ids = np.searchsorted(cum, ticks, side="right")
            ids = np.unique(ids[ids < n])
            pi = pi_all[ids]
        else:  # poisson
            mask = rng.random_sample(n) < self.participation
            ids = np.where(mask)[0]
            pi = np.full(len(ids), self.participation)
        weights = 1.0 / (n * pi)
        return Cohort(round_idx=round_idx, client_ids=ids.astype(np.int64),
                      inclusion_probs=pi, agg_weights=weights)


def realized_cohort_weights(cohort: Cohort, arrived: np.ndarray) -> np.ndarray:
    """HT weights of the **realized** cohort under arrival thinning.

    When a round closes by quorum (or deadline) before every sampled
    member has uploaded, the realized cohort is a thinned subsample:
    client n participates iff it was sampled (π_n) *and* its upload
    landed before the close.  Treating the close as an exchangeable
    thinning of the drawn cohort — arrival order is channel noise,
    independent of the client's update — the conditional inclusion
    probability given the draw is A/C (A arrivals of C sampled), so
    the unbiased weight is

        w̃_n = 1 / (N · π_n · (A/C)) = w_n · C / A,

    the Hájek-style correction: the surviving members absorb the
    missing mass so E[Σ w̃ · δ̂] still matches the full-participation
    mean.  ``arrived`` is a (C,) bool mask over ``cohort.client_ids``;
    returns the (A,) corrected weights aligned with
    ``cohort.client_ids[arrived]``.  With every member arrived the
    correction is ×1 and the plain HT weights come back unchanged.
    """
    arrived = np.asarray(arrived, bool)
    if arrived.shape != cohort.client_ids.shape:
        raise ValueError(
            f"arrived mask shape {arrived.shape} != cohort {cohort.client_ids.shape}")
    a = int(arrived.sum())
    if a == 0:
        return np.zeros(0, np.float64)
    scale = cohort.size / a
    return cohort.agg_weights[arrived] * scale


def sampling_diagnostic(sampler: CohortSampler, rounds: int = 200,
                        start_round: int = 0) -> dict:
    """Empirical unbiasedness check over ``rounds`` sampled cohorts.

    Returns the max relative error of the empirical inclusion marginals
    vs. the sampler's declared π, and the relative error of the
    Horvitz–Thompson estimate of a fixed per-client scalar field (a
    stand-in for δ̂_n) vs. its true population mean.
    """
    n = sampler.population.num_clients
    counts = np.zeros(n)
    values = 1.0 + (np.arange(n) % 97) / 97.0   # deterministic probe field
    est_sum = 0.0
    pi_ref = np.zeros(n)
    for k in range(start_round, start_round + rounds):
        cohort = sampler.sample(k)
        counts[cohort.client_ids] += 1
        pi_ref[cohort.client_ids] = cohort.inclusion_probs
        est_sum += float(np.sum(values[cohort.client_ids] * cohort.agg_weights))
    true_mean = float(values.mean())
    est_mean = est_sum / rounds
    sampled = pi_ref > 0
    marg_err = float(np.max(np.abs(counts[sampled] / rounds - pi_ref[sampled]))
                     ) if sampled.any() else float("nan")
    return dict(
        empirical_marginal_abs_err=marg_err,
        estimate_rel_err=abs(est_mean - true_mean) / abs(true_mean),
        probe_mean_true=true_mean,
        probe_mean_est=est_mean,
    )
