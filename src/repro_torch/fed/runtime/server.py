"""Server round state machine: streaming per-upload aggregation.

Copy of ``repro/fed/runtime/server.py`` (numpy only), with the close in
the span ``server.close`` (:mod:`repro_torch.obs`).

The server buffers each upload's decoded **frame payload** plus its
aggregation coefficient:

    per upload:   (payload, ξ, coefficient)   — payload_dim + 2 numbers
    per round:    append-only buffers of those triples

For the FedScalar protocol the payload is two scalars, so server
memory is O(cohort) — not O(cohort·d) — and reconstruction (the only
d-sized work) happens **lazily** once per round close, over whatever
arrived.  That is what makes a 10⁵-client round simulable.  The dense
baseline protocols (fedavg / qsgd frames, DESIGN §8) flow through the
same machinery with payload_dim = Θ(d): the state machine is
identical, the memory asymmetry *is* the paper's point.

Round lifecycle (DESIGN.md §5):

    OPEN     — uploads stream in; each is accepted, deferred (async
               staleness) or dropped (deadline / channel loss / too
               stale),
    CLOSING  — at the deadline the buffers are frozen,
    APPLY    — ĝ = Σ coeff_i · v(ξ_i) is reconstructed and applied by
               the engine (fori loop or a CUDA decode kernel),

where coefficient_i = w_i · s(τ_i) folds the Horvitz–Thompson weight
w_i = 1/(N·π_i) with the staleness discount s(τ) = (1+τ)^(−β) for an
upload arriving τ rounds after it was encoded.  τ = 0 uploads have
s = 1 for any β, so the async path degenerates to the synchronous one
when nothing is late.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch import obs

__all__ = ["ServerConfig", "Upload", "RoundStats", "StreamingAggregator"]


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Round-close policy of the streaming server."""

    deadline_s: float = math.inf      # uploads later than this are stragglers
    round_period_s: float = math.inf  # wall length of one round (async lateness unit)
    max_staleness: int = 0            # τ_max; 0 = fully synchronous
    staleness_exponent: float = 0.0   # β in s(τ) = (1+τ)^(−β)
    min_cohort: int = 1               # skip the model update below this many arrivals

    def staleness_weight(self, tau: int) -> float:
        return float((1.0 + tau) ** (-self.staleness_exponent))


@dataclasses.dataclass(frozen=True)
class Upload:
    """One decoded uplink packet, annotated by the transport."""

    client_id: int
    encoded_round: int      # round whose params the client started from
    seed: int               # ξ (uint32; 0 for seedless dense frames)
    r: np.ndarray           # (payload_dim,) float32 decoded frame payload
    agg_weight: float       # Horvitz–Thompson w = 1/(N·π)
    latency_s: float        # dispatch → arrival
    lost: bool = False      # dropped by the channel


@dataclasses.dataclass
class RoundStats:
    """Arrival accounting for one server round."""

    round_idx: int
    offered: int = 0             # uploads dispatched at this round
    lost_channel: int = 0
    dropped_deadline: int = 0
    dropped_stale: int = 0
    deferred: int = 0            # accepted, but applying in a later round
    applied: int = 0             # uploads folded into this round's update
    applied_stale: int = 0       # … of which arrived with τ ≥ 1
    max_tau: int = 0
    weight_sum: float = 0.0      # Σ w_i (E ≈ 1 under correct IPW)
    skipped: bool = False        # below min_cohort → no model update


class StreamingAggregator:
    """Accumulates (r̂, ξ, coeff) triples; O(1) state per upload.

    ``offer`` routes each upload to the round it will be applied in;
    ``close_round`` freezes and returns that round's buffers.  Pending
    buffers for future rounds (async stragglers) survive across closes.
    """

    def __init__(self, cfg: ServerConfig):
        self.cfg = cfg
        self._pending: dict[int, list[tuple[int, float, np.ndarray]]] = {}
        self._stats: dict[int, RoundStats] = {}

    def _stat(self, k: int) -> RoundStats:
        return self._stats.setdefault(k, RoundStats(round_idx=k))

    def offer(self, up: Upload, deadline_s: float | None = None) -> str:
        """Route one upload → 'applied' | 'deferred' | 'lost' | 'dropped'.

        ``deadline_s`` overrides the config deadline for this upload —
        the continuous scheduler closes rounds at min(quorum time,
        deadline), so the *effective* cut-off is per-round, not a
        config constant.  ``None`` (the legacy engine) keeps the config
        deadline, bit-identically.
        """
        st = self._stat(up.encoded_round)
        st.offered += 1
        if up.lost:
            st.lost_channel += 1
            return "lost"
        cfg = self.cfg
        if cfg.max_staleness <= 0:
            # synchronous: miss the (effective) deadline → dropped straggler
            cutoff = cfg.deadline_s if deadline_s is None else deadline_s
            if up.latency_s > cutoff:
                st.dropped_deadline += 1
                return "dropped"
            tau = 0
        else:
            # asynchronous: lateness in whole round periods, capped at τ_max
            period = cfg.round_period_s
            tau = 0 if not math.isfinite(period) or period <= 0 else int(
                up.latency_s // period)
            if tau > cfg.max_staleness:
                st.dropped_stale += 1
                return "dropped"
        apply_round = up.encoded_round + tau
        coeff = up.agg_weight * cfg.staleness_weight(tau)
        self._pending.setdefault(apply_round, []).append(
            (up.seed, coeff, np.asarray(up.r, np.float32), tau))
        if tau > 0:
            st.deferred += 1
            return "deferred"
        return "applied"

    def offer_routed(self, up: Upload, apply_round: int, tau: int) -> str:
        """Scheduler-decided routing: apply round and τ come from the caller.

        The continuous scheduler resolves staleness from its modeled
        timeline (which round was open when the upload landed), not
        from the ``latency // period`` heuristic :meth:`offer` uses, so
        it routes explicitly.  All accounting lands on ``apply_round``
        — the round whose close will report it — never on the encoded
        round: closed rounds evict their stats at :meth:`close_round`
        and must not be reopened by a late arrival.
        """
        st = self._stat(apply_round)
        st.offered += 1
        if up.lost:
            st.lost_channel += 1
            return "lost"
        coeff = up.agg_weight * self.cfg.staleness_weight(tau)
        self._pending.setdefault(apply_round, []).append(
            (up.seed, coeff, np.asarray(up.r, np.float32), tau))
        if tau > 0:
            st.deferred += 1
            return "deferred"
        return "applied"

    def note_dropped(self, round_idx: int, kind: str = "stale") -> str:
        """Count a scheduler-dropped upload (stale window / deadline miss)
        against the currently open round ``round_idx``."""
        st = self._stat(round_idx)
        st.offered += 1
        if kind == "stale":
            st.dropped_stale += 1
        else:
            st.dropped_deadline += 1
        return "dropped"

    def state_bytes(self) -> int:
        """Approximate resident bytes of pending buffers + open stats.

        O(#pending uploads); the scheduler audits this once per round
        to pin the O(cohort·k) — never O(d), never O(population) —
        server-state bound (``tests/test_scheduler.py``).
        """
        total = 0
        for buf in self._pending.values():
            for _, _, r, _ in buf:
                total += r.nbytes + 24       # seed u32 + coeff f64 + τ pad
        total += 96 * len(self._stats)       # RoundStats slots still open
        return total

    def close_round(self, k: int):
        """Freeze round k → (seeds (A,) u32, coeffs (A,), rs (A, payload_dim), stats).

        A is the number of uploads applying at k — this round's on-time
        arrivals plus stale arrivals deferred from earlier rounds.
        Arrays come out sorted by (seed) nowhere — they keep arrival
        order, which the engine sorts by client id upstream, so the
        aggregation order is deterministic.  The round's stats record
        is **evicted** on close (every offer for round k precedes its
        close in both the legacy loop and the scheduler), so the
        aggregator's footprint is bounded by the rounds in flight —
        previously ``_stats`` kept one record per round forever.
        """
        with obs.span("server.close"):
            buf = self._pending.pop(k, [])
            st = self._stats.pop(k, None) or RoundStats(round_idx=k)
            st.applied = len(buf)
            st.weight_sum = float(sum(coeff for _, coeff, _, _ in buf))
            st.applied_stale = sum(1 for _, _, _, tau in buf if tau > 0)
            st.max_tau = max((tau for _, _, _, tau in buf), default=0)
            st.skipped = st.applied < self.cfg.min_cohort
            if not buf:
                return (np.zeros(0, np.uint32), np.zeros(0, np.float64),
                        np.zeros((0, 1), np.float32), st)
            seeds = np.asarray([b[0] for b in buf], np.uint32)
            coeffs = np.asarray([b[1] for b in buf], np.float64)
            rs = np.stack([b[2] for b in buf]).astype(np.float32)
            return seeds, coeffs, rs, st

    def pending_rounds(self) -> list[int]:
        """Rounds with deferred uploads not yet closed (drain at shutdown)."""
        return sorted(self._pending)
