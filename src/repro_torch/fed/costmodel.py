"""System-level cost model: wall-clock (eq. 12′), energy (eq. 13′), Table I.

Copy of ``repro/fed/costmodel.py`` (numpy only), so every cost figure of
the port is bitwise the reference's: the same ``np.random.RandomState``
stream is drawn in the same order.

    T_wall^(k)  = T_other^(k) + B_down^(k) / R_down + B_upload^(k) / R^(k)   (12′)
    E_round     = P_down · B_down / R_down + P_tx · B_upload / R             (13′)

R is the uplink rate in bits/s with a mean-one lognormal fluctuation,
T_other a fraction of FedAvg's nominal upload time (the same for every
method), P_tx = 2 W.  The downlink is deterministic (nominal R_down, no
draw), so pricing it never moves the uplink's RNG stream.  Access is
``concurrent`` (parallel uploads) or ``tdma`` (sequential slots).
Under the continuous-round scheduler the rounds overlap and the
wall-clock follows the pipelined recurrence (12″,
``pipelined_round_start``, ``pipeline_schedule``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "ChannelConfig",
    "CostModel",
    "upload_bits",
    "dense_upload_bits",
    "quantized_upload_bits",
    "dense_downlink_bits",
    "digest_downlink_bits",
    "DIGEST_HEADER_BITS",
    "BYTE_BITS",
    "FLOAT32_BYTES",
    "UINT32_BYTES",
    "FLOAT64_BYTES",
    "INT64_BYTES",
    "bits_to_bytes",
    "bytes_to_bits",
    "queue_entry_bytes",
    "replay_round_costs",
    "pipelined_round_start",
    "pipeline_schedule",
    "table1_upload_times",
]


def upload_bits(num_blocks: int = 1, scalar_bits: int = 32,
                seed_bits: int = 32) -> int:
    """Uplink payload per client per round for a k-block-scalar frame.

    Bytes — and therefore every wall-clock and energy figure eq. (12)/
    (13) produces — scale linearly with k (DESIGN §6): the k-dial
    trades exactly ``scalar_bits`` of uplink per unit of variance
    reduction bought.  Single source of the frame-size formula:
    ``WireFormat.bits_per_upload`` and ``DirectionFamily
    .bits_per_upload`` both delegate here.
    """
    return num_blocks * scalar_bits + seed_bits


def dense_upload_bits(d: int, value_bits: int = 32) -> int:
    """FedAvg-style dense frame: d values at full width (paper: d·32).

    Single source of the dense payload formula — the ``fedavg``
    protocol's wire codec and ``repro_torch.core.fedavg.upload_bits_per_
    client`` both delegate here, so Table I and the runtime's per-round
    accounting cannot drift apart.
    """
    return d * value_bits


def quantized_upload_bits(d: int, bits: int, num_norms: int = 1,
                          norm_bits: int = 32) -> int:
    """QSGD-style frame: d level codes at ``bits`` + the L2 norms.

    The paper's flat-vector formula is ``d·bits + 32`` (one norm); the
    deployed per-tensor quantizer carries one norm per leaf, hence
    ``num_norms``.  Single source for the ``qsgd`` protocol's wire
    codec and ``repro_torch.core.qsgd.upload_bits_per_client``.
    """
    return d * bits + num_norms * norm_bits


def dense_downlink_bits(d: int, float_bits: int = 32) -> int:
    """Dense downlink: the server broadcasts the full model, d floats.

    The paper's loop begins "server broadcasts x_k" — a Θ(d) downlink
    every round that eqs. (12)/(13) never priced.  Single source of the
    dense-broadcast payload: the ``dense`` :class:`repro_torch.fed.runtime.
    transport.DownlinkChannel` discipline, every protocol's default
    ``downlink_bits`` and the catch-up fallback resync all delegate
    here (DESIGN §9).
    """
    return d * float_bits


#: Round-digest wire header: round u32 | num_uploads u32 | k u32 | flags u32.
DIGEST_HEADER_BITS = 128


def digest_downlink_bits(num_uploads: int, num_blocks: int = 1,
                         scalar_bits: int = 32, seed_bits: int = 32,
                         include_coeffs: bool = True) -> int:
    """FedScalar digest downlink: O(C·k) scalars, independent of d.

    The server's update is a weighted sum of seed-generated directions,
    so broadcasting ``(seed, coefficient, r ∈ ℝᵏ)`` per applied upload
    (plus the :data:`DIGEST_HEADER_BITS` header) lets a stateful client
    replay the identical parameter step locally — the dimension-free
    downlink of the DeComFL line of work, transplanted (DESIGN §9).
    ``include_coeffs=False`` is the uniform-mean digest (full-arrival
    paper rounds): the per-upload coefficient column is implied 1/C and
    not shipped.  Single source for :class:`repro_torch.fed.runtime.
    transport.DigestCodec` and the engine's per-round accounting.
    """
    per_upload = seed_bits + num_blocks * scalar_bits
    if include_coeffs:
        per_upload += scalar_bits
    return DIGEST_HEADER_BITS + num_uploads * per_upload


#: Bits per octet — the only place the 8 lives (fedlint FS003).
BYTE_BITS = 8

#: Widths of the primitive wire/resident cells, in bytes.  Transport
#: codecs and the scheduler-queue accounting size their buffers from
#: these instead of re-deriving ``32 // 8`` locally, so a width change
#: propagates from exactly one definition.
FLOAT32_BYTES = 32 // BYTE_BITS
UINT32_BYTES = 32 // BYTE_BITS
FLOAT64_BYTES = 64 // BYTE_BITS
INT64_BYTES = 64 // BYTE_BITS


def bits_to_bytes(bits: int) -> int:
    """Whole octets for a bit count (wire frames are byte-aligned).

    Single source of the bits→bytes conversion: every codec's
    ``bytes_per_upload`` and the digest framing delegate here instead
    of hardcoding ``// 8`` (fedlint FS003).
    """
    if bits % BYTE_BITS:
        raise ValueError(f"payload of {bits} bits is not byte-aligned")
    return bits // BYTE_BITS


def bytes_to_bits(num_bytes: int) -> int:
    """Inverse of :func:`bits_to_bytes` for exact byte counts."""
    return num_bytes * BYTE_BITS


def queue_entry_bytes(payload_dim: int) -> int:
    """Resident bytes one *decoded* upload occupies in a server queue.

    payload_dim float32 scalars + seed u32 + client id i64 + HT weight
    f64 + arrival stamp f64.  Single source for ``UplinkProtocol.
    queue_entry_bytes`` — the admission controller's memory budget and
    the capacity report must price an entry identically (DESIGN §10).
    """
    return (payload_dim * FLOAT32_BYTES + UINT32_BYTES
            + INT64_BYTES + 2 * FLOAT64_BYTES)


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    bandwidth_bps: float = 0.1e6       # nominal uplink R
    lognormal_sigma: float = 0.25      # channel fluctuation (multiplicative)
    p_tx_watts: float = 2.0            # transmit power
    t_other_frac: float = 0.05         # T_other as fraction of FedAvg upload time
    access: str = "concurrent"         # or "tdma"
    num_clients: int = 20
    float_bits: int = 32
    # Runtime-subsystem extensions (defaults preserve the paper model):
    drop_prob: float = 0.0             # per-upload loss probability
    base_latency_s: float = 0.0        # fixed per-upload access latency
    # Downlink side of (12′)/(13′); None = symmetric with the uplink.
    downlink_bandwidth_bps: float | None = None   # R_down
    p_down_watts: float | None = None             # broadcast transmit power


class CostModel:
    """Accumulates bits / seconds / joules across rounds for one method."""

    def __init__(self, channel: ChannelConfig, fedavg_bits_per_client: int, rng_seed: int = 0):
        self.ch = channel
        self._rng = np.random.RandomState(rng_seed)
        # T_other is pegged to FedAvg's nominal upload time — the same
        # additive constant for every method (paper §III).
        fedavg_upload_s = fedavg_bits_per_client / channel.bandwidth_bps
        self.t_other = channel.t_other_frac * fedavg_upload_s

    def round_cost(self, bits_per_client: int) -> tuple[float, float, float]:
        """→ (uploaded_bits_total, wall_seconds, energy_joules) for one round."""
        ch = self.ch
        # lognormal channel draw, mean-one multiplicative fluctuation
        fluct = self._rng.lognormal(mean=-0.5 * ch.lognormal_sigma**2, sigma=ch.lognormal_sigma)
        rate = ch.bandwidth_bps * fluct
        per_client_s = bits_per_client / rate
        if ch.access == "tdma":
            upload_s = ch.num_clients * per_client_s
        else:
            upload_s = per_client_s
        total_bits = ch.num_clients * bits_per_client
        wall = self.t_other + upload_s
        # energy: every client transmits for per_client_s at P_tx
        energy = ch.num_clients * ch.p_tx_watts * per_client_s
        return float(total_bits), float(wall), float(energy)

    # ---- per-client vectorized interface (federation runtime) ----

    def per_client_upload_seconds(self, bits_per_client: int, n: int) -> np.ndarray:
        """One independent lognormal channel draw per cohort member.

        → ``(n,)`` upload durations in seconds (excluding ``t_other``).
        The paper's scalar :meth:`round_cost` draws one fluctuation for
        the whole round; the event-driven runtime needs per-upload
        arrival times, so each client gets its own draw.
        """
        ch = self.ch
        fluct = self._rng.lognormal(
            mean=-0.5 * ch.lognormal_sigma**2, sigma=ch.lognormal_sigma, size=n)
        return bits_per_client / (ch.bandwidth_bps * fluct) + ch.base_latency_s

    def per_client_drops(self, n: int) -> np.ndarray:
        """→ ``(n,)`` bool mask of uploads lost in the air (drop_prob)."""
        if self.ch.drop_prob <= 0.0:
            return np.zeros(n, dtype=bool)
        return self._rng.random_sample(n) < self.ch.drop_prob

    def cohort_round_cost(self, upload_seconds: np.ndarray,
                          bits_per_client: int,
                          deadline_s: float = np.inf) -> tuple[float, float, float]:
        """Aggregate per-upload durations → (bits, wall_s, energy_J).

        Concurrent access: all uploads start together; the round's
        upload phase ends when the slowest member finishes or the
        deadline cuts it off.  TDMA: dedicated slots run sequentially,
        and the deadline applies to the **cumulative elapsed slot
        time** — the round ends at ``min(Σ slots, deadline)``, never
        after the deadline (previously each slot was clipped
        individually, so K slots could bill up to K·deadline of wall).

        Energy bills each upload's time actually **on air**: the
        transmit window (access latency excluded), truncated where the
        deadline cut the round — a client whose upload was cut at the
        deadline stops radiating at the deadline, it does not burn its
        full nominal on-air time.  With ``deadline_s=inf`` both fixes
        are no-ops and the historical figures are bit-preserved.
        """
        n = len(upload_seconds)
        if n == 0:
            return 0.0, float(self.t_other), 0.0
        base = self.ch.base_latency_s
        if self.ch.access == "tdma":
            ends = np.cumsum(upload_seconds)           # cumulative elapsed time
            starts = ends - upload_seconds
            upload_s = float(min(ends[-1], deadline_s))
            # slot i is on air over [start_i + base, end_i] ∩ [0, deadline]
            air = np.clip(np.minimum(ends, deadline_s) - (starts + base),
                          0.0, None)
        else:
            clipped = np.minimum(upload_seconds, deadline_s)
            upload_s = float(np.max(clipped))
            air = np.clip(clipped - base, 0.0, None)
        energy = float(self.ch.p_tx_watts * np.sum(air))
        return float(n * bits_per_client), self.t_other + upload_s, energy

    # ---- downlink side of (12′)/(13′) ----

    @property
    def downlink_rate_bps(self) -> float:
        """R_down — defaults to the uplink's nominal R (symmetric link)."""
        ch = self.ch
        rate = ch.downlink_bandwidth_bps \
            if ch.downlink_bandwidth_bps is not None else ch.bandwidth_bps
        if rate <= 0:
            raise ValueError(f"downlink rate must be > 0, got {rate}")
        return rate

    def downlink_cost(self, bits: float) -> tuple[float, float, float]:
        """One round's downlink traffic → (bits, wall_s, energy_J).

        Deterministic by design: the broadcast rides the nominal
        R_down with no lognormal draw, so downlink accounting consumes
        **zero** draws from the uplink RNG stream — every pre-existing
        uplink latency/energy figure (and the fused-path replay
        identity of :func:`replay_round_costs`) stays bit-identical
        whether or not the downlink is priced.
        """
        if bits <= 0:
            return 0.0, 0.0, 0.0
        ch = self.ch
        seconds = bits / self.downlink_rate_bps
        p_down = ch.p_down_watts if ch.p_down_watts is not None else ch.p_tx_watts
        return float(bits), float(seconds), float(p_down * seconds)


def replay_round_costs(channel: ChannelConfig, bits_per_upload: int,
                       rounds: int, num_clients: int,
                       fedavg_bits_per_client: int, rng_seed: int = 0):
    """Per-round (bits, wall, energy) of K full-cohort homogeneous rounds.

    One lognormal latency draw per upload per round, aggregated by
    :meth:`CostModel.cohort_round_cost` — the **single source** of the
    engine's fused-path accounting (``repro_torch.fed.runtime.engine._run_
    fused``) and the baseline trade-off sweep's access-scheme replay
    (``repro_torch.fed.baselines``): same ``rng_seed`` → identical draws, so
    the two cannot drift.  → three ``(rounds,)`` arrays (not cumsum'd).
    """
    cm = CostModel(channel, fedavg_bits_per_client=fedavg_bits_per_client,
                   rng_seed=rng_seed)
    bits = np.zeros(rounds)
    wall = np.zeros(rounds)
    energy = np.zeros(rounds)
    for k in range(rounds):
        lat = cm.per_client_upload_seconds(bits_per_upload, num_clients)
        bits[k], wall[k], energy[k] = cm.cohort_round_cost(lat, bits_per_upload)
    return bits, wall, energy


# ---- overlapped rounds (eq. 12″): wall-clock under pipelining ----


def pipelined_round_start(k: int, starts: np.ndarray, drains: np.ndarray,
                          period_s: float, depth: int) -> float:
    """Admission time of round ``k`` under a depth-bounded pipeline.

    Round ``k`` opens at the cadence tick after round ``k−1`` opened,
    but never before its pipeline slot frees — i.e. before round
    ``k − depth`` has fully drained (closed, applied, and had its
    digest broadcast).  With ``depth = 1`` this degenerates to the
    synchronous recurrence ``start_k = drain_{k−1}`` (each round waits
    for the previous one end-to-end), which is exactly eq. (12′)
    summed over rounds; larger depths overlap upload phases with the
    apply/broadcast tail of earlier rounds:

        start_k = max(start_{k−1} + period,  drain_{k−depth})     (12″)

    ``starts`` / ``drains`` hold rounds ``0 … k−1`` (drains may be
    shorter when in-flight rounds have not drained yet — callers pass
    only drained prefixes; an unfilled slot blocks, so ``drains`` must
    cover index ``k − depth`` whenever ``k ≥ depth``).
    """
    if k == 0:
        return 0.0
    t = float(starts[k - 1]) + float(period_s)
    if depth >= 1 and k - depth >= 0:
        t = max(t, float(drains[k - depth]))
    return t


def pipeline_schedule(admit_spans: np.ndarray, drain_spans: np.ndarray,
                      period_s: float, depth: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full overlapped-round timeline from per-round spans.

    ``admit_spans[k]`` is how long round k accepts uploads after it
    opens (close − start; quorum- or deadline-determined, start-
    independent because latencies are drawn relative to the open).
    ``drain_spans[k]`` is the close → drained tail (apply + digest
    broadcast).  Applies recurrence (12″) round by round and returns
    ``(starts, closes, drains)``, with drains monotonized (a digest
    for round k cannot be broadcast before round k−1's — the downlink
    is a serial channel), so ``drains[-1]`` is the makespan.
    """
    n = len(admit_spans)
    starts = np.zeros(n)
    closes = np.zeros(n)
    drains = np.zeros(n)
    for k in range(n):
        starts[k] = pipelined_round_start(k, starts, drains, period_s, depth)
        closes[k] = starts[k] + float(admit_spans[k])
        drains[k] = closes[k] + float(drain_spans[k])
        if k > 0:
            drains[k] = max(drains[k], drains[k - 1])
    return starts, closes, drains


def table1_upload_times(
    d: int = 1000,
    rounds: int = 500,
    num_clients: int = 20,
    float_bits: int = 32,
    bandwidths_bps: tuple = (1e3, 10e3, 50e3, 100e3),
    budget_s: float = 1200.0,
):
    """Reproduce Table I: total upload time, concurrent vs TDMA.

    Returns a list of dict rows; ``†`` marks battery-budget violations.
    """
    rows = []
    payload = d * float_bits  # bits per client per round
    for bw in bandwidths_bps:
        per_round = payload / bw
        concurrent = rounds * per_round
        tdma = rounds * num_clients * per_round
        rows.append(
            dict(
                bandwidth_bps=bw,
                upload_time_per_round_s=per_round,
                concurrent_total_s=concurrent,
                concurrent_violates=concurrent > budget_s,
                tdma_total_s=tdma,
                tdma_violates=tdma > budget_s,
            )
        )
    return rows
