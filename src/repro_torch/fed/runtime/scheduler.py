"""Continuous-round scheduler: admission-controlled, pipelined serving.

Torch port of ``repro/fed/runtime/scheduler.py``.  The host side — the
queues, the closure rule, the modeled float64 timeline — is numpy, as in
the reference, so every schedule figure is bitwise the reference's; only
the parameter versions and the cohort's compute and apply are tensors on
``core.device`` (through the port's encode, close and QSGD kernels).

The legacy driver (:func:`repro_torch.fed.runtime.engine._run_legacy`) runs
one synchronous cohort at a time: sample, wait for every upload (or
the deadline), apply, broadcast, repeat — so a 10⁶-client population
is bounded by round-trip latency, not bandwidth, and the paper's
dimension-free upload never gets to pay off.  This module is the
serving layer on top of :class:`repro_torch.fed.runtime.engine.EngineCore`
(DESIGN §10):

* **Admission controller** — waiting/running queues of client uploads
  in the continuous-batching style.  Frames arrive through the
  existing :class:`~repro_torch.fed.runtime.transport.UplinkChannel` wire
  codecs, so a queue entry holds the *decoded payload*, never the
  model: O(k) ≈ 28 bytes for fedscalar
  (:attr:`~repro_torch.fed.protocols.UplinkProtocol.queue_entry_bytes`),
  Θ(d) for the dense baselines — the paper's uplink asymmetry carried
  into server memory.
* **Quorum-xor-deadline closure** — a round closes the moment
  ``ceil(quorum_frac · C)`` uploads have landed, or at the deadline,
  whichever is earlier (:func:`quorum_close_time`); exactly one of
  the two reasons fires per round.  Under a partial close the realized
  cohort is an arrival-thinned subsample, so the on-time uploads are
  Horvitz–Thompson reweighted by ×C/A
  (:func:`~repro_torch.fed.runtime.sampling.realized_cohort_weights`) to
  keep the aggregate unbiased.
* **Pipelined rounds (async mode)** — round t+1 opens on a fixed
  cadence while round t is still draining, bounded by
  ``max_rounds_in_flight`` (eq. 12″,
  :func:`~repro_torch.fed.costmodel.pipelined_round_start`): a round's
  cohort computes on the params *version* drained by its open, so the
  model lag is ≤ the pipeline depth.  Post-close arrivals go to the
  waiting queue and are admitted into a later round with staleness
  discount s(τ) — the digest catch-up machinery prices their
  resync — or dropped past ``staleness_window``.
* **O(1) per-client server state** — one int32 last-synced-round per
  client plus scalar channel counters; the audit is part of the run
  result (``scheduler.client_state_bytes`` /
  ``agg_state_bytes_peak``) and pinned at 10⁶ clients in
  ``tests/test_torch_scheduler.py``.

Sync mode with ``quorum_frac=1.0`` reproduces the legacy loop's
operation sequence — same sampler draws, same channel RNG consumption,
same apply choices — and is asserted **bit-identical** to it for all
three protocols.  The async timeline is *modeled* (deterministic given
the seed): wall-clock follows the channel latencies through recurrence
(12″), while host apply time stays in ``apply_s`` exactly as the
legacy accounting keeps it, so throughput figures are reproducible in
CI.  The downlink rides its own channel and is priced separately
(two-sided accounting, DESIGN §9); the pipeline schedules the
compute + uplink side.

One deliberate asymmetry: the ×C/A correction makes each round's
*on-time* aggregate unbiased; late uploads admitted from the queue add
their (discounted) mass on top, trading a small bias for the variance
reduction of not discarding paid-for uploads — set
``staleness_window=0`` to refuse them entirely.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch.fed.costmodel import pipelined_round_start
from repro_torch.fed.runtime.sampling import realized_cohort_weights
from repro_torch.fed.runtime.server import Upload

__all__ = [
    "SchedulerConfig",
    "CohortBatch",
    "AdmissionController",
    "quorum_close_time",
    "run_scheduled",
]


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Policy of the continuous-round driver (DESIGN §10)."""

    mode: str = "sync"              # "sync" | "async"
    quorum_frac: float = 1.0        # close once ⌈q·C⌉ uploads landed
    period_s: float = 0.005         # async: round-open cadence
    max_rounds_in_flight: int = 8   # async: pipeline depth (sync: 1)
    staleness_window: int = 4       # async: max τ a queued upload survives
    arrival_correction: bool | None = None   # ×C/A HT reweighting of the
                                    # on-time cohort; None = on iff async
                                    # (sync default stays bit-identical
                                    # to the legacy loop)
    audit_queues: bool = False      # per-round queue-invariant assertions

    def __post_init__(self):
        if self.mode not in ("sync", "async"):
            raise ValueError(f"unknown scheduler mode {self.mode!r}; "
                             "want 'sync' or 'async'")
        if not 0.0 < self.quorum_frac <= 1.0:
            raise ValueError(f"quorum_frac must be in (0, 1]: {self.quorum_frac}")
        if self.mode == "async":
            if not (math.isfinite(self.period_s) and self.period_s > 0):
                raise ValueError(
                    f"async scheduling needs a finite period_s > 0: {self.period_s}")
            if self.max_rounds_in_flight < 1:
                raise ValueError(f"max_rounds_in_flight must be ≥ 1: "
                                 f"{self.max_rounds_in_flight}")
        if self.staleness_window < 0:
            raise ValueError(f"staleness_window must be ≥ 0: "
                             f"{self.staleness_window}")

    @property
    def corrected(self) -> bool:
        """Arrival-thinning HT correction resolved: on iff async unless
        pinned — the sync default must stay bit-identical to the
        legacy loop, which drops deadline stragglers *without*
        reweighting."""
        if self.arrival_correction is not None:
            return self.arrival_correction
        return self.mode == "async"

    def validate(self, cfg) -> None:
        """Cross-field checks against the :class:`RuntimeConfig`."""
        if self.mode == "async" and cfg.server.max_staleness > 0:
            raise ValueError(
                "async scheduler and ServerConfig.max_staleness > 0 are two "
                "competing staleness routers: the scheduler resolves τ from "
                "its own timeline (SchedulerConfig.staleness_window); keep "
                "max_staleness=0 (staleness_exponent still sets s(τ))")


def quorum_close_time(arrivals: np.ndarray, expected: int,
                      quorum_frac: float,
                      deadline: float = math.inf) -> tuple[float, str]:
    """When does a round stop admitting? → ``(close_offset, reason)``.

    ``arrivals`` are the offsets (from round open) of the uploads that
    will actually land (losses excluded); ``expected`` is the sampled
    cohort size the quorum is a fraction of.  Exactly one closure
    reason fires:

    * ``"quorum"``   — the ⌈q·C⌉-th arrival, if it beats the deadline,
    * ``"deadline"`` — the deadline, when the quorum does not arrive
      in time (or never),
    * ``"drained"``  — no finite deadline and the quorum is
      unreachable (losses): close when everything has arrived.
    """
    need = max(1, int(math.ceil(quorum_frac * expected)))
    arr = np.sort(np.asarray(arrivals, np.float64))
    if len(arr) >= need:
        t = float(arr[need - 1])
        if t <= deadline:
            return t, "quorum"
    if math.isfinite(deadline):
        return float(deadline), "deadline"
    return (float(arr[-1]) if len(arr) else 0.0), "drained"


@dataclasses.dataclass
class CohortBatch:
    """One round's late uploads, parked as arrays (struct-of-arrays).

    A queue entry is the decoded wire frame plus routing metadata —
    payload_dim float32 + seed u32 + id i64 + HT weight f64 + arrival
    stamp f64 per upload (``UplinkProtocol.queue_entry_bytes``), so
    the waiting queue is O(k) per entry for fedscalar and never holds
    model state.
    """

    encoded_round: int
    client_ids: np.ndarray    # (M,) int64
    seeds: np.ndarray         # (M,) uint32
    payloads: np.ndarray      # (M, payload_dim) float32
    weights: np.ndarray       # (M,) float64 Horvitz–Thompson w
    arrival_abs: np.ndarray   # (M,) float64 absolute arrival time

    def __len__(self) -> int:
        return len(self.client_ids)

    @property
    def nbytes(self) -> int:
        return (self.client_ids.nbytes + self.seeds.nbytes
                + self.payloads.nbytes + self.weights.nbytes
                + self.arrival_abs.nbytes)

    def select(self, mask: np.ndarray) -> "CohortBatch":
        return CohortBatch(
            encoded_round=self.encoded_round,
            client_ids=self.client_ids[mask], seeds=self.seeds[mask],
            payloads=self.payloads[mask], weights=self.weights[mask],
            arrival_abs=self.arrival_abs[mask])


class AdmissionController:
    """Waiting/running discipline over late uploads.

    The *running* set of a round is whatever the streaming aggregator
    holds for it (on-time offers plus admissions); the *waiting* queue
    parks uploads that missed their round's close until a later round
    closes after their arrival.  Invariant (audited with
    ``audit_queues``): each upload — keyed ``(encoded_round,
    client_id)`` — sits in exactly one place; admission moves it
    atomically out of waiting, expiry (τ beyond the window) drops it.
    Batches stay in round order and cohort ids arrive sorted, so
    admission order is deterministic.
    """

    def __init__(self, audit: bool = False):
        self.waiting: list[CohortBatch] = []
        self.audit_enabled = bool(audit)
        self.total_enqueued = 0

    def enqueue(self, batch: CohortBatch) -> None:
        if len(batch) == 0:
            return
        self.waiting.append(batch)
        self.total_enqueued += len(batch)
        if self.audit_enabled:
            self.audit()

    def admit_up_to(self, close_abs: float, current_round: int,
                    window: int) -> tuple[list[tuple[CohortBatch, int]], int]:
        """Move every upload admissible at this round's close.

        → ``(admitted, dropped)``: batches (with their τ = current −
        encoded round) whose arrival beat ``close_abs`` and whose
        staleness is within the window; uploads already beyond the
        window are dropped outright — they can only get staler.
        """
        admitted: list[tuple[CohortBatch, int]] = []
        dropped = 0
        keep: list[CohortBatch] = []
        for b in self.waiting:
            tau = current_round - b.encoded_round
            if tau > window:
                dropped += len(b)
                continue
            mask = b.arrival_abs <= close_abs
            if mask.any():
                admitted.append((b.select(mask), tau))
            rest = b.select(~mask)
            if len(rest):
                keep.append(rest)
        self.waiting = keep
        if self.audit_enabled:
            self.audit(admitted)
        return admitted, dropped

    def num_entries(self) -> int:
        return sum(len(b) for b in self.waiting)

    def state_bytes(self) -> int:
        return sum(b.nbytes for b in self.waiting)

    def audit(self, admitted: list[tuple[CohortBatch, int]] = ()) -> None:
        """Assert the one-place-per-upload invariant (DESIGN §10)."""
        seen: set[tuple[int, int]] = set()
        for group in (self.waiting, [b for b, _ in admitted]):
            for b in group:
                for cid in b.client_ids:
                    key = (b.encoded_round, int(cid))
                    if key in seen:
                        raise AssertionError(
                            f"upload {key} present in two scheduler queues")
                    seen.add(key)


def run_scheduled(core, init_params) -> dict:
    """Drive ``core.cfg.rounds`` rounds under ``core.cfg.scheduler``."""
    sched = core.cfg.scheduler
    if sched.mode == "sync":
        return _run_sync(core, init_params, sched)
    return _run_async(core, init_params, sched)


def _corrected_weights(cohort, arrived: np.ndarray) -> np.ndarray:
    """Full-length weight vector with the ×C/A thinning correction
    applied to the arrived members (everyone else keeps plain HT —
    those entries are dropped, queued with their own weight, or lost,
    so the on-time aggregate is what the correction must fix)."""
    a = int(arrived.sum())
    if a == 0 or a == len(arrived):
        return cohort.agg_weights
    w = np.array(cohort.agg_weights, np.float64)
    w[arrived] = realized_cohort_weights(cohort, arrived)
    return w


def _run_sync(core, init_params, sched: SchedulerConfig,
              summary: bool = True) -> dict:
    """Admission-controlled synchronous serving: one round in flight.

    With ``quorum_frac=1.0`` the effective close equals the config
    deadline and every upload is offered in the legacy order with the
    legacy cutoff: this is the legacy loop itself
    (:func:`~repro_torch.fed.runtime.engine._run_legacy` calls it with
    ``summary=False``, so its history has no ``"scheduler"`` key), and
    the reference's two loops agree with it bitwise for all three
    protocols (``tests/test_torch_scheduler.py``).  A quorum < 1
    closes rounds at the ⌈q·C⌉-th arrival instead — wall-clock drops
    with the straggler tail — and the arrival correction (if enabled)
    reweights the realized cohort.
    """
    cfg = core.cfg
    agg, cm = core.agg, core.cm
    uplink, downlink = core.uplink, core.downlink
    params = init_params
    K = cfg.rounds
    hist = core.new_history(K)
    deadline = cfg.server.deadline_s
    t0 = time.perf_counter()

    starts = np.zeros(K)
    closes = np.zeros(K)
    clock = 0.0
    closed_by_quorum = 0
    offered_total = 0
    agg_bytes_peak = 0

    with torch.no_grad():
        for k in range(K):
            cohort = core.sampler.sample(k)
            ids = cohort.client_ids
            if core.digest_mode:
                catchup_bits, _, resyncs = downlink.catch_up_batch(
                    core.client_last[ids], k)
                downlink_bits = catchup_bits
                hist["catchup_bits"][k] = catchup_bits
                hist["dense_resyncs"][k] = resyncs
            else:
                downlink_bits = downlink.broadcast()

            c = len(ids)
            offered_total += c
            rs_np, seeds_np = core.compute_cohort(params, k, ids)
            tx = uplink.transmit(rs_np[:c], seeds_np[:c]) if c else None

            # --- quorum-xor-deadline closure (the effective cutoff) ---
            if c and sched.quorum_frac < 1.0:
                eff_deadline, reason = quorum_close_time(
                    tx.latency_s[~tx.lost], c, sched.quorum_frac, deadline)
                closed_by_quorum += reason == "quorum"
            else:
                eff_deadline = deadline   # quorum = C ⇒ legacy cutoff, bit-identical

            weights = cohort.agg_weights
            if sched.corrected and c:
                arrived = (~tx.lost) & (tx.latency_s <= eff_deadline)
                weights = _corrected_weights(cohort, arrived)

            core.offer_uploads(ids, weights, k, tx, deadline_s=eff_deadline)
            agg_bytes_peak = max(agg_bytes_peak, agg.state_bytes())

            aseeds, acoeffs, ars, st = agg.close_round(k)
            params, use_kernel, apply_s = core.apply_round(
                params, aseeds, acoeffs, ars, c, st)
            hist["apply_s"][k] = apply_s
            if core.digest_mode:
                downlink_bits += core.close_digest(k, aseeds, acoeffs, ars, st,
                                                   ids, params, use_kernel)

            # --- cost accounting (legacy formulas, effective deadline) ---
            async_mode = (cfg.server.max_staleness > 0
                          and math.isfinite(cfg.server.round_period_s))
            if c:
                bits, wall, energy = cm.cohort_round_cost(
                    tx.latency_s, core.codec.bits_per_upload,
                    deadline_s=eff_deadline)
            else:
                bits, energy, wall = 0.0, 0.0, cm.t_other
            if async_mode:
                wall = cfg.server.round_period_s

            starts[k] = clock
            clock += wall
            closes[k] = clock

            core.record_round(hist, k, c, st, bits, downlink_bits, wall, energy)
            if k % cfg.eval_every == 0 or k == K - 1:
                loss, acc = core.evaluate(params)
                hist["loss"][k] = float(loss)
                hist["accuracy"][k] = float(acc)

    if not summary:
        return core.finalize(params, hist, t0)
    makespan = float(clock) if K else 0.0
    extra = dict(scheduler=_scheduler_summary(
        sched, core, starts, closes, closes, makespan, offered_total,
        closed_by_quorum=closed_by_quorum, stale_admitted=0, stale_dropped=0,
        queue_peak_entries=0, queue_peak_bytes=0, queue_leftover=0,
        agg_state_bytes_peak=agg_bytes_peak, params_lag_max=0))
    return core.finalize(params, hist, t0, extra)


def _run_async(core, init_params, sched: SchedulerConfig) -> dict:
    """Pipelined serving: up to ``max_rounds_in_flight`` rounds overlap.

    Deterministic modeled timeline.  Round k opens at
    ``max(start_{k−1} + period, drain_{k−depth})`` (eq. 12″); its
    cohort catches up to and computes on the params **version** v_k
    drained by that open (lag ≤ depth), uploads ride the channel, and
    the round closes by quorum or deadline.  Post-close arrivals park
    in the admission controller's waiting queue and join a later
    round's close with staleness discount s(τ) — or are dropped past
    the window.  Server applies stay sequential (x_{k+1} = apply(x_k,
    buffers_k)): pipelining overlaps *client compute + uplink* spans,
    which is where the legacy loop serializes its wall-clock.
    """
    cfg = core.cfg
    serv = cfg.server
    agg = core.agg
    uplink, downlink = core.uplink, core.downlink
    K = cfg.rounds
    hist = core.new_history(K)
    deadline = serv.deadline_s
    t0 = time.perf_counter()

    period = sched.period_s
    depth = sched.max_rounds_in_flight
    window = sched.staleness_window
    bits_up = core.codec.bits_per_upload
    base_lat = cfg.channel.base_latency_s
    p_tx = cfg.channel.p_tx_watts
    t_other = core.cm.t_other

    ac = AdmissionController(audit=sched.audit_queues)
    head = init_params
    versions = {0: head}          # params after v applied rounds (≤ depth+1 kept)
    starts = np.zeros(K)
    closes = np.zeros(K)
    drains = np.zeros(K)
    lag = np.zeros(K, np.int64)

    closed_by_quorum = 0
    stale_admitted = 0
    stale_dropped = 0
    offered_total = 0
    queue_peak_entries = 0
    queue_peak_bytes = 0
    agg_bytes_peak = 0

    with torch.no_grad():
        for k in range(K):
            start = pipelined_round_start(k, starts, drains, period, depth)
            starts[k] = start
            # params version this round reads: rounds drained by its open
            v = int(np.searchsorted(drains[:k], start, side="right"))
            lag[k] = k - v

            cohort = core.sampler.sample(k)
            ids = cohort.client_ids
            c = len(ids)
            offered_total += c

            if core.digest_mode:
                # the cohort syncs to x_v — the version it will compute on —
                # via the bounded log (dense fallback past the window)
                catchup_bits, _, resyncs = downlink.catch_up_batch(
                    core.client_last[ids], v)
                downlink_bits = catchup_bits
                hist["catchup_bits"][k] = catchup_bits
                hist["dense_resyncs"][k] = resyncs
            else:
                downlink_bits = downlink.broadcast()

            rs_np, seeds_np = core.compute_cohort(versions[v], k, ids)
            tx = uplink.transmit(rs_np[:c], seeds_np[:c]) if c else None

            # --- closure: quorum over the fresh cohort, xor deadline ---
            if c:
                close_lat, reason = quorum_close_time(
                    tx.latency_s[~tx.lost], c, sched.quorum_frac, deadline)
                closed_by_quorum += reason == "quorum"
                close_off = t_other + close_lat
            else:
                close_off = t_other
            closes[k] = start + close_off

            if c:
                ontime = (~tx.lost) & (tx.latency_s <= close_lat)
                late = (~tx.lost) & ~ontime
                weights = (_corrected_weights(cohort, ontime)
                           if sched.corrected else cohort.agg_weights)
                # lost uploads are offered (→ lost_channel), on-time applied
                for i in np.where(tx.lost)[0]:
                    agg.offer_routed(Upload(
                        client_id=int(ids[i]), encoded_round=k,
                        seed=int(tx.seeds[i]), r=tx.r_hat[i],
                        agg_weight=float(weights[i]),
                        latency_s=float(tx.latency_s[i]), lost=True), k, 0)
                for i in np.where(ontime)[0]:
                    agg.offer_routed(Upload(
                        client_id=int(ids[i]), encoded_round=k,
                        seed=int(tx.seeds[i]), r=tx.r_hat[i],
                        agg_weight=float(weights[i]),
                        latency_s=float(tx.latency_s[i]), lost=False), k, 0)
                # post-close arrivals park in the waiting queue, original w
                if late.any():
                    ac.enqueue(CohortBatch(
                        encoded_round=k,
                        client_ids=np.asarray(ids[late], np.int64),
                        seeds=np.asarray(tx.seeds[late], np.uint32),
                        payloads=np.asarray(tx.r_hat[late], np.float32),
                        weights=np.asarray(cohort.agg_weights[late], np.float64),
                        arrival_abs=start + t_other + tx.latency_s[late]))

            # --- admit queued stragglers whose arrival beat this close ---
            admitted, dropped = ac.admit_up_to(closes[k], k, window)
            for _ in range(dropped):
                agg.note_dropped(k, kind="stale")
            stale_dropped += dropped
            for batch, tau in admitted:
                stale_admitted += len(batch)
                for i in range(len(batch)):
                    agg.offer_routed(Upload(
                        client_id=int(batch.client_ids[i]),
                        encoded_round=batch.encoded_round,
                        seed=int(batch.seeds[i]), r=batch.payloads[i],
                        agg_weight=float(batch.weights[i]),
                        latency_s=float(batch.arrival_abs[i] - starts[
                            batch.encoded_round]), lost=False), k, tau)

            queue_peak_entries = max(queue_peak_entries, ac.num_entries())
            queue_peak_bytes = max(queue_peak_bytes, ac.state_bytes())
            agg_bytes_peak = max(agg_bytes_peak, agg.state_bytes())

            # --- close, sequential apply on the head, digest broadcast ---
            aseeds, acoeffs, ars, st = agg.close_round(k)
            head, use_kernel, apply_s = core.apply_round(
                head, aseeds, acoeffs, ars, c, st)
            hist["apply_s"][k] = apply_s
            versions[k + 1] = head
            for old in [key for key in versions if key < k + 2 - depth]:
                del versions[old]
            if core.digest_mode:
                downlink_bits += core.close_digest(k, aseeds, acoeffs, ars, st,
                                                   ids, head, use_kernel)

            # drain = close (+ the downlink rides its own priced channel);
            # monotone — the digest log is append-ordered
            drains[k] = max(closes[k], drains[k - 1]) if k else closes[k]

            # --- accounting: modeled wall = drain increments (makespan) ---
            if c:
                air = np.clip(tx.latency_s - base_lat, 0.0, None)
                energy = float(p_tx * air.sum())
            else:
                energy = 0.0
            core.record_round(hist, k, c, st, float(c * bits_up), downlink_bits,
                              drains[k] - (drains[k - 1] if k else 0.0), energy)
            if k % cfg.eval_every == 0 or k == K - 1:
                loss, acc = core.evaluate(head)
                hist["loss"][k] = float(loss)
                hist["accuracy"][k] = float(acc)

    makespan = float(drains[-1]) if K else 0.0
    extra = dict(scheduler=_scheduler_summary(
        sched, core, starts, closes, drains, makespan, offered_total,
        closed_by_quorum=closed_by_quorum, stale_admitted=stale_admitted,
        stale_dropped=stale_dropped, queue_peak_entries=queue_peak_entries,
        queue_peak_bytes=queue_peak_bytes, queue_leftover=ac.num_entries(),
        agg_state_bytes_peak=agg_bytes_peak,
        params_lag_max=int(lag.max()) if K else 0))
    extra["scheduler"]["params_lag"] = lag
    return core.finalize(head, hist, t0, extra)


def _scheduler_summary(sched: SchedulerConfig, core, starts, closes, drains,
                       makespan: float, offered_total: int, **counters) -> dict:
    return dict(
        mode=sched.mode,
        quorum_frac=sched.quorum_frac,
        period_s=sched.period_s if sched.mode == "async" else None,
        max_rounds_in_flight=(sched.max_rounds_in_flight
                              if sched.mode == "async" else 1),
        staleness_window=sched.staleness_window,
        arrival_correction=sched.corrected,
        starts=starts, closes=closes, drains=drains,
        makespan_s=makespan,
        offered_uploads=offered_total,
        rounds_per_s=(len(starts) / makespan if makespan > 0 else 0.0),
        clients_per_s=(offered_total / makespan if makespan > 0 else 0.0),
        queue_entry_bytes=core.proto.queue_entry_bytes,
        client_state_bytes=(core.client_last.nbytes
                            if core.client_last is not None else 0),
        **counters,
    )
