"""Port parity of the continuous-round scheduler (``fed/runtime/scheduler.py``).

* The host side is numpy in both packages: ``SchedulerConfig``'s
  refusals (same exceptions, same messages), ``quorum_close_time`` on
  seeded arrival sets, the admission controller's admitted batches and
  drop counts, and the pipelined recurrence (12″) are held **bitwise**.
* ``run_federation`` under a scheduler, the port on the CPU, against the
  reference, with both packages' batch draw patched to one numpy index
  table (the reference draws with threefry, which the port does not
  reproduce), at the reference test's own sizes: sync × {fedscalar,
  fedavg, qsgd} under drops, a finite deadline and partial
  participation; sync with the digest downlink and ``verify_replay``;
  sync at quorum 0.5 with the arrival correction; async fedscalar on the
  per-client decode route (stragglers re-admitted), on the fused route
  (staleness window 0: stragglers dropped) and with the digest downlink,
  and async qsgd.  Every stats and cost array, the schedule
  (``starts``, ``closes``, ``drains``, ``makespan_s``, ``params_lag``)
  and the scheduler's counters are equal; the loss within rtol 1e-5 and
  ``final_params`` within ``test_run_federation_matches_reference``'s
  tolerances: atol 1e-6 (local SGD's float32 sums run in other orders),
  plus, for qsgd, one flipped level per element and round.
* The port against itself: sync ≡ the legacy loop bit for bit for all
  three protocols and the digest downlink; async pipelining beats sync on
  the modeled makespan; the 10⁶-client state audit; no apply writes into
  a stored parameter version in place.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.fed import costmodel as jcm  # noqa: E402
from repro.fed.runtime import engine as jengine  # noqa: E402
from repro.fed.runtime import scheduler as jsched  # noqa: E402
from repro.fed.runtime import server as jserver  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.fed import costmodel as tcm  # noqa: E402
from repro_torch.fed.runtime import engine as tengine  # noqa: E402
from repro_torch.fed.runtime import scheduler as tsched  # noqa: E402
from repro_torch.fed.runtime import server as tserver  # noqa: E402
from torch_parity import (  # noqa: E402,F401
    STAT_KEYS,
    digits_shards,
    jax_kernels,
    mlp_params_np,
    patch_shared_draws,
)

# ---------------------------------------------------------------------------
# host-side units, bitwise
# ---------------------------------------------------------------------------

BAD_SCHEDULERS = {
    "mode": dict(mode="turbo"),
    "quorum_zero": dict(quorum_frac=0.0),
    "quorum_above_one": dict(quorum_frac=1.5),
    "period_inf": dict(mode="async", period_s=math.inf),
    "period_zero": dict(mode="async", period_s=0.0),
    "depth_zero": dict(mode="async", max_rounds_in_flight=0),
    "window_negative": dict(staleness_window=-1),
}


@pytest.mark.parametrize("case", list(BAD_SCHEDULERS))
def test_scheduler_config_refusals_match_reference(case):
    kw = BAD_SCHEDULERS[case]
    with pytest.raises(ValueError) as et:
        tsched.SchedulerConfig(**kw)
    with pytest.raises(ValueError) as ej:
        jsched.SchedulerConfig(**kw)
    assert str(et.value) == str(ej.value)


def test_scheduler_validate_and_correction_match_reference():
    for mode in ("sync", "async"):
        for corr in (None, True, False):
            t = tsched.SchedulerConfig(mode=mode, arrival_correction=corr)
            j = jsched.SchedulerConfig(mode=mode, arrival_correction=corr)
            assert t.corrected == j.corrected
    tcfg = tengine.RuntimeConfig(server=tserver.ServerConfig(max_staleness=1))
    jcfg = jengine.RuntimeConfig(server=jserver.ServerConfig(max_staleness=1))
    with pytest.raises(ValueError) as et:
        tsched.SchedulerConfig(mode="async").validate(tcfg)
    with pytest.raises(ValueError) as ej:
        jsched.SchedulerConfig(mode="async").validate(jcfg)
    assert str(et.value) == str(ej.value)
    tsched.SchedulerConfig(mode="sync").validate(tcfg)   # sync: no conflict


def test_quorum_close_time_bitwise():
    rng = np.random.RandomState(0)
    reasons = set()
    for trial in range(400):
        n = int(rng.randint(0, 10))
        arr = rng.lognormal(-3.0, 1.0, size=n)
        expected = n + int(rng.randint(0, 4))     # losses: may be unreachable
        q = float(rng.choice([0.05, 0.3, 0.5, 0.7, 1.0]))
        deadline = math.inf if trial % 3 == 0 else float(rng.uniform(0.0, 0.2))
        got = tsched.quorum_close_time(arr, expected, q, deadline)
        want = jsched.quorum_close_time(arr, expected, q, deadline)
        assert got[1] == want[1] and type(got[0]) is type(want[0])
        assert np.float64(got[0]).tobytes() == np.float64(want[0]).tobytes()
        reasons.add(got[1])
    assert reasons == {"quorum", "deadline", "drained"}
    assert tsched.quorum_close_time(np.zeros(0), 5, 0.5) == (0.0, "drained")


def _batch(mod, rng, k):
    m = int(rng.randint(0, 6))
    ids = np.sort(rng.choice(1000, size=m, replace=False)).astype(np.int64)
    return mod.CohortBatch(
        encoded_round=k, client_ids=ids,
        seeds=rng.randint(0, 2**32, size=m, dtype=np.uint64).astype(np.uint32),
        payloads=rng.randn(m, 2).astype(np.float32),
        weights=rng.uniform(0.5, 2.0, size=m),
        arrival_abs=k * 0.01 + rng.uniform(0.0, 0.05, size=m))


def test_admission_controller_matches_reference():
    """One enqueue/admit sequence → the same admitted batches (τ, every
    array), drops, queue sizes and bytes in both packages."""
    tac = tsched.AdmissionController(audit=True)
    jac = jsched.AdmissionController(audit=True)
    rt, rj = np.random.RandomState(5), np.random.RandomState(5)
    n_admitted = n_dropped = 0
    for k in range(30):
        tac.enqueue(_batch(tsched, rt, k))
        jac.enqueue(_batch(jsched, rj, k))
        close = k * 0.01 + 0.02
        window = 2 if k % 7 else 0
        ta, td = tac.admit_up_to(close, k, window)
        ja, jd = jac.admit_up_to(close, k, window)
        assert td == jd and len(ta) == len(ja)
        for (bt, taut), (bj, tauj) in zip(ta, ja):
            assert taut == tauj and bt.encoded_round == bj.encoded_round
            for f in ("client_ids", "seeds", "payloads", "weights", "arrival_abs"):
                np.testing.assert_array_equal(getattr(bt, f), getattr(bj, f))
            assert bt.nbytes == bj.nbytes
        assert tac.num_entries() == jac.num_entries()
        assert tac.state_bytes() == jac.state_bytes()
        assert tac.total_enqueued == jac.total_enqueued
        n_admitted += sum(len(b) for b, _ in ta)
        n_dropped += td
    assert n_admitted > 0 and n_dropped > 0        # both paths exercised


def test_admission_audit_refuses_a_duplicate():
    for mod in (tsched, jsched):
        ac = mod.AdmissionController(audit=True)
        b = mod.CohortBatch(encoded_round=3, client_ids=np.array([1, 2]),
                            seeds=np.zeros(2, np.uint32),
                            payloads=np.zeros((2, 1), np.float32),
                            weights=np.ones(2), arrival_abs=np.ones(2))
        ac.enqueue(b)
        with pytest.raises(AssertionError,
                           match=r"upload \(3, 2\) present in two scheduler queues"):
            ac.enqueue(b.select(np.array([False, True])))


def test_pipelined_recurrence_bitwise():
    rng = np.random.RandomState(1)
    for _ in range(50):
        n = int(rng.randint(1, 40))
        admit = rng.lognormal(-3.0, 0.8, size=n)
        drain = rng.uniform(0.0, 0.01, size=n)
        period = float(rng.choice([1e-3, 4e-3, 0.02]))
        depth = int(rng.randint(1, 9))
        got = tcm.pipeline_schedule(admit, drain, period, depth)
        want = jcm.pipeline_schedule(admit, drain, period, depth)
        for a, b in zip(got, want):
            assert a.tobytes() == b.tobytes()
        starts, _, drains = got
        for k in range(n):
            assert (tcm.pipelined_round_start(k, starts, drains, period, depth)
                    == jcm.pipelined_round_start(k, starts, drains, period, depth))


# ---------------------------------------------------------------------------
# run_federation under the scheduler, against the reference
# ---------------------------------------------------------------------------

SHARDS, S, B = 8, 5, 32
MAX_ROUNDS, MAX_POP = 8, 60


@pytest.fixture(scope="module")
def digits8():
    return digits_shards(SHARDS)


@pytest.fixture
def shared_draws(digits8, monkeypatch):
    """Patch both packages' ``draw_cohort_batches`` with one index table."""
    patch_shared_draws(monkeypatch, digits8[0], 78, MAX_ROUNDS, MAX_POP, S, B)


SCHEDULE_KEYS = ("starts", "closes", "drains")
COUNTER_KEYS = ("mode", "quorum_frac", "period_s", "max_rounds_in_flight",
                "staleness_window", "arrival_correction", "makespan_s",
                "offered_uploads", "rounds_per_s", "clients_per_s",
                "queue_entry_bytes", "client_state_bytes", "closed_by_quorum",
                "stale_admitted", "stale_dropped", "queue_peak_entries",
                "queue_peak_bytes", "queue_leftover", "agg_state_bytes_peak",
                "params_lag_max")

# tests/test_scheduler.py's configurations (its sync gate, digest gate,
# quorum test and _async_base), over the port's three apply routes.
SYNC_BASE = dict(rounds=5, population=48, participation=0.25, seed=3,
                 eval_every=2, server=dict(deadline_s=0.6),
                 channel=dict(drop_prob=0.15, base_latency_s=0.01))
DIGEST_BASE = dict(rounds=6, population=60, participation=0.2, seed=1,
                   eval_every=10**6, downlink_mode="digest",
                   downlink_log_window=3, verify_replay=True,
                   channel=dict(drop_prob=0.1))
QUORUM_BASE = dict(rounds=5, population=60, participation=0.3, seed=2,
                   eval_every=10**6,
                   channel=dict(lognormal_sigma=1.0, base_latency_s=0.02))
ASYNC_BASE = dict(rounds=MAX_ROUNDS, population=MAX_POP, participation=0.2,
                  seed=4, eval_every=10**6,
                  channel=dict(base_latency_s=0.05, lognormal_sigma=0.5))
ASYNC_Q = dict(mode="async", period_s=0.004, max_rounds_in_flight=4,
               quorum_frac=0.5, staleness_window=2, audit_queues=True)
CASES = {   # name -> (RuntimeConfig fields, SchedulerConfig fields)
    "sync_fedscalar": (SYNC_BASE, dict(mode="sync")),
    "sync_fedavg": (dict(SYNC_BASE, protocol_name="fedavg"), dict(mode="sync")),
    "sync_qsgd": (dict(SYNC_BASE, protocol_name="qsgd"), dict(mode="sync")),
    "sync_digest_replay": (DIGEST_BASE, dict(mode="sync")),
    "sync_quorum_corrected": (QUORUM_BASE, dict(mode="sync", quorum_frac=0.5,
                                                arrival_correction=True)),
    "async_rec_route": (dict(ASYNC_BASE, kernel_cohort_threshold=1), ASYNC_Q),
    "async_fused_route": (dict(ASYNC_BASE, projection_mode="fused_kernel"),
                          dict(ASYNC_Q, staleness_window=0)),
    "async_digest": (dict(ASYNC_BASE, downlink_mode="digest",
                          downlink_log_window=4),
                     dict(ASYNC_Q, quorum_frac=0.7, staleness_window=3)),
    "async_qsgd": (dict(ASYNC_BASE, protocol_name="qsgd"), ASYNC_Q),
}


def _configs(case, scheduler=True):
    kw, sched = CASES[case]
    kw = dict(kw)
    ch, sv = kw.pop("channel", {}), kw.pop("server", {})
    tcfg = tengine.RuntimeConfig(
        channel=tcm.ChannelConfig(**ch), server=tserver.ServerConfig(**sv),
        scheduler=tsched.SchedulerConfig(**sched) if scheduler else None, **kw)
    jcfg = jengine.RuntimeConfig(
        channel=jcm.ChannelConfig(**ch), server=jserver.ServerConfig(**sv),
        scheduler=jsched.SchedulerConfig(**sched) if scheduler else None, **kw)
    return tcfg, jcfg


def _run_port(cfg, digits8, p_np):
    clients, xte, yte = digits8
    return tengine.run_federation(cfg, params_from_jax(p_np, "cpu"), clients,
                                  xte, yte, device="cpu")


def _record_qsgd_scale(monkeypatch) -> dict:
    """Record the port run's largest QSGD leaf norm and largest applied
    coefficient: a flipped level moves the params by coeff · norm / L."""
    seen = dict(norm=0.0, coeff=0.0, levels=None)
    compute = tengine.EngineCore.compute_cohort
    close = tserver.StreamingAggregator.close_round

    def compute_rec(self, params, k, ids):
        rs, seeds = compute(self, params, k, ids)
        seen["levels"] = self.proto.config.levels
        if len(ids):
            norms = rs[:len(ids), self.proto.d:]
            seen["norm"] = max(seen["norm"], float(np.abs(norms).max()))
        return rs, seeds

    def close_rec(self, k):
        out = close(self, k)
        if len(out[1]):
            seen["coeff"] = max(seen["coeff"], float(np.abs(out[1]).max()))
        return out

    monkeypatch.setattr(tengine.EngineCore, "compute_cohort", compute_rec)
    monkeypatch.setattr(tserver.StreamingAggregator, "close_round", close_rec)
    return seen


@pytest.mark.parametrize("case", list(CASES))
def test_scheduled_run_matches_reference(case, digits8, shared_draws,
                                         jax_kernels, monkeypatch):
    clients, xte, yte = digits8
    p = mlp_params_np(6)
    tcfg, jcfg = _configs(case)
    if tcfg.protocol_name == "qsgd":
        qsgd_scale = _record_qsgd_scale(monkeypatch)
    ht = _run_port(tcfg, digits8, p)
    hj = jengine.run_federation(jcfg, {k: jnp.asarray(v) for k, v in p.items()},
                                clients, xte, yte)
    st, sj = ht["scheduler"], hj["scheduler"]
    for key in STAT_KEYS:
        np.testing.assert_array_equal(ht[key], hj[key], err_msg=key)
    assert ht["total_downlink_bits"] == hj["total_downlink_bits"]
    assert ht["downlink_stats"] == hj["downlink_stats"]
    for key in SCHEDULE_KEYS:
        assert st[key].tobytes() == sj[key].tobytes(), key
    for key in COUNTER_KEYS:
        assert st[key] == sj[key], key
    assert set(st) == set(sj)
    if "params_lag" in sj:
        np.testing.assert_array_equal(st["params_lag"], sj["params_lag"])
    # the case exercises what it names
    if tcfg.scheduler.mode == "async":
        assert st["params_lag_max"] >= 1
    if tcfg.scheduler.quorum_frac < 1.0:
        assert st["closed_by_quorum"] > 0
    if case == "async_rec_route":
        assert st["stale_admitted"] > 0
    if case == "async_fused_route":                # window 0: all dropped
        assert st["stale_admitted"] == 0 and st["stale_dropped"] > 0
    evals = ~np.isnan(hj["loss"])
    np.testing.assert_array_equal(evals, ~np.isnan(ht["loss"]))
    np.testing.assert_allclose(ht["loss"][evals], hj["loss"][evals], rtol=1e-5)
    atol = 1e-6
    if tcfg.protocol_name == "qsgd":
        # flipped levels: one per element and round, each worth
        # coeff·norm/L, with this run's largest applied coeff (1/C, ×C/A
        # under the arrival correction) and largest leaf norm
        assert qsgd_scale["levels"] and qsgd_scale["coeff"] > 0
        atol += (tcfg.rounds * qsgd_scale["coeff"] * qsgd_scale["norm"]
                 / qsgd_scale["levels"])
    for k in p:
        np.testing.assert_allclose(ht["final_params"][k].numpy(),
                                   np.asarray(hj["final_params"][k]), rtol=0,
                                   atol=atol, err_msg=k)


# ---------------------------------------------------------------------------
# the port against itself
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["sync_fedscalar", "sync_fedavg", "sync_qsgd",
                                  "sync_digest_replay"])
def test_sync_scheduler_bit_identical_to_legacy(case, digits8):
    """The reference's acceptance gate, in the port: scheduler(sync,
    quorum 1) ≡ the legacy loop, params and every ledger bit for bit."""
    p = mlp_params_np(2)
    legacy, _ = _configs(case, scheduler=False)
    sched, _ = _configs(case)
    h_legacy = _run_port(legacy, digits8, p)
    h_sched = _run_port(sched, digits8, p)
    assert "scheduler" not in h_legacy and not h_sched["fused_path"]
    for k in p:
        assert torch.equal(h_legacy["final_params"][k], h_sched["final_params"][k])
    for key in STAT_KEYS + ("loss", "accuracy"):
        np.testing.assert_array_equal(h_legacy[key], h_sched[key], err_msg=key)
    assert h_sched["downlink_stats"] == h_legacy["downlink_stats"]
    s = h_sched["scheduler"]
    assert s["mode"] == "sync" and s["closed_by_quorum"] == 0
    assert s["queue_peak_bytes"] == 0 and s["params_lag_max"] == 0
    assert s["clients_per_s"] > 0


def test_sync_scheduler_takes_no_fused_shortcut(digits8):
    """A fully participating sync config would be ``run_simulation``'s;
    under the scheduler it stays on the event-driven path."""
    p = mlp_params_np(0)
    cfg = tengine.RuntimeConfig(rounds=2, population=SHARDS, participation=1.0,
                                eval_every=10**6,
                                scheduler=tsched.SchedulerConfig())
    h = _run_port(cfg, digits8, p)
    assert not h["fused_path"] and h["scheduler"]["mode"] == "sync"


def test_async_pipelining_beats_sync_wall_clock(digits8):
    """Overlapped rounds: ≥ 3× the modeled clients/s of sync, with the
    model lag ≥ 1 and the modeled wall equal to the last drain."""
    p = mlp_params_np(0)
    kw = dict(ASYNC_BASE)
    ch = tcm.ChannelConfig(**kw.pop("channel"))
    h_sync = _run_port(tengine.RuntimeConfig(
        channel=ch, scheduler=tsched.SchedulerConfig(mode="sync"), **kw),
        digits8, p)
    h_async = _run_port(tengine.RuntimeConfig(
        channel=ch, scheduler=tsched.SchedulerConfig(
            mode="async", period_s=0.004, max_rounds_in_flight=16), **kw),
        digits8, p)
    ss, sa = h_sync["scheduler"], h_async["scheduler"]
    assert sa["makespan_s"] < ss["makespan_s"]
    assert sa["clients_per_s"] >= 3 * ss["clients_per_s"]
    assert np.isfinite(h_async["loss"][-1])
    np.testing.assert_allclose(h_async["cum_wall_s"][-1], sa["makespan_s"])
    assert sa["params_lag_max"] >= 1


def test_server_state_bound_at_one_million_clients(digits8):
    """10⁶ registered clients: one int32 per client (4 MB), queues and
    aggregator O(cohort · rounds in flight), nothing O(d)."""
    p = mlp_params_np(0)
    h = _run_port(tengine.RuntimeConfig(
        rounds=2, population=10**6, participation=2e-5,   # cohort of 20
        seed=0, eval_every=10**6, downlink_mode="digest",
        scheduler=tsched.SchedulerConfig(
            mode="async", period_s=0.004, max_rounds_in_flight=4,
            quorum_frac=0.5, staleness_window=2, audit_queues=True),
        channel=tcm.ChannelConfig(base_latency_s=0.05, lognormal_sigma=0.5)),
        digits8, p)
    s = h["scheduler"]
    assert s["client_state_bytes"] == 4 * 10**6
    assert s["queue_entry_bytes"] == 32
    assert s["queue_peak_bytes"] <= 20 * 4 * 32
    assert s["agg_state_bytes_peak"] <= 20 * 4 * (4 + 24) + 96 * 8
    assert s["params_lag_max"] <= 4


@pytest.mark.parametrize("case", ["async_rec_route", "async_fused_route",
                                  "async_digest", "async_qsgd", "fori", "fedavg"])
def test_async_versions_are_never_written_in_place(case, digits8, monkeypatch):
    """Async rounds compute on stored versions x_v while the head moves on:
    every version's bits, recorded when it is stored, must be the same
    when the run ends (and each apply must leave its input untouched)."""
    if case in CASES:
        tcfg, _ = _configs(case)
    else:
        kw = dict(ASYNC_BASE)
        ch = tcm.ChannelConfig(**kw.pop("channel"))
        if case == "fedavg":
            kw["protocol_name"] = "fedavg"
        tcfg = tengine.RuntimeConfig(channel=ch, scheduler=tsched.SchedulerConfig(
            **ASYNC_Q), **kw)
    stored = []
    apply_round = tengine.EngineCore.apply_round

    def recording_apply(self, params, *args):
        before = {k: v.clone() for k, v in params.items()}
        out = apply_round(self, params, *args)
        for k, v in params.items():
            assert torch.equal(v, before[k]), f"apply wrote into its input {k}"
        stored.append((out[0], {k: v.clone() for k, v in out[0].items()}))
        return out

    monkeypatch.setattr(tengine.EngineCore, "apply_round", recording_apply)
    h = _run_port(tcfg, digits8, mlp_params_np(1))
    assert h["scheduler"]["params_lag_max"] >= 1
    assert len(stored) == tcfg.rounds
    for version, bits in stored:
        for k in bits:
            assert torch.equal(version[k], bits[k]), k
