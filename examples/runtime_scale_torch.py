"""Massive-cohort federation runtime on the card (PyTorch/CUDA port).

Counterpart of ``examples/runtime_scale.py``, with the same flags: K
rounds of FedScalar (or ``--protocol fedavg|qsgd``) over a registered
population of (by default) 100,000 virtual clients at 1 % participation
on the digits task, with unbiased-estimate diagnostics and the two-sided
bandwidth / wall-clock / energy totals.

Usage::

    PYTHONPATH=src python examples/runtime_scale_torch.py \
        [--population 100000] [--participation 0.01] [--rounds 50] \
        [--serve sync|async|legacy] [--quorum 1.0] [--period-s 0.001] \
        [--depth 32] [--window 4] [--sampler uniform|weighted|poisson] \
        [--scalar fp32|fp16|bf16] [--deadline-s inf] [--max-staleness 0] \
        [--staleness-beta 0.0] [--drop-prob 0.0] \
        [--downlink dense|digest] [--log-window 64] [--check-fused] \
        [--protocol fedscalar|fedavg|qsgd] [--projection-mode full|block|fused_kernel] \
        [--kernel-threshold N] [--verify-replay] [--device cuda|cpu] \
        [--profile]

The card is the default device; ``--device cpu`` runs the kernels' plain
versions.  ``--serve`` picks the driver, as in the reference: ``sync``
(the default) and ``async`` are the continuous-round scheduler
(``--quorum``; async also ``--period-s``, ``--depth`` rounds in flight
and a ``--window`` of staleness), ``legacy`` the one-cohort-at-a-time
loop.  Under the scheduler the run prints the modeled serving timeline
(eq. 12″, reproducible from the seed) beside this run's own host
seconds per round.

``--check-fused`` verifies that a full-participation, deadline-free run
reproduces the port's ``run_simulation`` trajectory bit for bit.

``--profile`` runs the configuration twice more after the main run:
under ``cProfile``, printing the host seconds of each engine stage (sum
over rounds, stages nested as in the driver loop), and under
``torch.profiler``, printing the device's busy share of the traced
window (the union of its operations' intervals) and its idle time by the
port span the host was in (``repro_torch.obs``).
"""
from __future__ import annotations

import argparse
import math
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch import obs  # noqa: E402
from repro_torch.data import (  # noqa: E402
    load_digits,
    make_client_datasets,
    train_test_split_arrays,
)
from repro_torch.fed.costmodel import ChannelConfig  # noqa: E402
from repro_torch.fed.runtime import (  # noqa: E402
    RuntimeConfig,
    SchedulerConfig,
    ServerConfig,
    run_federation,
)
from repro_torch.models.mlp_classifier import init_mlp  # noqa: E402

# The kernels' launch counters (repro_torch.obs), by the names printed.
KERNELS = {"encode": "encode.launches", "fused_close": "close.launches",
           "client_decode": "decode.launches", "qsgd": "qsgd.launches"}


def check_fused_equivalence(clients, xte, yte, device) -> None:
    """participation=1.0, deadline=∞ → bit-for-bit run_simulation."""
    import torch

    from repro_torch.fed.simulation import SimulationConfig, run_simulation

    p0 = init_mlp(device=device)
    rt = run_federation(
        RuntimeConfig(rounds=30, population=len(clients), participation=1.0),
        p0, clients, xte, yte, device=device)
    sim = run_simulation(
        SimulationConfig(method="fedscalar_rademacher", rounds=30,
                         num_clients=len(clients)),
        p0, clients, xte, yte, device=device)
    assert rt["fused_path"], "full sync cohort should take the fused path"
    assert np.array_equal(rt["loss"], sim["loss"]), "loss trajectory diverged"
    assert np.array_equal(rt["accuracy"], sim["accuracy"]), "accuracy diverged"
    for k in sim["final_params"]:
        assert torch.equal(rt["final_params"][k], sim["final_params"][k]), k
    print("fused-path check: runtime @ participation=1.0 ≡ run_simulation "
          "(loss/accuracy/params bit-for-bit over 30 rounds)")


# Engine stages reported by --profile, as (label, function name).
STAGES = (
    ("sample cohort (and the diagnostic's draws)", "sample"),
    ("cohort compute", "compute_cohort"),
    ("  batch draw", "draw_cohort_batches"),
    ("  local SGD (batched autograd)", "local"),
    ("  protocol encode", "encode_cohort"),
    ("uplink wire (encode/decode/channel)", "transmit"),
    ("offer uploads to the aggregator", "offer_uploads"),
    ("routed offers (async scheduler)", "offer_routed"),
    ("close round", "close_round"),
    ("apply", "apply_round"),
    ("digest close (broadcast + replay)", "close_digest"),
    ("evaluate", "evaluate"),
    ("finalize (sampling diagnostic)", "finalize"),
)


def profile_run(cfg, clients, xte, yte, device) -> None:
    """Host seconds per engine stage (cProfile) and device busy share."""
    import cProfile
    import pstats
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    run_federation(cfg, init_mlp(seed=cfg.seed, device=device), clients, xte,
                   yte, device=device)
    prof.disable()
    wall = time.perf_counter() - t0
    stats = pstats.Stats(prof).stats
    by_name = {}
    for (path, _, fn), (_, _, _, cum, _) in stats.items():
        if "repro_torch" in path or fn in ("local",):
            by_name[fn] = max(by_name.get(fn, 0.0), cum)
    print(f"\nprofile (cProfile, {cfg.rounds} rounds, wall {wall:.3f} s, "
          f"{wall / cfg.rounds * 1e3:.2f} ms/round):")
    for label, fn in STAGES:
        if fn in by_name:
            print(f"  {label:44s} {by_name[fn] / cfg.rounds * 1e3:9.3f} ms/round")

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as tp:
        t0 = time.perf_counter()
        run_federation(cfg, init_mlp(seed=cfg.seed, device=device), clients,
                       xte, yte, device=device)
        wall_us = (time.perf_counter() - t0) * 1e6
    events = tp.key_averages()
    print(f"profile (torch.profiler): wall {wall_us / 1e3:.3f} ms")
    obs.print_device_time(tp, "profile (torch.profiler)")
    print(events.table(sort_by="self_device_time_total", row_limit=8))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--population", type=int, default=100_000)
    ap.add_argument("--participation", type=float, default=0.01)
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--sampler", default="uniform",
                    choices=["uniform", "weighted", "poisson"])
    ap.add_argument("--scalar", default="fp32", choices=["fp32", "fp16", "bf16"])
    ap.add_argument("--deadline-s", type=float, default=math.inf)
    ap.add_argument("--max-staleness", type=int, default=0)
    ap.add_argument("--staleness-beta", type=float, default=0.0)
    ap.add_argument("--round-period-s", type=float, default=math.inf)
    ap.add_argument("--drop-prob", type=float, default=0.0)
    ap.add_argument("--serve", default="sync",
                    choices=["sync", "async", "legacy"],
                    help="driver: continuous scheduler (sync/async) or the "
                         "pre-scheduler legacy loop")
    ap.add_argument("--quorum", type=float, default=1.0,
                    help="close a round once this fraction of the cohort "
                         "arrived (1.0 = wait for the deadline)")
    ap.add_argument("--period-s", type=float, default=0.001,
                    help="async: open a new round every this many seconds")
    ap.add_argument("--depth", type=int, default=32,
                    help="async: max rounds in flight")
    ap.add_argument("--window", type=int, default=4,
                    help="async: staleness window for re-admitted stragglers")
    ap.add_argument("--downlink", default="dense", choices=["dense", "digest"])
    ap.add_argument("--log-window", type=int, default=64)
    ap.add_argument("--shards", type=int, default=20)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check-fused", action="store_true")
    ap.add_argument("--protocol", default="fedscalar",
                    choices=["fedscalar", "fedavg", "qsgd"])
    ap.add_argument("--projection-mode", default="full",
                    choices=["full", "block", "fused_kernel"])
    ap.add_argument("--kernel-threshold", type=int, default=None,
                    help="cohorts at least this large close through the "
                         "per-client decode kernel (default 512 on the card)")
    ap.add_argument("--verify-replay", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()

    x, y = load_digits()
    xtr, ytr, xte, yte = train_test_split_arrays(x, y)
    clients = make_client_datasets(xtr, ytr, args.shards)

    if args.check_fused:
        check_fused_equivalence(clients, xte, yte, args.device)

    if args.serve == "legacy":
        scheduler = None
    elif args.serve == "sync":
        scheduler = SchedulerConfig(mode="sync", quorum_frac=args.quorum)
    else:
        scheduler = SchedulerConfig(
            mode="async", quorum_frac=args.quorum, period_s=args.period_s,
            max_rounds_in_flight=args.depth, staleness_window=args.window)

    cfg = RuntimeConfig(
        rounds=args.rounds,
        scheduler=scheduler,
        population=args.population,
        participation=args.participation,
        sampler=args.sampler,
        protocol_name=args.protocol,
        projection_mode=args.projection_mode,
        kernel_cohort_threshold=args.kernel_threshold,
        scalar_format=args.scalar,
        downlink_mode=args.downlink,
        downlink_log_window=args.log_window,
        verify_replay=args.verify_replay,
        eval_every=args.eval_every,
        seed=args.seed,
        server=ServerConfig(
            deadline_s=args.deadline_s,
            round_period_s=args.round_period_s,
            max_staleness=args.max_staleness,
            staleness_exponent=args.staleness_beta,
        ),
        channel=ChannelConfig(drop_prob=args.drop_prob),
    )
    print(f"population={cfg.population}  participation={cfg.participation} "
          f"(cohort ≈ {cfg.cohort_size()})  sampler={cfg.sampler}  "
          f"protocol={cfg.protocol_name}  device={args.device}")

    before = obs.totals()
    h = run_federation(cfg, init_mlp(seed=args.seed, device=args.device),
                       clients, xte, yte, device=args.device)

    evals = ~np.isnan(h["loss"])
    path = ("fused (run_simulation)" if h["fused_path"]
            else f"scheduler/{args.serve}" if args.serve != "legacy"
            else "event-driven legacy")
    print(f"\nran {args.rounds} rounds in {h['sim_compute_seconds']:.1f}s "
          f"({path} path; {h['bits_per_client_per_round']} bits/upload)")
    print(f"loss  {h['loss'][evals][0]:.4f} → {h['loss'][evals][-1]:.4f}   "
          f"accuracy {h['accuracy'][evals][0]:.4f} → {h['accuracy'][evals][-1]:.4f}")
    applied = h["apply_s"] > 0
    if applied.any():
        print(f"apply: median {np.median(h['apply_s'][applied]) * 1e3:.3f} ms "
              f"per round, {h['recon_clients_per_s']:,.0f} clients/s")
    after = obs.totals()
    print("kernel launches: " + ", ".join(
        f"{name}={after[c] - before[c]}" for name, c in KERNELS.items()))

    if "scheduler" in h:
        s = h["scheduler"]
        print("\n== continuous-round serving (modeled timeline) ==")
        print(f"  modeled makespan   : {s['makespan_s']:.3f} s "
              f"({s['mode']}, quorum {s['quorum_frac']}, "
              f"{s['max_rounds_in_flight']} round(s) in flight)")
        print(f"  modeled throughput : {s['rounds_per_s']:.1f} rounds/s, "
              f"{s['clients_per_s']:,.0f} clients/s "
              f"({s['offered_uploads']} uploads offered)")
        print(f"  this run's host    : "
              f"{h['sim_compute_seconds'] / args.rounds:.4f} s/round "
              f"on {args.device} (the modeled figures follow the channel's "
              f"latency draws, not this host)")
        print(f"  closures           : {s['closed_by_quorum']} by quorum, "
              f"{len(s['starts']) - s['closed_by_quorum']} by deadline/drain; "
              f"params lag ≤ {s['params_lag_max']}")
        print(f"  stragglers         : {s['stale_admitted']} re-admitted ≤ "
              f"{s['staleness_window']} rounds late, "
              f"{s['stale_dropped']} dropped, {s['queue_leftover']} left "
              f"queued at shutdown")
        print(f"  server state       : {s['client_state_bytes']:,} B "
              f"per-client map + {s['agg_state_bytes_peak']:,} B aggregator "
              f"peak + {s['queue_peak_bytes']:,} B queue peak "
              f"({s['queue_entry_bytes']} B/entry)")

    print("\n== unbiased-estimate diagnostics ==")
    diag = h["sampling_diagnostic"]
    print(f"  Horvitz–Thompson probe estimate rel. err : "
          f"{diag['estimate_rel_err']:.4f}")
    print(f"  empirical inclusion-marginal abs. err    : "
          f"{diag['empirical_marginal_abs_err']:.4f}")
    print(f"  mean per-round Σwᵢ (target 1.0)          : "
          f"{np.mean(h['weight_sum']):.4f}")

    print("\n== arrivals ==")
    print(f"  uploads applied    : {int(h['applied'].sum())} "
          f"(stale: {int(h['applied_stale'].sum())})")
    print(f"  lost in channel    : {int(h['lost_channel'].sum())}")
    print(f"  dropped @ deadline : {int(h['dropped_deadline'].sum())}")
    print(f"  dropped too-stale  : {int(h['dropped_stale'].sum())}")

    print("\n== two-sided cost-model totals (eqs. 12′–13′) ==")
    print(f"  uplink   : {h['cum_bits'][-1]:.3g} bits "
          f"({h['bits_per_client_per_round']} bits/client/round)")
    ds = h["downlink_stats"]
    print(f"  downlink : {h['cum_downlink_bits'][-1]:.3g} bits "
          f"[{h['downlink_mode']}] (broadcast {ds['broadcast_bits']:.3g} + "
          f"catch-up {ds['catchup_bits']:.3g}; "
          f"{ds['dense_resyncs']} dense resyncs)")
    print(f"  wall     : {h['cum_wall_s'][-1] + h['cum_downlink_wall_s'][-1]:.3g} s "
          f"(uplink {h['cum_wall_s'][-1]:.3g} + "
          f"downlink {h['cum_downlink_wall_s'][-1]:.3g})")
    print(f"  energy   : {h['cum_energy_j'][-1] + h['cum_downlink_energy_j'][-1]:.3g} J "
          f"(uplink {h['cum_energy_j'][-1]:.3g} + "
          f"downlink {h['cum_downlink_energy_j'][-1]:.3g})")

    if args.profile:
        profile_run(cfg, clients, xte, yte, args.device)


if __name__ == "__main__":
    main()
