"""The paper's §III experiment (Figs 2–6) on the PyTorch/CUDA port.

Trains the d = 1990 MLP on synthetic 8×8 digits across N = 20 clients
for K rounds with S = 5 local steps, through
``repro_torch.fed.simulation.run_simulation`` (on the card: the kernel
encode and the fused kernel close for the FedScalar methods, the QSGD
kernel for qsgd), comparing FedScalar (Rademacher and Gaussian) against
FedAvg and 8-bit QSGD under the 0.1 Mbps bandwidth-constrained channel
with the eq. (12)/(13) cost model, as ``examples/fedscalar_digits.py``
does.

Usage::

    PYTHONPATH=src python examples/fedscalar_digits_torch.py \\
        [--rounds 1500] [--runs 3] [--methods fedscalar_rademacher ...] \\
        [--outdir experiments/digits_torch] [--partition iid|dirichlet] \\
        [--alpha 0.5] [--access concurrent|tdma] [--device cuda] [--profile 20]

Run r of a method starts from ``init_mlp(seed=seed + r)`` with run seed
``seed + r`` (``--seed``, default 0: the reference's seeds).  Writes the
per-method curves, averaged over the runs, to
``{outdir}/{method}{suffix}.csv`` with the reference's header
(``round,loss,accuracy,cum_bits,cum_wall_s,cum_energy_j``) and prints the
paper's headline comparisons and each method's rounds per second.  The
batch draws are the port's own (a ``torch.Generator`` stream), so loss
and accuracy follow the reference's curves in shape, not to the bit; the
modeled columns (bits, wall-clock, energy) depend only on the cost model's
``RandomState`` and equal the reference's for the same seed.

``--profile N`` traces N rounds of the first method with
``torch.profiler`` (after a warm-up run) and prints the device's busy
share of the traced window (the union of its operations' intervals), its
idle time by the port span the host was in (``repro_torch.obs``), and
the top operators by device time and by host time.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.projection import tree_size
from repro_torch.data import load_digits, make_client_datasets, train_test_split_arrays
from repro_torch.fed.costmodel import ChannelConfig
from repro_torch.fed.simulation import SimulationConfig, run_simulation
from repro_torch.models.mlp_classifier import init_mlp

HEADER = "round,loss,accuracy,cum_bits,cum_wall_s,cum_energy_j"
METHODS = ["fedscalar_rademacher", "fedscalar_gaussian", "fedavg", "qsgd"]


def acc_at_budget(h, budget, key):
    """Test accuracy of the last round whose cumulative cost ≤ budget."""
    idx = np.searchsorted(h[key], budget, side="right") - 1
    return float(h["accuracy"][idx]) if idx >= 0 else 0.0


def _profile(cfg, clients, xte, yte, device, rounds: int) -> None:
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    run_simulation(SimulationConfig(method=cfg.method, rounds=2), init_mlp(device=device),
                   clients, xte, yte, device=device)          # warm-up
    traced = SimulationConfig(method=cfg.method, rounds=rounds)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_simulation(traced, init_mlp(device=device), clients, xte, yte,
                       device=device)
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    print(f"profile: {cfg.method}, {rounds} rounds, wall {wall_us / 1e3:.3f} ms, "
          f"{wall_us / rounds / 1e3:.3f} ms/round")
    obs.print_device_time(prof, f"profile: {cfg.method}")
    print(events.table(sort_by="self_device_time_total", row_limit=12))
    print(events.table(sort_by="self_cpu_time_total", row_limit=12))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=1500)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--methods", nargs="*", default=METHODS)
    ap.add_argument("--outdir", default="experiments/digits_torch")
    ap.add_argument("--partition", default="iid", choices=["iid", "dirichlet"],
                    help="beyond-paper: label-skewed non-iid clients")
    ap.add_argument("--alpha", type=float, default=0.5,
                    help="Dirichlet concentration for --partition dirichlet")
    ap.add_argument("--access", default="concurrent",
                    choices=["concurrent", "tdma"],
                    help="uplink medium access (Table I scenarios)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="run r uses seed + r (the reference: r)")
    ap.add_argument("--profile", type=int, default=0,
                    help="trace this many rounds of the first method")
    args = ap.parse_args(argv)

    x, y = load_digits()
    xtr, ytr, xte, yte = train_test_split_arrays(x, y)
    clients = make_client_datasets(xtr, ytr, 20, scheme=args.partition,
                                   alpha=args.alpha)
    os.makedirs(args.outdir, exist_ok=True)
    channel = ChannelConfig(access=args.access)
    suffix = ""
    if args.partition != "iid":
        suffix += f"_{args.partition}{args.alpha}"
    if args.access != "concurrent":
        suffix += f"_{args.access}"
    if args.device != "cpu":
        print(f"device: {torch.cuda.get_device_name(torch.device(args.device))}")

    results = {}
    for method in args.methods:
        runs, rates = [], []
        for r in range(args.runs):
            seed = args.seed + r
            cfg = SimulationConfig(method=method, rounds=args.rounds, seed=seed,
                                   channel=channel)
            h = run_simulation(cfg, init_mlp(seed=seed, device=args.device),
                               clients, xte, yte, device=args.device)
            runs.append(h)
            if args.rounds > 1:
                rates.append((args.rounds - 1) / h["sim_compute_seconds"])
        h = {
            "round": runs[0]["round"],
            **{key: np.mean([run[key] for run in runs], axis=0)
               for key in ("loss", "accuracy", "cum_bits", "cum_wall_s",
                           "cum_energy_j")},
        }
        results[method] = h
        path = os.path.join(args.outdir, f"{method}{suffix}.csv")
        np.savetxt(
            path,
            np.column_stack([h["round"], h["loss"], h["accuracy"],
                             h["cum_bits"], h["cum_wall_s"], h["cum_energy_j"]]),
            delimiter=",", header=HEADER, comments="",
        )
        rate = f", {np.mean(rates):.1f} rounds/s after the first" if rates else ""
        print(f"{method:24s} final acc={h['accuracy'][-1]:.4f} "
              f"loss={h['loss'][-1]:.4f} total bits={h['cum_bits'][-1]:.3g} "
              f"wall={h['cum_wall_s'][-1]:.3g}s energy={h['cum_energy_j'][-1]:.3g}J"
              f"{rate} -> {path}")

    d = tree_size(init_mlp(device="cpu"))
    print(f"\nmodel d = {d}")
    print("\n== Fig 4 headline: accuracy at 1e6 uploaded bits ==")
    for m, h in results.items():
        print(f"  {m:24s} {100*acc_at_budget(h, 1e6, 'cum_bits'):6.2f} %")
    print("\n== Fig 5 headline: accuracy at t = 1250 s ==")
    for m, h in results.items():
        print(f"  {m:24s} {100*acc_at_budget(h, 1250.0, 'cum_wall_s'):6.2f} %")
    print("\n== Fig 6 headline: accuracy at 50 J ==")
    for m, h in results.items():
        print(f"  {m:24s} {100*acc_at_budget(h, 50.0, 'cum_energy_j'):6.2f} %")
    if args.profile:
        cfg = SimulationConfig(method=args.methods[0], rounds=args.profile)
        _profile(cfg, clients, xte, yte, args.device, args.profile)
    return results


if __name__ == "__main__":
    main()
