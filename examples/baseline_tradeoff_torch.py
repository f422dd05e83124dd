"""Reproduce the paper's system-level comparison (Table I / §V) on the port.

Counterpart of ``examples/baseline_tradeoff.py`` on the PyTorch/CUDA port
(the card unless ``--device cpu``).

Runs FedScalar, FedAvg and 8-bit QSGD **through the same event-driven
engine** (`run_federation(protocol_name=…)`) on the
digits task at the paper's bandwidth-constrained regime — N = 20
clients, R = 0.1 Mbps uplink, P_tx = 2 W — across two model sizes and
both Table I medium-access schemes, then prints the accuracy vs
bits / wall-clock / energy trade-off and writes the rows as CSV
(``chiprun_out/baselines/tradeoff.csv``).
The cost columns equal the reference's bit for bit; the accuracy
columns follow the port's own batch draws.

What to look for in the output (the paper's claim):

* FedScalar's bits/client/round is the same at every d (one scalar +
  one seed = 64 bits); FedAvg and QSGD grow linearly with d,
* at 0.1 Mbps that makes wall-clock and energy order
  fedscalar ≪ qsgd < fedavg, in both access schemes,
* per *round* the exact baselines descend faster — the trade-off only
  tips under a communication budget, which is the regime the paper
  targets.

Usage::

    PYTHONPATH=src python examples/baseline_tradeoff_torch.py [--rounds 150]
        [--hidden 24,12 --hidden 48,24] [--bandwidth-bps 1e5] \
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.fed.baselines import baseline_tradeoff, write_tradeoff_csv  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=150)
    ap.add_argument("--bandwidth-bps", type=float, default=0.1e6)
    ap.add_argument("--clients", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--hidden", action="append", default=None,
                    help="hidden sizes as comma list; repeatable "
                         "(default: 24,12 and 48,24)")
    args = ap.parse_args()

    hidden = ([tuple(int(v) for v in h.split(",")) for h in args.hidden]
              if args.hidden else ((24, 12), (48, 24)))

    rows = baseline_tradeoff(
        rounds=args.rounds, hidden_sizes=hidden,
        num_clients=args.clients, bandwidth_bps=args.bandwidth_bps,
        seed=args.seed, device=args.device)

    hdr = (f"{'protocol':<10} {'d':>6} {'access':<10} {'bits/up':>9} "
           f"{'final acc':>9} {'total bits':>11} {'wall s':>9} "
           f"{'energy J':>9} {'acc@1250s':>9} {'acc@50J':>8}")
    print(f"\n== protocol trade-off @ {args.bandwidth_bps/1e6:.2g} Mbps, "
          f"N={args.clients}, {args.rounds} rounds ==")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        print(f"{r['protocol']:<10} {r['d']:>6} {r['access']:<10} "
              f"{r['bits_per_client_per_round']:>9} "
              f"{r['final_accuracy']:>9.4f} {r['total_uplink_bits']:>11.3g} "
              f"{r['total_wall_s']:>9.3g} {r['total_energy_j']:>9.3g} "
              f"{r['acc_at_1250_s']:>9.4f} {r['acc_at_50_j']:>8.4f}")

    path = write_tradeoff_csv(rows)
    print(f"\nwrote {len(rows)} rows → {path}")

    # The headline orderings, stated explicitly:
    for d in sorted({r["d"] for r in rows}):
        by = {r["protocol"]: r for r in rows
              if r["d"] == d and r["access"] == "concurrent"}
        fs_, fa_, q_ = by["fedscalar"], by["fedavg"], by["qsgd"]
        print(f"d={d}: bits/up fedscalar={fs_['bits_per_client_per_round']} "
              f"(O(1)) vs qsgd={q_['bits_per_client_per_round']} / "
              f"fedavg={fa_['bits_per_client_per_round']} (Θ(d)); "
              f"wall {fs_['total_wall_s']:.3g}s ≪ {q_['total_wall_s']:.3g}s "
              f"< {fa_['total_wall_s']:.3g}s")


if __name__ == "__main__":
    main()
