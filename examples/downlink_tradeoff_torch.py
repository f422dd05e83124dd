"""Two-sided round traffic on the port: the digest downlink vs the dense broadcast.

Counterpart of ``examples/downlink_tradeoff.py`` on the PyTorch/CUDA port
(the card unless ``--device cpu``).

The paper's loop begins "server broadcasts x_k" — a Θ(d) downlink its
cost model (eqs. 12–13) never priced.  This example runs the paper's
protocols through `run_federation` with both downlink wire disciplines
and prints the honest two-sided totals:

* `fedscalar × digest` — the server broadcasts the round digest
  (round, cohort seeds, HT weights, step scalars): O(C·k) bits per
  round, **independent of d**.  Stateful clients replay the identical
  parameter update from the seeded directions (``verify_replay``
  asserts the bit-identity).
* `fedscalar × dense`, `fedavg`, `qsgd` — the d·32-bit model broadcast
  every round: the downlink alone is Θ(d), no matter how small the
  uplink got.

What to look for: the digest row's round-traffic column is the same at
every d — the whole round, both directions, is dimension-free — while
every dense-downlink row grows linearly with d, dominating total
traffic exactly as Zheng et al. predict once the uplink is compressed.

Writes the rows as CSV (``chiprun_out/downlink/tradeoff.csv``).

Usage::

    PYTHONPATH=src python examples/downlink_tradeoff_torch.py [--rounds 150]
        [--hidden 24,12 --hidden 48,24] [--bandwidth-bps 1e5] \
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.fed.baselines import downlink_tradeoff, write_downlink_csv  # noqa: E402


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

    rows = downlink_tradeoff(
        rounds=args.rounds, hidden_sizes=hidden, num_clients=args.clients,
        bandwidth_bps=args.bandwidth_bps, seed=args.seed, device=args.device)

    hdr = (f"{'protocol':<10} {'downlink':<8} {'d':>6} {'up b/cl/rd':>10} "
           f"{'down b/rd':>10} {'round bits':>10} {'total bits':>11} "
           f"{'wall s':>9} {'energy J':>9} {'final acc':>9}")
    print(f"\n== two-sided traffic @ {args.bandwidth_bps/1e6:.2g} Mbps, "
          f"N={args.clients}, {args.rounds} rounds ==")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        print(f"{r['protocol']:<10} {r['downlink']:<8} {r['d']:>6} "
              f"{r['uplink_bits_per_client_per_round']:>10} "
              f"{r['downlink_bits_per_round']:>10.0f} "
              f"{r['round_traffic_bits']:>10.0f} "
              f"{r['total_traffic_bits']:>11.3g} {r['total_wall_s']:>9.3g} "
              f"{r['total_energy_j']:>9.3g} {r['final_accuracy']:>9.4f}")

    path = write_downlink_csv(rows)
    print(f"\nwrote {len(rows)} rows → {path}")

    # The headline, stated explicitly: digest round traffic is flat in d.
    digest = [r for r in rows
              if r["protocol"] == "fedscalar" and r["downlink"] == "digest"]
    dense = [r for r in rows if r["downlink"] == "dense"]
    flat = {int(r["round_traffic_bits"]) for r in digest}
    print(f"\nfedscalar×digest round traffic across d: {sorted(flat)} bits "
          f"(dimension-free: {len(flat) == 1})")
    for d in sorted({r["d"] for r in dense}):
        by = {r["protocol"] + "/" + r["downlink"]: r for r in rows
              if r["d"] == d}
        print(f"d={d}: round bits digest="
              f"{by['fedscalar/digest']['round_traffic_bits']:.0f} ≪ "
              f"fedscalar/dense={by['fedscalar/dense']['round_traffic_bits']:.0f} "
              f"< qsgd={by['qsgd/dense']['round_traffic_bits']:.0f} "
              f"< fedavg={by['fedavg/dense']['round_traffic_bits']:.0f} (Θ(d))")


if __name__ == "__main__":
    main()
