"""Baseline trade-off sweeps (torch port of ``repro/fed/baselines.py``).

Runs FedScalar, FedAvg and QSGD through the port's
:func:`repro_torch.fed.runtime.run_federation` on the digits task at the
paper's bandwidth-constrained regime (R = 0.1 Mbps, P_tx = 2 W, N = 20
full participation), over several model widths d, and tabulates accuracy
against cumulative uplink bits, wall-clock seconds (eq. 12) and transmit
energy (eq. 13) under both access schemes of Table I.  The TDMA rows
re-run the cost accounting with the identical channel draws.

:func:`downlink_tradeoff` adds the downlink: FedScalar under the
``digest`` discipline against every protocol's dense model broadcast.

The cost columns are numpy and equal the reference's bit for bit; the
accuracy columns follow the port's own batch draws.  The CSV writers
take the path from the caller, and default under ``chiprun_out/``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np

from repro_torch.fed.costmodel import ChannelConfig, replay_round_costs

__all__ = [
    "TRADEOFF_CSV", "TRADEOFF_COLUMNS", "baseline_tradeoff",
    "write_tradeoff_csv",
    "DOWNLINK_CSV", "DOWNLINK_COLUMNS", "downlink_tradeoff",
    "write_downlink_csv",
]

TRADEOFF_CSV = "chiprun_out/baselines/tradeoff.csv"

TRADEOFF_COLUMNS = (
    "protocol", "access", "d", "bits_per_client_per_round", "rounds",
    "final_accuracy", "total_uplink_bits", "total_downlink_bits",
    "total_traffic_bits", "total_wall_s", "total_energy_j",
    "acc_at_1e6_bits", "acc_at_1250_s", "acc_at_50_j",
)

DOWNLINK_CSV = "chiprun_out/downlink/tradeoff.csv"

DOWNLINK_COLUMNS = (
    "protocol", "downlink", "d", "rounds",
    "uplink_bits_per_client_per_round", "downlink_bits_per_round",
    "round_traffic_bits", "total_uplink_bits", "total_downlink_bits",
    "total_traffic_bits", "total_wall_s", "total_energy_j",
    "final_accuracy",
)

# Accuracy-at-budget points.
_BITS_BUDGET = 1e6
_WALL_BUDGET = 1250.0
_ENERGY_BUDGET = 50.0


def _acc_at(h: dict, key: str, budget: float) -> float:
    idx = int(np.searchsorted(h[key], budget, side="right")) - 1
    return float(h["accuracy"][idx]) if idx >= 0 else 0.0


def _cost_totals(channel: ChannelConfig, bits_per_upload: int, rounds: int,
                 n: int, d: int, rng_seed: int):
    """Cumulative cost curves for one access scheme (the engine's draws)."""
    bits, wall, energy = replay_round_costs(
        channel, bits_per_upload, rounds, n,
        fedavg_bits_per_client=d * channel.float_bits, rng_seed=rng_seed)
    return np.cumsum(bits), np.cumsum(wall), np.cumsum(energy)


def _digits(num_clients: int):
    from repro_torch.data import (
        load_digits,
        make_client_datasets,
        train_test_split_arrays,
    )

    x, y = load_digits()
    xtr, ytr, xte, yte = train_test_split_arrays(x, y)
    return make_client_datasets(xtr, ytr, num_clients), xte, yte


def baseline_tradeoff(
    rounds: int = 150,
    protocols: Sequence[str] = ("fedscalar", "fedavg", "qsgd"),
    hidden_sizes: Sequence[tuple] = ((24, 12), (48, 24)),
    access: Sequence[str] = ("concurrent", "tdma"),
    num_clients: int = 20,
    bandwidth_bps: float = 0.1e6,
    seed: int = 0,
    device="cuda",
) -> list[dict]:
    """→ one row dict per (protocol, d, access), ``TRADEOFF_COLUMNS`` keys."""
    from repro_torch.core.projection import tree_size
    from repro_torch.fed.runtime import RuntimeConfig, run_federation
    from repro_torch.models.mlp_classifier import init_mlp

    clients, xte, yte = _digits(num_clients)
    rows = []
    for hidden in hidden_sizes:
        sizes = (64,) + tuple(hidden) + (10,)
        p0 = init_mlp(sizes=sizes, seed=seed, device=device)
        d = tree_size(p0)
        for proto in protocols:
            cfg = RuntimeConfig(
                rounds=rounds, population=num_clients, participation=1.0,
                protocol_name=proto, seed=seed,
                channel=ChannelConfig(bandwidth_bps=bandwidth_bps,
                                      num_clients=num_clients))
            h = run_federation(cfg, p0, clients, xte, yte, device=device)
            for acc_mode in access:
                ch = dataclasses.replace(cfg.channel, access=acc_mode)
                bits, wall, energy = _cost_totals(
                    ch, h["bits_per_client_per_round"], rounds, num_clients,
                    d, seed)
                hm = dict(h, cum_bits=bits, cum_wall_s=wall,
                          cum_energy_j=energy)
                dl_total = float(h["cum_downlink_bits"][-1])
                rows.append(dict(
                    protocol=proto,
                    access=acc_mode,
                    d=d,
                    bits_per_client_per_round=int(h["bits_per_client_per_round"]),
                    rounds=rounds,
                    final_accuracy=float(h["accuracy"][-1]),
                    total_uplink_bits=float(bits[-1]),
                    total_downlink_bits=dl_total,
                    total_traffic_bits=float(bits[-1]) + dl_total,
                    total_wall_s=float(wall[-1]),
                    total_energy_j=float(energy[-1]),
                    acc_at_1e6_bits=_acc_at(hm, "cum_bits", _BITS_BUDGET),
                    acc_at_1250_s=_acc_at(hm, "cum_wall_s", _WALL_BUDGET),
                    acc_at_50_j=_acc_at(hm, "cum_energy_j", _ENERGY_BUDGET),
                ))
    return rows


def _write_csv(rows: list[dict], columns: Sequence[str], path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(",".join(columns) + "\n")
        for r in rows:
            vals = []
            for c in columns:
                v = r[c]
                vals.append(f"{v:.6g}" if isinstance(v, float) else str(v))
            f.write(",".join(vals) + "\n")
    return path


def write_tradeoff_csv(rows: list[dict], path: str = TRADEOFF_CSV) -> str:
    """Write the sweep rows → ``path``."""
    return _write_csv(rows, TRADEOFF_COLUMNS, path)


def downlink_tradeoff(
    rounds: int = 150,
    hidden_sizes: Sequence[tuple] = ((24, 12), (48, 24)),
    num_clients: int = 20,
    bandwidth_bps: float = 0.1e6,
    seed: int = 0,
    device="cuda",
) -> list[dict]:
    """Two-sided traffic sweep → one row per (protocol, downlink, d)."""
    from repro_torch.core.projection import tree_size
    from repro_torch.fed.runtime import RuntimeConfig, run_federation
    from repro_torch.models.mlp_classifier import init_mlp

    clients, xte, yte = _digits(num_clients)
    combos = (("fedscalar", "digest"), ("fedscalar", "dense"),
              ("fedavg", "dense"), ("qsgd", "dense"))
    rows = []
    for hidden in hidden_sizes:
        sizes = (64,) + tuple(hidden) + (10,)
        p0 = init_mlp(sizes=sizes, seed=seed, device=device)
        d = tree_size(p0)
        for proto, dmode in combos:
            cfg = RuntimeConfig(
                rounds=rounds, population=num_clients, participation=1.0,
                protocol_name=proto, downlink_mode=dmode, seed=seed,
                channel=ChannelConfig(bandwidth_bps=bandwidth_bps,
                                      num_clients=num_clients))
            h = run_federation(cfg, p0, clients, xte, yte, device=device)
            up_total = float(h["cum_bits"][-1])
            dl_total = float(h["cum_downlink_bits"][-1])
            rows.append(dict(
                protocol=proto,
                downlink=dmode,
                d=d,
                rounds=rounds,
                uplink_bits_per_client_per_round=int(
                    h["bits_per_client_per_round"]),
                downlink_bits_per_round=dl_total / rounds,
                round_traffic_bits=(
                    num_clients * h["bits_per_client_per_round"]
                    + dl_total / rounds),
                total_uplink_bits=up_total,
                total_downlink_bits=dl_total,
                total_traffic_bits=up_total + dl_total,
                total_wall_s=float(h["cum_wall_s"][-1]
                                   + h["cum_downlink_wall_s"][-1]),
                total_energy_j=float(h["cum_energy_j"][-1]
                                     + h["cum_downlink_energy_j"][-1]),
                final_accuracy=float(h["accuracy"][-1]),
            ))
    return rows


def write_downlink_csv(rows: list[dict], path: str = DOWNLINK_CSV) -> str:
    """Write the two-sided sweep rows → ``path``."""
    return _write_csv(rows, DOWNLINK_COLUMNS, path)
