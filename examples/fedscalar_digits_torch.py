"""The paper's §III experiment on the PyTorch/CUDA port (FedScalar methods).

Trains the d = 1990 MLP on synthetic 8×8 digits across N = 20 clients
with S = 5 local steps, through ``repro_torch.fed.simulation.run_simulation``
(kernel encode and fused kernel close on the card).

Usage::

    PYTHONPATH=src python examples/fedscalar_digits_torch.py \\
        [--rounds 300] [--methods fedscalar_rademacher ...] \\
        [--device cuda] [--profile 20]

Prints, per method, the loss, the final accuracy and rounds per second.
``--profile N`` traces N rounds of the first method with
``torch.profiler`` (after a warm-up run) and prints the device's busy
share of the traced wall time, and the top operators by device time and
by host time.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.data import load_digits, make_client_datasets, train_test_split_arrays
from repro_torch.fed.simulation import SimulationConfig, run_simulation
from repro_torch.models.mlp_classifier import init_mlp


def _profile(cfg, clients, xte, yte, device, rounds: int) -> None:
    from torch.autograd import DeviceType
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
    # Kernel rows only: operator rows repeat their kernels' device time.
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA)
    print(f"profile: {cfg.method}, {rounds} rounds, wall {wall_us / 1e3:.3f} ms, "
          f"device busy {dev_us / 1e3:.3f} ms ({100 * dev_us / wall_us:.2f}% of wall), "
          f"{wall_us / rounds / 1e3:.3f} ms/round")
    print(events.table(sort_by="self_device_time_total", row_limit=12))
    print(events.table(sort_by="self_cpu_time_total", row_limit=12))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--methods", nargs="*", default=[
        "fedscalar_rademacher", "fedscalar_gaussian", "fedscalar_block8",
        "fedscalar_ef"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", type=int, default=0,
                    help="trace this many rounds of the first method")
    args = ap.parse_args()

    x, y = load_digits()
    xtr, ytr, xte, yte = train_test_split_arrays(x, y)
    clients = make_client_datasets(xtr, ytr, 20)
    for method in args.methods:
        cfg = SimulationConfig(method=method, rounds=args.rounds, seed=args.seed)
        h = run_simulation(cfg, init_mlp(seed=args.seed, device=args.device),
                           clients, xte, yte, device=args.device)
        rate = (args.rounds - 1) / h["sim_compute_seconds"] if args.rounds > 1 else 0.0
        print(f"{method}: loss {h['loss'][0]:.4f} -> {h['loss'][-1]:.4f}, "
              f"accuracy {h['accuracy'][-1]:.4f}, first round "
              f"{h['sim_compile_seconds']:.3f} s, {rate:.1f} rounds/s after it")
    if args.profile:
        cfg = SimulationConfig(method=args.methods[0], rounds=args.profile)
        _profile(cfg, clients, xte, yte, args.device, args.profile)


if __name__ == "__main__":
    main()
