"""End-to-end FedScalar training of a (reduced) dense LLM on the PyTorch port.

The port's counterpart of ``examples/federated_llm.py``: the same
``train_step`` that ``chip_smoke.py`` drives at full size — sequential
virtual clients, S local SGD steps, the encode kernel, the per-client
decode close — on the reduced variant of a dense architecture, over a
synthetic token stream, logging round metrics.  It runs on the card
unless asked otherwise::

    python examples/federated_llm_torch.py --arch smollm-360m --rounds 30
    python examples/federated_llm_torch.py --device cpu --rounds 6
    python examples/federated_llm_torch.py --full --batch 8 --seq 4096 \
        --rounds 2 --profile 1

``--full`` trains the published configuration (SmolLM-360M: 32 layers,
bf16) instead of the reduced one.  ``--profile N`` traces N rounds with
``torch.profiler`` after the others and prints the device's busy share
of the traced window (the union of its operations' intervals), its idle
time by the port span the host was in (``repro_torch.obs``) and the top
operators by device time and by host time.  The checkpointing substrate
is exercised at the end (save, restore, bit for bit).
"""
import argparse
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS, get_arch  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.train import FLRunConfig, make_train_step  # noqa: E402


def synthetic_token_stream(vocab: int, batch: int, seq: int, round_idx: int,
                           device="cuda"):
    """Deterministic Zipf-ish token batches (a stand-in corpus); the
    reference example's stream, token for token."""
    rng = np.random.RandomState(1000 + round_idx)
    probs = 1.0 / np.arange(1, vocab + 1) ** 1.1
    probs /= probs.sum()
    toks = torch.from_numpy(rng.choice(vocab, size=(batch, seq + 1), p=probs))
    toks = toks.to(resolve_device(device))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _profile(step, params, batches, dev):
    """Trace ``step`` over ``batches``; print the device's busy share, its
    idle time by the span the host was in, and the top operators.  → the params after the
    traced rounds."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for k, batch in batches:
            params, _ = step(params, batch, k)
        _sync(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    print(f"profile: {len(batches)} rounds, wall {wall_us / 1e3:.3f} ms")
    obs.print_device_time(prof, "profile")
    print(events.table(sort_by="self_device_time_total", row_limit=20))
    print(events.table(sort_by="self_cpu_time_total", row_limit=12))
    return params


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=list(ARCH_IDS))
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="the published configuration, not the reduced one")
    ap.add_argument("--profile", type=int, default=0,
                    help="trace this many rounds with torch.profiler, after the others")
    ap.add_argument("--ckpt", default=str(REPO / "checkpoints" / "fedllm_torch"),
                    help="checkpoint directory (the default is git-ignored)")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    arch = get_arch(args.arch, reduced=not args.full)
    print(f"arch={arch.cfg.name} ({arch.cfg.arch_type}), "
          f"vocab={arch.cfg.vocab_size}, device={dev}")
    params = arch.init(seed=0, device=dev)
    d = sum(p.numel() for p in tree_leaves(params))
    print(f"d = {d:,} params → FedScalar uplink: 64 bits/client/round "
          f"(FedAvg would be {32 * d:,})")

    fl = FLRunConfig(num_virtual_clients=args.clients, local_steps=args.steps,
                     local_lr=args.lr)
    step = make_train_step(arch, fl)

    for k in range(args.rounds):
        batch = synthetic_token_stream(arch.cfg.vocab_size, args.batch,
                                       args.seq, k, dev)
        t0 = time.perf_counter()
        params, metrics = step(params, batch, k)
        _sync(dev)
        if k % 5 == 0 or k == args.rounds - 1:
            print(f"round {k:3d}: loss={float(metrics['loss']):.4f} "
                  f"r_rms={float(metrics['r_rms']):.3g} "
                  f"uplink={metrics['uploaded_scalars']} scalars "
                  f"({time.perf_counter() - t0:.2f}s)")
    if args.profile:
        batches = [(k, synthetic_token_stream(arch.cfg.vocab_size, args.batch,
                                              args.seq, k, dev))
                   for k in range(args.rounds, args.rounds + args.profile)]
        params = _profile(step, params, batches, dev)

    path = save_checkpoint(args.ckpt, params, step=args.rounds,
                           metadata={"arch": args.arch})
    like = tree_map(lambda w: torch.empty(w.shape, dtype=w.dtype, device="meta"),
                    params)
    restored, restored_step, meta = restore_checkpoint(path, like, device=dev)
    # bit for bit (NaN included: at its defaults the run can diverge, as
    # the reference example's does)
    same = all(torch.equal(a.flatten().view(torch.uint8),
                           b.flatten().view(torch.uint8))
               for a, b in zip(tree_leaves(restored), tree_leaves(params)))
    if not same:
        raise SystemExit("checkpoint: restored params differ from the saved ones")
    print(f"checkpoint ok: {path} (step={restored_step}, meta={meta}, "
          f"bit for bit)")


if __name__ == "__main__":
    main()
