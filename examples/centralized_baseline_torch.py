"""Centralized (non-federated) training baseline with Adam, on the PyTorch port.

The port's counterpart of ``examples/centralized_baseline.py``: the paper
MLP on the digits task trained centrally with Adam and a warmup-cosine
schedule — the ``repro_torch.optim`` substrate end to end, and the
accuracy ceiling for the FL methods.  Batches are drawn from a
``torch.Generator`` (the reference uses ``jax.random``), so the curves
agree in shape, not step for step.  It runs on the card unless asked
otherwise::

    python examples/centralized_baseline_torch.py [--steps 600]
    python examples/centralized_baseline_torch.py --device cpu
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402

from repro_torch.data import load_digits, train_test_split_arrays  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.mlp_classifier import init_mlp, mlp_accuracy, mlp_loss  # noqa: E402
from repro_torch.optim import adam, warmup_cosine  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    x, y = load_digits()
    xtr, ytr, xte, yte = (torch.as_tensor(a).to(dev)
                          for a in train_test_split_arrays(x, y))
    xtr, xte = xtr.to(torch.float32), xte.to(torch.float32)

    params = init_mlp(device=dev)
    sched = warmup_cosine(args.lr, warmup_steps=50, total_steps=args.steps)
    init_opt, _ = adam(args.lr)
    state = init_opt(params)
    gen = torch.Generator().manual_seed(0)

    for k in range(args.steps):
        idx = torch.randint(0, xtr.shape[0], (args.batch,), generator=gen).to(dev)
        keys = sorted(params)
        leaves = [params[key].detach().requires_grad_(True) for key in keys]
        loss = mlp_loss(dict(zip(keys, leaves)), (xtr[idx], ytr[idx]))
        grads = dict(zip(keys, torch.autograd.grad(loss, leaves)))
        _, update = adam(sched(k).to(dev))
        with torch.no_grad():
            params, state = update(grads, state, params)
        if k % 100 == 0 or k == args.steps - 1:
            acc = mlp_accuracy(params, xte, yte)
            print(f"step {k:4d}: loss={float(loss.detach()):.4f} "
                  f"test_acc={float(acc):.4f}")
    print(f"\ncentralized ceiling: {float(mlp_accuracy(params, xte, yte)):.4f} "
          f"(FL methods at K=1500 reach ≈0.91–0.93)")


if __name__ == "__main__":
    main()
