"""Quickstart on the PyTorch/CUDA port: the FedScalar primitive in 40 lines.

Counterpart of ``examples/quickstart.py``.  Encodes a toy update tree into
ONE scalar, ships (scalar, seed) over the "wire", regenerates the random
vector server-side, and checks that the decoded update is an unbiased
estimate.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.core.prng import Distribution  # noqa: E402
from repro_torch.core.projection import project_tree, reconstruct_tree  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    dev = torch.device(args.device)

    # a fake local model update δ (any tree of tensors works)
    rng = np.random.RandomState(0)
    delta = {
        "layer1": {"w": torch.as_tensor(rng.randn(64, 32), dtype=torch.float32,
                                        device=dev),
                   "b": torch.as_tensor(rng.randn(32), dtype=torch.float32,
                                        device=dev)},
        "head": torch.as_tensor(rng.randn(32, 10), dtype=torch.float32,
                                device=dev),
    }
    d = sum(x.numel() for x in tree_leaves(delta))
    print(f"model dimension d = {d}  (device {args.device})")

    # ---- client: encode to ONE scalar ---------------------------------
    seed = 1234                               # ξ — a 32-bit integer
    r = project_tree(delta, seed, Distribution.RADEMACHER)
    print(f"uplink payload: r = {float(r[0]):+.4f}  plus seed {seed}  (64 bits "
          f"total, vs {32 * d} bits for FedAvg)")

    # ---- server: decode from (r, seed) --------------------------------
    decoded = reconstruct_tree(delta, seed, r, Distribution.RADEMACHER)
    print("decoded update shapes:", tree_map(lambda x: tuple(x.shape), decoded))

    # ---- unbiasedness: average decodes over many seeds → recovers δ ---
    n = 2000
    acc = tree_map(torch.zeros_like, delta)
    for s in range(n):
        r_s = project_tree(delta, s, Distribution.RADEMACHER)
        dec = reconstruct_tree(delta, s, r_s, Distribution.RADEMACHER)
        acc = tree_map(lambda a, x: a + x / n, acc, dec)
    num = sum(float(torch.sum((a - b) ** 2))
              for a, b in zip(tree_leaves(acc), tree_leaves(delta)))
    den = sum(float(torch.sum(b ** 2)) for b in tree_leaves(delta))
    print(f"E[decode] vs δ relative error after {n} seeds: "
          f"{np.sqrt(num / den):.3f}  (theory ≈ sqrt(d/n) = "
          f"{np.sqrt(d / n):.3f})")


if __name__ == "__main__":
    main()
