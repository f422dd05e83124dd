"""Shared fixtures of the PyTorch port's parity tests (``test_torch_*.py``).

* ``jax_kernels`` reaches ``repro.kernels.ops`` / ``ref`` /
  ``reconstruct_apply``.  Under jax 0.9 those modules fail to import:
  ``repro.core.compat.ensure_optimization_barrier_batching`` raises
  ``TypeError`` on ``prim in batching.primitive_batchers``, and jax 0.9
  already batches the barrier.  The fixture stubs that function to a
  no-op, imports the modules, and on teardown restores the function and
  removes every ``repro.kernels.*`` module it imported (from
  ``sys.modules`` and from the parent package), so other test files see
  exactly the import behaviour they would have seen without it.
* ``cuda_device`` skips a test unless a card is present; it decides
  when the test runs, never at import or collection.
"""
from __future__ import annotations

import sys
import types

import numpy as np
import pytest


@pytest.fixture(scope="module")
def jax_kernels():
    import repro.core.compat as compat

    before = {m for m in sys.modules if m.startswith("repro.kernels")}
    mp = pytest.MonkeyPatch()
    mp.setattr(compat, "ensure_optimization_barrier_batching", lambda: None)
    try:
        from repro.kernels import ops, reconstruct_apply, ref

        yield types.SimpleNamespace(ops=ops, ref=ref,
                                    reconstruct_apply=reconstruct_apply)
    finally:
        mp.undo()
        added = [m for m in sys.modules
                 if m.startswith("repro.kernels") and m not in before]
        for name in sorted(added, reverse=True):
            mod = sys.modules.pop(name)
            parent, _, child = name.rpartition(".")
            if getattr(sys.modules.get(parent), child, None) is mod:
                delattr(sys.modules[parent], child)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def mlp_params_np(seed: int = 0, noise: float = 0.1) -> dict:
    """The paper MLP's params as numpy, with nonzero biases (for parity)."""
    from repro.models.mlp_classifier import init_mlp

    rng = np.random.RandomState(seed + 1000)
    out = {}
    for k, v in init_mlp(seed=seed).items():
        v = np.asarray(v)
        out[k] = (v + noise * rng.randn(*v.shape)).astype(np.float32)
    return out


def seeds_np(rng: np.random.RandomState, n: int) -> np.ndarray:
    return rng.randint(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
