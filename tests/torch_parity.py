"""Shared fixtures of the PyTorch port's parity tests (``test_torch_*.py``).

* ``jax_kernels`` reaches ``repro.kernels.ops`` / ``ref`` /
  ``reconstruct_apply`` / ``tune``.  Under jax 0.9 those modules fail to import:
  ``repro.core.compat.ensure_optimization_barrier_batching`` raises
  ``TypeError`` on ``prim in batching.primitive_batchers``, and jax 0.9
  already batches the barrier.  The fixture stubs that function to a
  no-op, imports the modules, and on teardown restores the function and
  removes every ``repro.kernels.*`` module it imported (from
  ``sys.modules`` and from the parent package), so other test files see
  exactly the import behaviour they would have seen without it.
* ``jax_sharding`` reaches ``repro.sharding.fed_rules`` and
  ``repro.launch.mesh`` the same way (their paths import
  ``repro.kernels.ops``), and removes them on teardown.
* ``cuda_device`` skips a test unless a card is present; it decides
  when the test runs, never at import or collection.
* ``digits_shards`` and ``patch_shared_draws`` give the engine parity
  tests one dataset and one batch-index table for both packages (the
  reference draws batches with threefry, which the port does not
  reproduce); ``STAT_KEYS`` are the history arrays those tests hold
  bitwise.
* ``server_core`` and ``closed_round`` give the engine's server alone
  (an ``EngineCore`` with no client data) and one closed round's
  buffers, for the tests of ``EngineCore.apply_round``'s staging.
* ``MoERoutes`` records the MoE routes of one run (on the card) and
  replays them in another (on the CPU); ``chip_smoke.py`` uses it too,
  so it imports neither jax nor pytest fixtures.
"""
from __future__ import annotations

import contextlib
import sys
import types

import numpy as np
import pytest


def _stubbed_imports(prefixes: tuple, load):
    """Yield ``load()`` run with the compat shim stubbed; on teardown
    restore the shim and remove every module under ``prefixes`` that the
    call imported."""
    import repro.core.compat as compat

    before = {m for m in sys.modules if m.startswith(prefixes)}
    mp = pytest.MonkeyPatch()
    mp.setattr(compat, "ensure_optimization_barrier_batching", lambda: None)
    try:
        yield load()
    finally:
        mp.undo()
        added = [m for m in sys.modules
                 if m.startswith(prefixes) and m not in before]
        for name in sorted(added, reverse=True):
            mod = sys.modules.pop(name)
            parent, _, child = name.rpartition(".")
            if getattr(sys.modules.get(parent), child, None) is mod:
                delattr(sys.modules[parent], child)


@pytest.fixture(scope="module")
def jax_kernels():
    def load():
        from repro.kernels import ops, reconstruct_apply, ref, tune

        return types.SimpleNamespace(ops=ops, ref=ref,
                                     reconstruct_apply=reconstruct_apply,
                                     tune=tune)

    yield from _stubbed_imports(("repro.kernels",), load)


@pytest.fixture(scope="module")
def jax_sharding():
    """``repro.sharding.fed_rules`` and ``repro.launch.mesh`` (and the
    ``repro.kernels`` modules their paths import), as ``jax_kernels``."""
    def load():
        from repro.kernels import ops
        from repro.launch import mesh
        from repro.sharding import fed_rules

        return types.SimpleNamespace(fed_rules=fed_rules, mesh=mesh, ops=ops)

    yield from _stubbed_imports(("repro.kernels", "repro.sharding",
                                 "repro.launch.mesh"), load)


class Elsewhere:
    """A tensor on a device the port serves neither as a card, the CPU nor
    ``meta`` (``xpu``): no storage, and any op on it fails.  The wrappers'
    device checks must refuse it before touching it."""

    def __new__(cls, shape, dtype=None):
        import torch

        class _Elsewhere(torch.Tensor):
            @staticmethod
            def __new__(inner, shape, dtype):
                return torch.Tensor._make_wrapper_subclass(
                    inner, shape, dtype=dtype, device=torch.device("xpu"))

            @classmethod
            def __torch_dispatch__(inner, func, types, args=(), kwargs=None):
                raise RuntimeError(f"{func} on a tensor of another device")

        return _Elsewhere(shape, torch.float32 if dtype is None else dtype)


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


def server_core(params, device, **cfg_kw):
    """An ``EngineCore`` around ``params`` whose server alone is used:
    FedScalar (Rademacher, k = 1), ``cfg_kw`` laid over the defaults."""
    import torch
    from repro_torch.core.projection import tree_size
    from repro_torch.fed.runtime.engine import EngineCore, RuntimeConfig

    def unused(*_a, **_k):
        raise AssertionError("the server alone is used")

    cfg = RuntimeConfig(**{"population": 2000, **cfg_kw})
    one = (np.zeros((1, 1), np.float32), np.zeros(1, np.int64))
    return EngineCore(cfg, params, [one], one[0], one[1], unused, (unused, unused),
                      None, cfg.build_protocol(params), tree_size(params),
                      torch.device(device))


def closed_round(a: int, seed: int):
    """One closed round of ``a`` applied uploads, as
    ``StreamingAggregator.close_round`` hands them over → ``(aseeds,
    acoeffs, ars, st)``."""
    from repro_torch.fed.runtime.server import RoundStats

    rng = np.random.RandomState(seed)
    return (seeds_np(rng, a), rng.rand(a) * 2.0,
            (0.2 * rng.randn(a, 1)).astype(np.float32),
            RoundStats(round_idx=0, offered=a, applied=a))


# The engine history's per-round counters and costs: equal bit for bit
# between the port and the reference on one shared batch draw.
STAT_KEYS = ("cohort_size", "applied", "applied_stale", "lost_channel",
             "dropped_deadline", "dropped_stale", "weight_sum", "cum_bits",
             "cum_downlink_bits", "cum_wall_s", "cum_energy_j",
             "cum_downlink_wall_s", "cum_downlink_energy_j", "catchup_bits",
             "dense_resyncs")


def digits_shards(shards: int, n_samples: int = 400):
    """The digits data split into ``shards`` client shards → (clients, x_test, y_test)."""
    from repro.data import load_digits, make_client_datasets, train_test_split_arrays

    x, y = load_digits(n_samples=n_samples)
    xtr, ytr, xte, yte = train_test_split_arrays(x, y)
    return make_client_datasets(xtr, ytr, shards), xte, yte


def patch_shared_draws(monkeypatch, clients, table_seed: int,
                       rounds: int, population: int, s: int, b: int) -> None:
    """Patch both packages' ``draw_cohort_batches`` with one index table
    of shape (rounds, population, s, b), drawn from ``table_seed``."""
    import jax.numpy as jnp
    import torch
    from repro.fed.runtime import engine as jengine
    from repro_torch.fed.runtime import engine as tengine

    n_per = max(len(c[1]) for c in clients)
    table = np.random.RandomState(table_seed).randint(
        0, n_per, size=(rounds, population, s, b))

    def j_draw(cx, cy, num_shards, seed, round_idx, client_ids, s, b):
        c = client_ids.shape[0]
        idx = jnp.asarray(table)[round_idx, client_ids].reshape(c, s * b)
        shard = (client_ids % num_shards).astype(jnp.int32)
        sx, sy = cx[shard], cy[shard]
        bx = jnp.take_along_axis(sx[:, :, None, :], idx[:, :, None, None],
                                 axis=1).reshape((c, s, b) + sx.shape[2:])
        by = jnp.take_along_axis(sy, idx, axis=1).reshape(c, s, b)
        return bx, by

    def t_draw(cx, cy, num_shards, seed, round_idx, client_ids, s, b):
        ids = client_ids.cpu().numpy()
        c = len(ids)
        idx = torch.from_numpy(table[int(round_idx)][ids].reshape(c, s * b))
        rows = torch.from_numpy(ids % num_shards)[:, None]
        bx = cx[rows, idx].reshape((c, s, b) + tuple(cx.shape[2:]))
        by = cy[rows, idx].reshape(c, s, b)
        return bx, by

    monkeypatch.setattr(jengine, "draw_cohort_batches", j_draw)
    monkeypatch.setattr(tengine, "draw_cohort_batches", t_draw)


class MoERoutes:
    """``repro_torch.models.moe._route`` recorded in one run, replayed in
    another.

    Inside ``use("record")`` each call's expert indices are kept; inside
    ``use("replay")`` they are handed back in call order, with the
    probabilities gathered from the replaying run's own logits.  Float32
    router sums differ in order between the card and the CPU, so a route
    may flip at a near tie: the replay counts the tokens whose own choice
    differs (``differ`` of ``tokens``) and the largest logit margin at
    such a difference (``margin``: how far a recorded expert's logit falls
    below the replaying run's k-th).  ``check`` fails unless every call
    was replayed and every difference falls at a near tie (``margin`` ≤
    ``NEAR_TIE``), so a routing fault on the recording side cannot hide
    behind the replay."""

    NEAR_TIE = 1e-4

    def __init__(self):
        import repro_torch.models.moe as moe

        self.moe, self.route = moe, moe._route
        self.recorded, self.replayed = [], 0
        self.differ, self.tokens, self.margin = 0, 0, 0.0

    def record(self, logits, k):
        vals, idx = self.route(logits, k)
        self.recorded.append(idx)
        return vals, idx

    def replay(self, logits, k):
        idx = self.recorded[self.replayed].to(logits.device)
        self.replayed += 1
        own_v, own = self.route(logits, k)
        diff = (own.sort(-1).values != idx.sort(-1).values).any(-1)
        self.tokens += diff.numel()
        self.differ += int(diff.sum())
        if bool(diff.any()):
            gap = own_v[:, -1:] - logits.gather(-1, idx)
            self.margin = max(self.margin, float(gap[diff].max()))
        return logits.gather(-1, idx), idx

    @contextlib.contextmanager
    def use(self, mode: str):
        """``moe._route`` is ``record`` or ``replay`` inside the block."""
        self.moe._route = getattr(self, mode)
        try:
            yield
        finally:
            self.moe._route = self.route

    def check(self, what: str = "") -> None:
        if self.replayed != len(self.recorded):
            raise AssertionError(f"{what}: {self.replayed} routes replayed of "
                                 f"{len(self.recorded)} recorded")
        if self.margin > self.NEAR_TIE:
            raise AssertionError(f"{what}: {self.differ} of {self.tokens} routes "
                                 f"differ, one by a logit margin of {self.margin} "
                                 f"(a near tie is at most {self.NEAR_TIE})")
