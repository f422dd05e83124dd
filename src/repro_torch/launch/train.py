"""FedScalar training of an LLM: one ``train_step`` = one round (Algorithm 1).

Port of ``repro/launch/train.py``'s sequential placement
(``make_train_step``).  One round over ``num_virtual_clients`` cohort
members, one after another:

  * the global batch is split into per-client slices ``(N, S, per_step, …)``
    by reshape;
  * each client copies the global params and runs S local SGD steps,
    ``w ← w − α·g`` with the gradient from ``torch.autograd`` over
    ``arch.loss`` (full-remat periods, as the reference's scanned layers);
  * its update δₙ = ψ_S − x is formed in the leaf dtype and never leaves
    the client: the encode kernel turns it into rₙ = ⟨δₙ, v(ξₙ)⟩
    (``ops.project_tree_kernel``, one tree launch per client);
  * the server regenerates every v(ξₙ) from its seed and applies
    x ← x + lr·(Σₙ rₙ·v(ξₙ))/N through the per-client decode kernel in its
    per-client-rounding mode (``ops.server_update_kernel(...,
    per_client_rounding=True)``): as the reference's ``server_aggregate``
    (``repro/launch/train.py``'s close), each client's reconstruction is
    rounded to the leaf dtype before the float32 sum, so the close is
    the port's ``server_aggregate`` bit for bit for the ±1/±2 families,
    on bf16 leaves as on float32 ones.

Sequential placement keeps one param copy and one delta alive besides the
global params whatever the cohort size: the copy is updated in place and
turned into the delta in place.  On the card the encode and the close are
the hand-written kernels, with no fallback; on the CPU their plain
versions.  The client-parallel placement
(``make_train_step_client_parallel``) is not ported: the reference's only
caller of it is its TPU dry run (``launch/dryrun.py``), not ported either.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.fedscalar import FedScalarConfig, round_seeds
from repro_torch.core.prng import Distribution
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels import ops

__all__ = ["FLRunConfig", "make_train_step"]


@dataclasses.dataclass(frozen=True)
class FLRunConfig:
    """FL execution config for the production round."""

    num_virtual_clients: int = 4      # cohort members simulated per round
    local_steps: int = 2              # S
    local_lr: float = 3e-3            # α
    server_lr: float = 1.0
    distribution: Distribution = Distribution.RADEMACHER
    num_projections: int = 1

    def protocol(self) -> FedScalarConfig:
        return FedScalarConfig(
            local_steps=self.local_steps,
            local_lr=self.local_lr,
            server_lr=self.server_lr,
            distribution=self.distribution,
            num_projections=self.num_projections,
        )


def make_train_step(arch, fl: FLRunConfig, window: Optional[int] = None):
    """→ ``train_step(params, batch, round_idx) -> (new_params, metrics)``.

    ``batch`` leaves lead with the global batch (``tokens``, ``labels``);
    ``params`` is the global tree, left unchanged.  ``metrics``: ``loss``
    (mean over clients of the mean over local steps, float32), ``r_rms``,
    ``uploaded_scalars`` = N·(k+1), and the round's uploads ``r`` (N, k)
    and ``seeds`` (N,).
    """
    pcfg = fl.protocol()

    def loss_fn(params, batch):
        return arch.loss(params, batch, window=window)

    def client_update(params, client_batches, s: int):
        """S local SGD steps from ``params`` → (δ in place of the copy, Σ loss)."""
        p = tree_map(lambda w: w.detach().clone().requires_grad_(True), params)
        leaves = tree_leaves(p)
        lsum = None
        for step in range(s):
            b = tree_map(lambda x: x[step], client_batches)
            loss = loss_fn(p, b)
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                for w, g in zip(leaves, grads):
                    w.sub_(fl.local_lr * g.to(w.dtype))
            del grads
            loss = loss.detach().to(torch.float32)
            lsum = loss if lsum is None else lsum + loss
        with torch.no_grad():
            for w, w0 in zip(leaves, tree_leaves(params)):
                w.sub_(w0)                           # δ = ψ_S − x, leaf dtype
        return tree_map(lambda w: w.detach(), p), lsum

    def train_step(params: Any, batch: Any, round_idx):
        n = fl.num_virtual_clients
        s = fl.local_steps
        gb = tree_leaves(batch)[0].shape[0]
        if gb % n:
            raise ValueError(f"global batch {gb} does not split over {n} clients")
        bc = gb // n
        if bc % s:
            raise ValueError(f"client batch {bc} does not split over {s} local steps")
        per_step = bc // s
        device = tree_leaves(params)[0].device
        seeds = round_seeds(int(round_idx), n, device=device)
        sb = tree_map(lambda x: x.reshape((n, s, per_step) + tuple(x.shape[1:])),
                      batch)

        rs, losses = [], []
        for i in range(n):
            delta, lsum = client_update(
                params, tree_map(lambda x: x[i], sb), s)
            rs.append(ops.project_tree_kernel(
                tree_map(lambda d: d.unsqueeze(0), delta), seeds[i:i + 1],
                pcfg.distribution, pcfg.num_projections, pcfg.mode))
            losses.append(lsum / s)
            del delta
        rs = torch.cat(rs)

        with torch.no_grad():
            new_params = ops.server_update_kernel(
                params, rs, seeds, pcfg.server_lr, pcfg.distribution,
                mode=pcfg.mode, per_client_rounding=True)
        metrics = {
            "loss": torch.mean(torch.stack(losses)),
            "r_rms": torch.sqrt(torch.mean(rs.to(torch.float32) ** 2)),
            "uploaded_scalars": n * (pcfg.num_projections + 1),
            "r": rs,
            "seeds": seeds,
        }
        return new_params, metrics

    return train_step
