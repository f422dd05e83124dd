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
versions.

``make_train_step_client_parallel`` is the reference's client-parallel
placement: the N replicas are stacked (N, …) and the clients' local SGD
is one batched computation, each stage of the forward under
``torch.func.vmap`` over the client axis (``Arch.loss(...,
clients=True)``: a period's checkpoint wraps its vmap) and the gradient
of the summed per-client losses taken by autograd: client n's loss
depends on replica n alone, so the stacked gradient is each client's own,
the reference's ``jax.vmap`` of ``value_and_grad``.  The N stacked δ are
encoded by one ``ops.project_tree_kernel`` call over the kernel's leading
client axis; the close is the sequential step's.  It costs N param copies
and N clients' activations at once.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.fedscalar import FedScalarConfig, round_seeds
from repro_torch.core.prng import Distribution
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels import ops
from repro_torch.sharding.activations import batch_mode

__all__ = ["FLRunConfig", "make_train_step", "make_train_step_client_parallel"]


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
        sb = _split_batch(batch, n, s)
        device = tree_leaves(params)[0].device
        seeds = round_seeds(int(round_idx), n, device=device)

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


def _split_batch(batch, n: int, s: int):
    """(GB, …) leaves → (N, S, per_step, …), as the reference's reshape."""
    gb = tree_leaves(batch)[0].shape[0]
    if gb % n:
        raise ValueError(f"global batch {gb} does not split over {n} clients")
    if (gb // n) % s:
        raise ValueError(f"client batch {gb // n} does not split over {s} local steps")
    per_step = gb // n // s
    return tree_map(lambda x: x.reshape((n, s, per_step) + tuple(x.shape[1:])), batch)


def make_train_step_client_parallel(arch, fl: FLRunConfig, param_spec_tp=None,
                                    window: Optional[int] = None):
    """→ ``train_step(params, batch, round_idx) -> (new_params, metrics)``,
    the client-parallel placement; the same contract and metrics as
    :func:`make_train_step`.

    ``param_spec_tp`` is the reference's placement of the replicas over a
    mesh's model axis; one process places nothing, and it is kept only so
    that the signature matches the reference's.  The replicas' local steps run with
    ``batch_mode("off")``, as the reference's (the client axis owns the
    data axis).
    """
    del param_spec_tp
    pcfg = fl.protocol()

    def train_step(params: Any, batch: Any, round_idx):
        n, s = fl.num_virtual_clients, fl.local_steps
        sb = _split_batch(batch, n, s)
        device = tree_leaves(params)[0].device
        seeds = round_seeds(int(round_idx), n, device=device)
        with batch_mode("off"):
            p = tree_map(lambda w: w.detach()[None].expand(
                (n,) + tuple(w.shape)).clone().requires_grad_(True), params)
            leaves = tree_leaves(p)
            lsum = None
            for step in range(s):
                losses = arch.loss(p, tree_map(lambda x: x[:, step], sb),
                                   window=window, clients=True)
                grads = torch.autograd.grad(losses.sum(), leaves)
                with torch.no_grad():
                    for w, g in zip(leaves, grads):
                        w.sub_(fl.local_lr * g.to(w.dtype))
                del grads
                losses = losses.detach().to(torch.float32)
                lsum = losses if lsum is None else lsum + losses
            with torch.no_grad():
                for w, w0 in zip(leaves, tree_leaves(params)):
                    w.sub_(w0)                       # δ = ψ_S − x, leaf dtype
            deltas = tree_map(lambda w: w.detach(), p)
            del p, leaves
            rs = ops.project_tree_kernel(deltas, seeds, pcfg.distribution,
                                         pcfg.num_projections, pcfg.mode)
            del deltas
        with torch.no_grad():
            new_params = ops.server_update_kernel(
                params, rs, seeds, pcfg.server_lr, pcfg.distribution,
                mode=pcfg.mode, per_client_rounding=True)
        losses = lsum / s
        metrics = {
            "loss": torch.mean(losses),
            "r_rms": torch.sqrt(torch.mean(rs.to(torch.float32) ** 2)),
            "uploaded_scalars": n * (pcfg.num_projections + 1),
            "r": rs,
            "seeds": seeds,
        }
        return new_params, metrics

    return train_step
