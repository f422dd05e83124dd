"""FedScalar protocol, Algorithm 1 (torch port of ``repro/core/fedscalar.py``).

One communication round::

  server broadcasts x_k
  each client n:   ψ₀ = x_k;  S local SGD steps;  δₙ = ψ_S − ψ₀
                   rₙ = ⟨δₙ, v(ξₙ)⟩          ── uploads (rₙ, ξₙ)
  server:          x_{k+1} = x_k + (lr/N) Σₙ rₙ·v(ξₙ)

The N clients' local SGD is one batched computation: parameters carry a
leading client axis and ``torch.autograd.grad`` of the summed per-client
losses gives every client's gradient (the reference's ``vmap``).

:func:`fedscalar_round` runs the round on the port's main path: the
cohort's encode through :func:`repro_torch.kernels.ops.project_tree_kernel`
and the server close through
:func:`repro_torch.kernels.ops.server_update_fused` (the reference's
``projection_mode="fused_kernel"`` serving path).  :func:`server_aggregate`
is the reference's per-client accumulation, kept as the plain oracle.
Seeds are int64 tensors holding 32-bit words.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.prng import Distribution, U32_MASK, mul32, u32
from repro_torch.core.projection import (
    ProjectionMode,
    project_tree,
    reconstruct_tree,
    tree_size,
)
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels import ops

__all__ = [
    "FedScalarConfig",
    "config_for_family",
    "family_of",
    "predicted_estimator_variance",
    "make_local_sgd",
    "encode_cohort",
    "client_stage",
    "server_aggregate",
    "server_aggregate_mesh",
    "fedscalar_round",
    "round_seeds",
    "round_seeds_for",
    "upload_bits_per_client",
]


@dataclasses.dataclass(frozen=True)
class FedScalarConfig:
    """Hyper-parameters of Algorithm 1 (+ beyond-paper extensions)."""

    local_steps: int = 5                 # S
    local_lr: float = 3e-3               # α
    server_lr: float = 1.0
    distribution: Distribution = Distribution.RADEMACHER
    num_projections: int = 1             # m
    mode: ProjectionMode = ProjectionMode.FULL
    error_feedback: bool = False
    scalar_bits: int = 32


def config_for_family(family, num_blocks: int = 1, **overrides) -> FedScalarConfig:
    """FedScalarConfig for a direction family and k block scalars."""
    from repro_torch.core.directions import get_family

    fam = get_family(family)
    mode = ProjectionMode.BLOCK if num_blocks > 1 else ProjectionMode.FULL
    return FedScalarConfig(distribution=fam.distribution,
                           num_projections=num_blocks, mode=mode, **overrides)


def family_of(cfg: FedScalarConfig):
    """→ the :class:`DirectionFamily` behind a config's distribution."""
    from repro_torch.core.directions import get_family

    return get_family(cfg.distribution)


def predicted_estimator_variance(cfg: FedScalarConfig, params: Any,
                                 total_sqnorm: float = 1.0) -> float:
    """Closed-form Var‖δ̂ − δ‖² for one client under this config.

    The family's (d − 2 + κ) model per block (the paper's Prop. 2.1 for
    κ = 3 and 1); in FULL mode the m projections divide it by m.
    """
    fam = family_of(cfg)
    d = tree_size(params)
    if cfg.mode == ProjectionMode.BLOCK and cfg.num_projections > 1:
        return fam.predicted_variance(d, cfg.num_projections,
                                      total_sqnorm=total_sqnorm)
    return fam.predicted_variance(d, 1, total_sqnorm=total_sqnorm) \
        / cfg.num_projections


def round_seeds_for(round_idx, client_ids, salt: int = 0x5EED,
                    device=None) -> torch.Tensor:
    """Deterministic 32-bit seeds ξ_{k,n} for explicit client ids.

    Both multipliers exceed 2³¹, so their products go through
    :func:`repro_torch.core.prng.mul32` to keep the low 32 bits exact.
    """
    k = u32(round_idx, device)
    n = u32(client_ids, device)
    x = mul32(k, 0x9E3779B9) ^ mul32(n, 0x85EBCA6B) ^ (salt & U32_MASK)
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & U32_MASK
    x = x ^ (x >> 15)
    return x


def round_seeds(round_idx: int, num_clients: int, salt: int = 0x5EED,
                device=None) -> torch.Tensor:
    """Per-(round, client) seeds for clients ``0 … N−1``."""
    ids = torch.arange(num_clients, dtype=torch.int64, device=device)
    return round_seeds_for(round_idx, ids, salt, device)


def make_local_sgd(grad_fn: Callable[[Any, Any], Any], lr: float,
                   steps: int) -> Callable[[Any, Any], Any]:
    """S plain-SGD steps for every client at once → δ with a leading client axis.

    ``grad_fn(params, batch)`` takes params and a batch that both carry
    the client axis and returns each client's gradient (e.g. autograd of
    the summed per-client losses).  ``batches`` carries ``(N, S, …)``
    leaves, one slice per local step.
    """

    def local(params, batches):
        n = tree_leaves(batches)[0].shape[0]
        p0 = tree_map(lambda w: w.unsqueeze(0).expand(n, *w.shape), params)
        p = p0
        for s in range(steps):
            g = grad_fn(p, tree_map(lambda b: b[:, s], batches))
            p = tree_map(lambda w, gg: w - lr * gg.to(w.dtype), p, g)
        return tree_map(lambda a, b: a - b, p, p0)

    return local


def encode_cohort(deltas: Any, seeds: torch.Tensor, cfg: FedScalarConfig,
                  ef_states: Any | None = None):
    """Encode every client's update → ``((N, m) scalars, new_ef_states)``.

    Leaves lead with the client axis.  The scalars come from one
    kernel-path call per leaf (:func:`ops.project_tree_kernel`).  Error
    feedback encodes ``δ + e`` with the contractive compressor
    ⟨x,v⟩/‖v‖²·v, as the reference does; its residual ``e ← δ + e − r·v``
    is rebuilt client by client with :func:`reconstruct_tree`.
    """
    if cfg.error_feedback:
        if ef_states is None:
            raise ValueError("error feedback needs ef_states")
        deltas = tree_map(lambda d, e: d + e.to(d.dtype), deltas, ef_states)
    rs = ops.project_tree_kernel(deltas, seeds, cfg.distribution,
                                 cfg.num_projections, cfg.mode)
    if not cfg.error_feedback:
        return rs, ef_states
    rs = rs / sum(leaf[0].numel() for leaf in tree_leaves(deltas))
    per_client = []
    for i in range(rs.shape[0]):
        x = tree_map(lambda d: d[i], deltas)
        rec = reconstruct_tree(x, seeds[i], rs[i], cfg.distribution,
                               cfg.num_projections, cfg.mode)
        per_client.append(tree_map(lambda d, h: (d - h).to(torch.float32),
                                   x, rec))
    return rs, tree_map(lambda *e: torch.stack(e), *per_client)


def client_stage(delta: Any, seed, cfg: FedScalarConfig,
                 ef_state: Any | None = None):
    """Encode one client's update → ``(r, new_ef_state)``; r is ``(m,)``.

    The one-client form of :func:`encode_cohort`.
    """
    device = tree_leaves(delta)[0].device
    seeds = torch.as_tensor(seed, dtype=torch.int64, device=device).reshape(1)
    if ef_state is not None:
        ef_state = tree_map(lambda e: e.unsqueeze(0), ef_state)
    rs, ef = encode_cohort(tree_map(lambda d: d.unsqueeze(0), delta), seeds,
                           cfg, ef_state)
    if cfg.error_feedback:
        ef = tree_map(lambda e: e[0], ef)
    return rs[0], ef


def server_aggregate(params: Any, rs: torch.Tensor, seeds: torch.Tensor,
                     cfg: FedScalarConfig, weights: torch.Tensor | None = None,
                     block_weights: torch.Tensor | None = None) -> Any:
    """Lines 7–13 client by client: regenerate each vₙ, form ĝ, update x."""
    n = rs.shape[0]
    total = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    for i in range(n):
        r_i = rs[i] if weights is None else rs[i] * weights[i]
        rec = reconstruct_tree(params, seeds[i], r_i, cfg.distribution,
                               cfg.num_projections, cfg.mode,
                               block_weights=block_weights)
        total = tree_map(lambda a, r_: a + r_.to(torch.float32), total, rec)
    # Divided by a device tensor: CUDA takes a division by a Python number
    # as a multiply by its reciprocal, the CPU (and the reference) as a
    # division; a tensor divisor is an IEEE division on both.
    if weights is None:
        n_f = torch.tensor(float(n), dtype=torch.float32,
                           device=tree_leaves(params)[0].device)
        ghat = tree_map(lambda t: t / n_f, total)
    else:
        ghat = total
    return tree_map(lambda p, g: (p + cfg.server_lr * g).to(p.dtype),
                    params, ghat)


def server_aggregate_mesh(params: Any, rs: torch.Tensor, seeds: torch.Tensor,
                          cfg: FedScalarConfig, mesh,
                          weights: torch.Tensor | None = None,
                          block_weights: torch.Tensor | None = None,
                          use_kernel: bool | None = None) -> Any:
    """Mesh-sharded lines 7–13: each shard rebuilds its own slice of d.

    ≡ the per-client decode kernel bit for bit (and ≈ :func:`server_aggregate`),
    with the flat parameter vector partitioned across ``mesh``; delegates to
    :func:`repro_torch.sharding.fed_rules.sharded_server_update`.
    """
    from repro_torch.sharding.fed_rules import sharded_server_update

    return sharded_server_update(
        mesh, params, rs, seeds, server_lr=cfg.server_lr,
        distribution=cfg.distribution, weights=weights, mode=cfg.mode,
        block_weights=block_weights, use_kernel=use_kernel)


def fedscalar_round(params: Any, client_batches: Any, round_idx,
                    grad_fn: Callable, cfg: FedScalarConfig,
                    ef_states: Any | None = None):
    """One FedScalar round over N explicit clients → ``(new_params, (aux, new_ef))``.

    ``client_batches`` leaves lead with ``(N, S, …)``.  The cohort is
    encoded by :func:`encode_cohort` and the close runs through the fused
    kernel path.
    """
    device = tree_leaves(params)[0].device
    n = tree_leaves(client_batches)[0].shape[0]
    seeds = round_seeds(round_idx, n, device=device)
    deltas = make_local_sgd(grad_fn, cfg.local_lr, cfg.local_steps)(
        params, client_batches)
    rs, new_ef = encode_cohort(deltas, seeds, cfg, ef_states)
    new_params = ops.server_update_fused(params, rs, seeds, cfg.server_lr,
                                         cfg.distribution, mode=cfg.mode)
    aux = {"r": rs, "seeds": seeds, "deltas_sqnorm": _sqnorms(deltas)}
    return new_params, (aux, new_ef)


def _sqnorms(deltas: Any) -> torch.Tensor:
    """Per-client ‖δₙ‖² (leading client axis)."""
    leaves = tree_leaves(deltas)
    n = leaves[0].shape[0]
    acc = torch.zeros((n,), dtype=torch.float32, device=leaves[0].device)
    for leaf in leaves:
        acc = acc + torch.sum(leaf.to(torch.float32).reshape(n, -1) ** 2, dim=1)
    return acc


def upload_bits_per_client(params: Any, cfg: FedScalarConfig) -> int:
    """Uplink payload per client per round: m scalars plus the u32 seed."""
    del params
    from repro_torch.fed.costmodel import upload_bits

    return upload_bits(cfg.num_projections, cfg.scalar_bits)
