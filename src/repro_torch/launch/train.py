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

The round's stages are the port's spans (``obs.py``): ``train.forward``,
``train.backward`` and ``train.update`` in every local step (the mesh and
client-parallel steps' too), ``train.encode`` and ``train.close`` in the
unsharded step; ``train.tokens`` counts the tokens through local steps.

Sequential placement keeps one param copy and one delta alive besides the
global params whatever the cohort size: the copy is updated in place and
turned into the delta in place.  On the card the encode and the close are
the hand-written kernels, with no fallback; on the CPU their plain
versions.

With a ``mesh`` (``launch/mesh.py``) ``make_train_step`` runs the same
round on parameters resident in shards across the mesh's devices
(``sharding/resident.py``), one process driving every device, ZeRO-3
over the ``data`` axis as the reference's round on its pod mesh:

  * x and each client's ψ stay in the server's shard layout
    (``fed_rules.plan_tree``); ψ is a shard-by-shard copy of x;
  * each local step splits its batch over ``mesh.data_groups()``; a
    group computes on its first shard's device, gathering each period's
    weights from the shards inside the period's checkpoint, and the
    step's loss is the mean of the groups' losses.  Autograd sums each
    shard's gradient, over every gather and every group, on the shard's
    device, and ``w −= α·g`` runs shard by shard in the leaf dtype;
  * δ = ψ − x is formed in place, shard by shard; the encode
    (``fed_rules.sharded_project_tree``) and the per-client-rounding
    close (``fed_rules.sharded_apply_blocks``) run on the shards where
    they lie, one tree launch per device per 64 (shard, leaf) entries.

With one data group the loss, each δ and (given the same r) the new
parameters are the unsharded step's bit for bit; only the encode's sum
order differs.  An MoE layer dispatches each group as the step's whole
batch (``models/moe.py::BatchDispatch``): the same capacity and the same
dropped tokens as the unsharded step's.

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

from repro_torch import obs
from repro_torch.core.fedscalar import FedScalarConfig, round_seeds
from repro_torch.core.prng import Distribution
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels import ops
from repro_torch.launch.mesh import FedMesh
from repro_torch.models.moe import BatchDispatch
from repro_torch.sharding import fed_rules
from repro_torch.sharding.activations import batch_mode
from repro_torch.sharding.resident import ReplicaStack, ResidentTree, place_rows
from repro_torch.sharding.rules import _spec_paths, path_str

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


# The mesh axes a batch may be split over (the reference's ``dp_axes``).
DP_AXES = ("pod", "data", "model")


def make_train_step(arch, fl: FLRunConfig, window: Optional[int] = None,
                    mesh: Optional[FedMesh] = None, dp_axes: tuple = ("data",)):
    """→ ``train_step(params, batch, round_idx) -> (new_params, metrics)``.

    ``batch`` leaves lead with the global batch (``tokens``, ``labels``);
    ``params`` is the global tree, left unchanged.  ``metrics``: ``loss``
    (mean over clients of the mean over local steps, float32), ``r_rms``,
    ``uploaded_scalars`` = N·(k+1), and the round's uploads ``r`` (N, k)
    and ``seeds`` (N,).  With ``mesh``, ``params`` and ``new_params`` are
    :class:`~repro_torch.sharding.resident.ResidentTree` s on it (the
    module docstring).  ``dp_axes`` are the mesh axes the batch is split
    over, as the reference's: ``("data",)`` (or with ``"pod"``) splits each
    step's batch over the mesh's data rows, and with ``"model"`` over every
    entry of the mesh (the reference's ``dp256`` variant); off a mesh the
    split does not arise.
    """
    if not dp_axes or any(a not in DP_AXES for a in dp_axes) or "data" not in dp_axes:
        raise ValueError(f"dp_axes {dp_axes}: want 'data' and any of {DP_AXES}")
    if mesh is not None:
        return _make_mesh_train_step(arch, fl, window, mesh, dp_axes)
    pcfg = fl.protocol()

    def client_update(params, client_batches, s: int):
        """S local SGD steps from ``params`` → (δ in place of the copy, Σ loss)."""
        p = tree_map(lambda w: w.detach().clone().requires_grad_(True), params)
        lsum = _local_sgd(tree_leaves(p), tree_leaves(params),
                          lambda b: arch.loss(p, b, window=window), client_batches, s,
                          fl.local_lr)
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
            with obs.span("train.encode", sync=device):
                rs.append(ops.project_tree_kernel(
                    tree_map(lambda d: d.unsqueeze(0), delta), seeds[i:i + 1],
                    pcfg.distribution, pcfg.num_projections, pcfg.mode))
            losses.append(lsum / s)
            del delta
        rs = torch.cat(rs)

        with obs.span("train.close", sync=device), torch.no_grad():
            new_params = ops.server_update_kernel(
                params, rs, seeds, pcfg.server_lr, pcfg.distribution,
                mode=pcfg.mode, per_client_rounding=True)
        return new_params, _round_metrics(torch.stack(losses), rs, seeds, pcfg)

    return train_step


def _local_sgd(leaves, base, loss_of, client_batches, s: int, lr: float):
    """S local SGD steps on ``leaves`` in place, ``w −= α·g`` in the leaf
    dtype with ``g`` the gradient of ``loss_of(step's batch).sum()`` (the
    client-parallel step's loss is a vector, one per client), then
    δ = ψ_S − x in place (``base``: x's leaves, broadcast over a client
    axis) → Σ of the steps' losses, float32.  Each step counts its batch's
    labels as ``train.tokens``, under the spans ``train.forward``,
    ``train.backward`` and ``train.update`` (``obs.py``)."""
    dev = leaves[0].device
    lsum = None
    for step in range(s):
        b = tree_map(lambda x: x[step], client_batches)
        obs.count("train.tokens", b["labels"].numel())
        with obs.span("train.forward", sync=dev):
            loss = loss_of(b)
        with obs.span("train.backward", sync=dev):
            grads = torch.autograd.grad(loss.sum(), leaves)
        with obs.span("train.update", sync=dev), torch.no_grad():
            for w, g in zip(leaves, grads):
                w.sub_(lr * g.to(w.dtype))
        del grads
        loss = loss.detach().to(torch.float32)
        lsum = loss if lsum is None else lsum + loss
    with obs.span("train.update", sync=dev), torch.no_grad():
        for w, w0 in zip(leaves, base):
            w.sub_(w0)                               # δ = ψ_S − x, leaf dtype
    return lsum


def _round_metrics(losses, rs, seeds, pcfg) -> dict:
    """The round's metrics from each client's mean loss, (N,)."""
    return {
        "loss": torch.mean(losses),
        "r_rms": torch.sqrt(torch.mean(rs.to(torch.float32) ** 2)),
        "uploaded_scalars": rs.shape[0] * (pcfg.num_projections + 1),
        "r": rs,
        "seeds": seeds,
    }


def _make_mesh_train_step(arch, fl: FLRunConfig, window: Optional[int],
                          mesh: FedMesh, dp_axes: tuple):
    """``make_train_step`` on a mesh: the round on resident shards."""
    pcfg = fl.protocol()
    groups = mesh.entry_groups() if "model" in dp_axes else mesh.data_groups()

    def step_loss(p: ResidentTree, b):
        """The mean over the groups (data rows, or every entry) of each
        group's loss on its share, the groups run in batch order (MoE
        dispatches the whole batch)."""
        d = len(groups)
        per = tree_leaves(b)[0].shape[0]
        if per % d:
            raise ValueError(f"per-step batch {per} does not split over {d} groups")
        moe = BatchDispatch(d) if arch.cfg.num_experts and d > 1 else None
        losses = [arch.loss(p, tree_map(lambda x: x[g * (per // d):(g + 1) * (per // d)]
                                        .to(dev), b), window=window,
                            moe_dispatch=None if moe is None else (moe, g))
                  for g, (dev, _) in enumerate(groups)]
        if d == 1:
            return losses[0]
        return torch.stack([l.to(groups[0][0]) for l in losses]).mean()

    def client_update(params: ResidentTree, client_batches, s: int):
        """S local SGD steps from ``params`` → (δ in place of the copy, Σ loss).
        A shard of padding alone is zero in x and in ψ (no gather reads
        it), so it takes no step and its δ is zero as it stands."""
        p = params.clone(requires_grad=True)
        lsum = _local_sgd(p.data_shards(), params.data_shards(),
                          lambda b: step_loss(p, b), client_batches, s, fl.local_lr)
        return _detached(p), lsum

    def train_step(params: ResidentTree, batch: Any, round_idx):
        _check_resident(params, mesh)
        n, s = fl.num_virtual_clients, fl.local_steps
        sb = _split_batch(batch, n, s)
        seeds = round_seeds(int(round_idx), n, device=groups[0][0])
        rs, losses = [], []
        for i in range(n):
            delta, lsum = client_update(params, tree_map(lambda x: x[i], sb), s)
            rs.append(fed_rules.sharded_project_tree(
                mesh, delta, seeds[i], pcfg.distribution, pcfg.num_projections,
                pcfg.mode)[None])
            losses.append(lsum / s)
            del delta
        rs = torch.cat(rs)
        return (_mesh_close(mesh, params, rs, seeds, pcfg),
                _round_metrics(torch.stack(losses), rs, seeds, pcfg))

    return train_step


def _check_resident(params, mesh: FedMesh) -> None:
    if not isinstance(params, ResidentTree) or params.mesh != mesh:
        raise TypeError(f"the mesh step takes a ResidentTree on its mesh "
                        f"{mesh.shape} (sharding.resident.shard_resident)")


def _mesh_close(mesh: FedMesh, params: ResidentTree, rs, seeds, pcfg) -> ResidentTree:
    """The per-client-rounding close on x's shards, where they lie."""
    with torch.no_grad():
        shards = fed_rules.sharded_apply_blocks(
            mesh, params.plan, params.shards, rs, seeds, pcfg.server_lr,
            pcfg.distribution, mode=pcfg.mode, per_client_rounding=True)
    new_params = ResidentTree(mesh, params.plan, params.like, shards)
    new_params.clear_padding()
    return new_params


def _detached(tree: ResidentTree) -> ResidentTree:
    return ResidentTree(tree.mesh, tree.plan, tree.like,
                        [[w.detach() for w in sh] for sh in tree.shards])


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
                                    window: Optional[int] = None,
                                    mesh: Optional[FedMesh] = None):
    """→ ``train_step(params, batch, round_idx) -> (new_params, metrics)``,
    the client-parallel placement; the same contract and metrics as
    :func:`make_train_step`.  The replicas' local steps run with
    ``batch_mode("off")``, as the reference's (the client axis owns the
    data axis).

    With ``mesh`` the clients live on its data rows, as the reference's
    placement on its pod mesh: N/D clients a row (N a multiple of the D
    rows), each client's replica in the row's ``tp`` placement
    (``sharding/resident.py::place_rows``: resident over the row's M
    entries), x the ``zero3`` :class:`ResidentTree` that
    :func:`make_train_step`'s mesh step takes and returns.  A row's
    replicas run under the one-device step's vmap, each period's slices
    gathered from each replica's shards and stacked inside the period's
    checkpoint (``ReplicaStack``), the gradients flowing back to each
    replica's shards; each δ is encoded on the row's shards where it lies
    (``fed_rules.sharded_project_tree``), and the close is the mesh step's
    on x's shards.

    ``param_spec_tp``, where given, is the reference's ``tp`` layout of the
    replicas (``sharding/rules.py::param_specs(layout="tp")``): checked to
    name no ``data`` or ``pod`` axis and only the mesh's axes, and to hold
    one spec a parameter leaf; a mismatch raises.  Without a mesh the step
    is the one-device step.
    """
    if param_spec_tp is not None:
        _check_tp_specs(param_spec_tp, mesh)
    if mesh is not None:
        return _make_mesh_client_parallel_step(arch, fl, param_spec_tp, window, mesh)
    pcfg = fl.protocol()

    def train_step(params: Any, batch: Any, round_idx):
        if param_spec_tp is not None:
            _check_spec_count(param_spec_tp, len(tree_leaves(params)))
        n, s = fl.num_virtual_clients, fl.local_steps
        sb = _split_batch(batch, n, s)
        device = tree_leaves(params)[0].device
        seeds = round_seeds(int(round_idx), n, device=device)
        with batch_mode("off"):
            p = tree_map(lambda w: w.detach()[None].expand(
                (n,) + tuple(w.shape)).clone().requires_grad_(True), params)
            lsum = _local_sgd(tree_leaves(p), tree_leaves(params),
                              lambda b: arch.loss(p, b, window=window, clients=True),
                              tree_map(lambda x: x.transpose(0, 1), sb), s,
                              fl.local_lr)
            deltas = tree_map(lambda w: w.detach(), p)
            del p
            rs = ops.project_tree_kernel(deltas, seeds, pcfg.distribution,
                                         pcfg.num_projections, pcfg.mode)
            del deltas
        with torch.no_grad():
            new_params = ops.server_update_kernel(
                params, rs, seeds, pcfg.server_lr, pcfg.distribution,
                mode=pcfg.mode, per_client_rounding=True)
        return new_params, _round_metrics(lsum / s, rs, seeds, pcfg)

    return train_step


def _check_tp_specs(specs, mesh: Optional[FedMesh]) -> None:
    """The reference's ``tp`` layout: no spec names ``data`` or ``pod`` (the
    replicas are whole over the rows), and every axis named is the
    mesh's."""
    axes = set(mesh.axis_names) if mesh is not None else set(DP_AXES)
    for path, spec in _spec_paths(specs):
        for entry in spec:
            names = () if entry is None else (entry,) if isinstance(entry, str) else entry
            if "data" in names or "pod" in names or not set(names) <= axes:
                raise ValueError(f"param_spec_tp at {path_str(path)} is {spec}: the "
                                 f"tp layout shards over 'model' alone, on a mesh "
                                 f"of axes {sorted(axes)}")


def _check_spec_count(specs, leaves: int) -> None:
    if len(_spec_paths(specs)) != leaves:
        raise ValueError(f"param_spec_tp holds {len(_spec_paths(specs))} specs "
                         f"for {leaves} parameter leaves")


def _make_mesh_client_parallel_step(arch, fl: FLRunConfig, param_spec_tp,
                                    window: Optional[int], mesh: FedMesh):
    """``make_train_step_client_parallel`` on a mesh: N/D clients on each
    data row, each replica resident over the row's entries."""
    pcfg = fl.protocol()
    rows = mesh.data_groups()
    d = len(rows)

    def train_step(params: ResidentTree, batch: Any, round_idx):
        _check_resident(params, mesh)
        if param_spec_tp is not None:
            _check_spec_count(param_spec_tp, len(params.shards))
        n, s = fl.num_virtual_clients, fl.local_steps
        if n % d:
            raise ValueError(f"{n} clients do not split over {d} data rows")
        per_row = n // d
        sb = _split_batch(batch, n, s)
        seeds = round_seeds(int(round_idx), n, device=rows[0][0])
        base = place_rows(params, mesh)              # x in each row's tp placement
        rs, losses = [], []
        with batch_mode("off"):
            for r, (dev, _) in enumerate(rows):
                x_row = base.rows[r]
                reps = [x_row.clone(requires_grad=True) for _ in range(per_row)]
                stack = ReplicaStack(reps)
                lo = r * per_row
                lsum = _local_sgd(
                    [w for rep in reps for w in rep.data_shards()],
                    [w for _ in reps for w in x_row.data_shards()],
                    lambda b: arch.loss(stack, b, window=window, clients=True),
                    tree_map(lambda x: x[lo:lo + per_row].transpose(0, 1).to(dev), sb),
                    s, fl.local_lr)
                del stack
                for c, rep in enumerate(reps):
                    rs.append(fed_rules.sharded_project_tree(
                        rep.mesh, _detached(rep), seeds[lo + c], pcfg.distribution,
                        pcfg.num_projections, pcfg.mode).to(rows[0][0])[None])
                losses.append(lsum.to(rows[0][0]) / s)
                del reps
        del base
        rs = torch.cat(rs)
        return (_mesh_close(mesh, params, rs, seeds, pcfg),
                _round_metrics(torch.cat(losses), rs, seeds, pcfg))

    return train_step
