"""Mesh-sharded federation server (port of ``repro/sharding/fed_rules.py``).

The server's reconstruction  x ← x + lr·Σₙⱼ coeffₙ·rₙⱼ·vⱼ(ξₙ)  is
elementwise in the model dimension d: the direction chain is
counter-based (``(seed ⊕ leaf_tag, row, col)``), so each shard of a
(``data``, ``model``) mesh regenerates exactly its slice of every vₙ from
the same 32-bit seeds, and the decode moves no bytes between devices.

* The **shard plan**: each leaf's 2-D view is split into equal
  contiguous slices along its larger axis (rows preferred), padded so
  every shard has the same local shape; a local element's global
  (row, col) is ``local + shard_ordinal · per_shard`` on the sharded axis.
* The **paths**: :func:`sharded_apply_blocks` (the decode on sharded
  views), :func:`sharded_server_update` (the same on a replicated tree)
  and :func:`sharded_project_tree` (the encode: the shards' partial
  block scalars, then one sum of the k scalars).  The decode and the
  encode also take a tree already resident in its shards
  (``sharding/resident.py``: the mesh train step's parameters and
  updates), and the decode the train close's per-client rounding.  Each
  runs one tree launch per device (one per 64 (shard, leaf) entries) over
  a shard plan (``kernels/tree.py::shard_plan``): the per-client decode
  (``csrc/seeded_reconstruct.cu``), the fused close
  (``csrc/reconstruct_apply.cu``) or the encode
  (``csrc/seeded_projection.cu``) on CUDA tensors, their plain tree
  versions on the CPU or with ``use_kernel=False``.

Reconstruction reassociates nothing, so any shard layout gives the
unsharded decode's bits, and the fused close the unsharded close's; only
the encode's sums run in another order.

Sharded views are, per leaf, a list of the shards' local 2-D tensors,
each on its shard's device (:meth:`FedMesh.shard_device`); uploads are
float32 ``(N, k)`` with ``(N,)`` round seeds as int64 words, copied to
every device; accumulation is float32.  Outputs are fresh tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.prng import Distribution, u32
from repro_torch.core.projection import LeafLayout, ProjectionMode, leaf_layout
from repro_torch.core.tree import tree_leaves, tree_unflatten
from repro_torch.kernels.common import LEAF_DTYPES, gen_tile
from repro_torch.kernels.ops import fold_upload_weights
from repro_torch.kernels.reconstruct_apply import fused_tree, fused_tree_plain
from repro_torch.kernels.seeded_projection import project_tree, project_tree_plain
from repro_torch.kernels.seeded_reconstruct import (
    reconstruct_plain,
    reconstruct_tree,
    reconstruct_tree_plain,
)
from repro_torch.kernels.tree import shard_plan
from repro_torch.launch.mesh import FedMesh

__all__ = [
    "FedShardPlan",
    "LeafShard",
    "plan_tree",
    "num_mesh_shards",
    "shard_ordinal",
    "fed_param_specs",
    "upload_spec",
    "to_sharded_2d",
    "from_sharded_2d",
    "local_project_2d",
    "local_reconstruct_2d",
    "shard_tree",
    "sharded_apply_blocks",
    "sharded_project_tree",
    "sharded_server_update",
]


# ---------------------------------------------------------------------------
# Shard plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LeafShard:
    """How one leaf's 2-D view is split across the mesh.

    ``axis`` is the sharded dimension of the view (0 = rows, 1 = cols);
    ``per_shard`` is the local extent along it; the view is padded to
    ``num_shards · per_shard`` so every shard has the same local shape
    (the padding is zero and is sliced away on unshard).
    """

    layout: LeafLayout
    axis: int
    per_shard: int


@dataclasses.dataclass(frozen=True)
class FedShardPlan:
    """Shard assignments for every leaf of a parameter tree."""

    num_shards: int
    total: int                      # global flat dimension d
    leaves: tuple[LeafShard, ...]

    def per_shard_elements(self) -> int:
        """Local elements per shard (the sharded path's working set)."""
        out = 0
        for ls in self.leaves:
            rows, cols = ls.layout.rows, ls.layout.cols
            out += ls.per_shard * (cols if ls.axis == 0 else rows)
        return out

    def balance(self) -> float:
        """per-shard work ÷ ideal d/S — 1.0 is a perfectly even split."""
        ideal = self.total / max(self.num_shards, 1)
        return self.per_shard_elements() / max(ideal, 1.0)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def plan_tree(params: Any, num_shards: int) -> FedShardPlan:
    """→ :class:`FedShardPlan` splitting each leaf's larger view axis.

    Rows are preferred; a leaf whose view has fewer rows than shards and
    fewer rows than cols (1-D leaves seen as ``(1, n)``) shards its cols,
    so flat parameter vectors still spread across the mesh.
    """
    shards = []
    for ll in leaf_layout(params):
        if ll.rows >= num_shards or ll.rows >= ll.cols:
            axis, per = 0, _ceil_div(ll.rows, num_shards)
        else:
            axis, per = 1, _ceil_div(ll.cols, num_shards)
        shards.append(LeafShard(layout=ll, axis=axis, per_shard=per))
    total = shards[-1].layout.end if shards else 0
    return FedShardPlan(num_shards=num_shards, total=total, leaves=tuple(shards))


def num_mesh_shards(mesh: FedMesh) -> int:
    return mesh.size


def shard_ordinal(mesh: FedMesh, index) -> int:
    """Flat shard index of the mesh coordinate ``index`` (one index per
    axis, row-major over the axes), so ``ordinal · per_shard`` is the
    global offset of that shard's slice."""
    s = 0
    for i, size in zip(index, mesh.shape):
        if not 0 <= int(i) < size:
            raise ValueError(f"mesh index {tuple(index)} outside {mesh.shape}")
        s = s * size + int(i)
    return s


def fed_param_specs(plan: FedShardPlan, mesh: FedMesh) -> tuple:
    """Per leaf, the sharded view's axes: ``(mesh axes, None)`` for a
    row-sharded view, ``(None, mesh axes)`` for a col-sharded one."""
    axes = tuple(mesh.axis_names)
    return tuple((axes, None) if ls.axis == 0 else (None, axes)
                 for ls in plan.leaves)


def upload_spec() -> tuple:
    """The ``(N, k)`` scalars and ``(N,)`` seeds: replicated, no sharded axis."""
    return ()


def _padded_view(leaf: torch.Tensor, ls: LeafShard, num_shards: int) -> torch.Tensor:
    ll = ls.layout
    x = leaf.reshape(ll.rows, ll.cols)
    pr = ls.per_shard * num_shards - ll.rows if ls.axis == 0 else 0
    pc = ls.per_shard * num_shards - ll.cols if ls.axis == 1 else 0
    return torch.nn.functional.pad(x, (0, pc, 0, pr)) if pr or pc else x


def to_sharded_2d(tree: Any, plan: FedShardPlan) -> list[torch.Tensor]:
    """Leaves → padded global 2-D views, ``num_shards · per_shard`` along
    the sharded axis (a leaf that needs no padding comes back as a view
    of the caller's tensor)."""
    return [_padded_view(leaf, ls, plan.num_shards)
            for ls, leaf in zip(plan.leaves, tree_leaves(tree))]


def _split(view, ls: LeafShard, mesh: FedMesh, copy: bool = False) -> list:
    """A padded global view → its shards' local views, each contiguous on
    its shard's device (fresh tensors with ``copy``); a list of local
    views passes through."""
    if not isinstance(view, torch.Tensor):
        if len(view) != mesh.size:
            raise ValueError(f"{len(view)} shards for a mesh of {mesh.size}")
        return list(view)
    per = ls.per_shard
    out = []
    for s in range(mesh.size):
        x = view[s * per:(s + 1) * per] if ls.axis == 0 \
            else view[:, s * per:(s + 1) * per]
        dev = mesh.shard_device(s)
        out.append(torch.empty(x.shape, dtype=x.dtype, device=dev).copy_(x) if copy
                   else x.to(dev).contiguous())
    return out


def from_sharded_2d(arrs, plan: FedShardPlan, like: Any) -> Any:
    """Padded views (global tensors, or per leaf the shards' local views)
    → a tree shaped, typed and placed like ``like``."""
    out = []
    for ls, arr, leaf in zip(plan.leaves, arrs, tree_leaves(like)):
        if not isinstance(arr, torch.Tensor):
            parts = [a.to(leaf.device) for a in arr]
            arr = parts[0] if len(parts) == 1 else torch.cat(parts, dim=ls.axis)
        ll = ls.layout
        out.append(arr[:ll.rows, :ll.cols].reshape(ll.shape).to(leaf.device,
                                                              leaf.dtype))
    return tree_unflatten(like, out)


def shard_tree(tree: Any, plan: FedShardPlan, mesh: FedMesh) -> list[list[torch.Tensor]]:
    """Place the padded views' shards on their devices (persistent
    residency): per leaf, the shards' local views, each a fresh contiguous
    tensor; one leaf is padded at a time.

    Pair with :func:`sharded_apply_blocks` to keep the global model
    sharded across rounds, so the per-round apply moves no parameter
    bytes.  (The federation engine keeps params replicated instead: its
    client compute and eval read the full model each round.)
    """
    return [_split(_padded_view(leaf, ls, plan.num_shards), ls, mesh, copy=True)
            for ls, leaf in zip(plan.leaves, tree_leaves(tree))]


# ---------------------------------------------------------------------------
# Local (per-shard) bodies: one shard's slice of one leaf
# ---------------------------------------------------------------------------


def local_project_2d(x_local: torch.Tensor, seeds_folded: torch.Tensor,
                     row_offset: int, col_offset: int, distribution: str,
                     lo: torch.Tensor, hi: torch.Tensor, orig_cols: int,
                     masked: bool) -> torch.Tensor:
    """→ (k,) partial block scalars of this shard's slice (caller sums).

    ``seeds_folded`` are the k per-block seeds with the leaf tag folded
    in.  The encode kernel's arithmetic on one slice: v regenerated at
    global (row, col), multiplied, summed in float32.
    """
    rows, cols = x_local.shape
    dev = x_local.device
    row = ((torch.arange(rows, dtype=torch.int64, device=dev) + row_offset)
           & 0xFFFFFFFF)[:, None]
    col = ((torch.arange(cols, dtype=torch.int64, device=dev) + col_offset)
           & 0xFFFFFFFF)[None, :]
    xf = x_local.to(torch.float32)
    if masked:
        flat = row.to(torch.float32) * float(orig_cols) + col.to(torch.float32)
    outs = []
    for b in range(seeds_folded.shape[0]):
        v = gen_tile(u32(seeds_folded[b], dev), row, col, distribution)
        if masked:
            v = v * ((flat >= lo[b]) & (flat < hi[b])).to(torch.float32)
        outs.append((xf * v).sum())
    return torch.stack(outs)


def local_reconstruct_2d(x_local: torch.Tensor, seeds: torch.Tensor,
                         rs: torch.Tensor, scale: float, leaf_tag: int,
                         row_offset: int, col_offset: int, distribution: str,
                         lo: torch.Tensor | None, hi: torch.Tensor | None,
                         orig_cols: int, masked: bool) -> torch.Tensor:
    """→ the updated local slice  x + scale·Σₙⱼ rₙⱼ vₙⱼ  (shape and dtype of
    ``x_local``), from ``(N,)`` unfolded round seeds and ``(N, k)`` scalars
    with every weight folded in.

    The per-client decode's plain version on one slice: blocks outer,
    clients inner, one float32 accumulator, the scale applied last, v at
    global (row, col), so every shard layout gives each element the bits
    of the unsharded decode.
    """
    return reconstruct_plain(x_local, u32(seeds, x_local.device), rs, leaf_tag,
                             scale, lo, hi, distribution, masked, row_offset,
                             col_offset, orig_cols)


# ---------------------------------------------------------------------------
# The paths: one shard-plan tree launch per device
# ---------------------------------------------------------------------------


def _dist_name(distribution) -> str:
    return distribution.value if isinstance(distribution, Distribution) \
        else str(distribution)


def _device_entries(mesh: FedMesh, plan: FedShardPlan, local, kind: str, k: int,
                    mode: ProjectionMode):
    """→ per device ``(device, ordinals, its (shard, leaf) entries in shard-major
    order, their shard plan)``."""
    shapes = [ls.layout.shape for ls in plan.leaves]
    dtypes = [shards[0].dtype for shards in local]
    split = [(ls.axis, ls.per_shard) for ls in plan.leaves]
    for dev, ordinals in mesh.device_groups():
        entries = [shards[s] for s in ordinals for shards in local]
        yield dev, ordinals, entries, shard_plan(kind, shapes, dtypes, plan.num_shards,
                                                 split, ordinals, k, mode, dev)


def sharded_apply_blocks(
    mesh: FedMesh,
    plan: FedShardPlan,
    blocks,                        # padded 2-D views (to_sharded_2d/shard_tree)
    rs: torch.Tensor,              # (N,), (N, 1) or (N, k) uploaded scalars
    seeds: torch.Tensor,           # (N,) round seeds
    server_lr: float = 1.0,
    distribution: Distribution = Distribution.RADEMACHER,
    weights: torch.Tensor | None = None,
    mode: ProjectionMode = ProjectionMode.FULL,
    block_weights: torch.Tensor | None = None,
    use_kernel: bool | None = None,
    use_fused: bool = False,
    per_client_rounding: bool = False,
) -> list[list[torch.Tensor]]:
    """The decode on sharded views → per leaf, the shards' updated local
    views (fresh tensors, each on its shard's device).

    ``blocks`` are, per leaf, a padded global view (:func:`to_sharded_2d`)
    or the shards' local views (:func:`shard_tree`); feeding the outputs
    back in keeps the model resident on its devices across rounds.  Each
    device's shards take one tree launch of the per-client decode (one
    per 64 entries), or of the fused close with ``use_fused``.
    ``use_kernel`` None takes the kernel on a card and the plain tree
    version elsewhere; False takes the plain version on any device.
    ``per_client_rounding`` takes the train step's close (the per-client
    decode's ``ROUND_ONE`` mode, as ``ops.server_update_kernel``'s): each
    client's reconstruction rounded to the leaf dtype, then x + lr·(Σ/N)
    (Σ alone with ``weights``).
    """
    rs, scale = fold_upload_weights(rs, server_lr, weights, mode, block_weights)
    div = 1.0
    if per_client_rounding:
        if use_fused:
            raise ValueError("the fused close has no per-client rounding")
        scale, div = server_lr, (float(rs.shape[0]) if weights is None else 1.0)
    rs = rs.contiguous()
    k = rs.shape[1]
    dist = _dist_name(distribution)
    seeds = u32(seeds)
    local = [_split(b, ls, mesh) for ls, b in zip(plan.leaves, blocks)]
    out = [[None] * mesh.size for _ in local]
    for dev, ordinals, entries, tplan in _device_entries(
            mesh, plan, local, "close" if use_fused else "decode", k, mode):
        kernel = dev.type == "cuda" if use_kernel is None else use_kernel
        sd, rd = seeds.to(dev), rs.to(dev)
        if use_fused:
            fn = fused_tree if kernel else fused_tree_plain
            ys = fn(entries, sd, rd, scale, tplan, dist)
        else:
            fn = reconstruct_tree if kernel else reconstruct_tree_plain
            ys = fn(entries, sd, rd, scale, div, tplan, dist, per_client_rounding)
        for j, y in enumerate(ys):
            s, i = divmod(j, len(local))
            out[i][ordinals[s]] = y
    return out


def sharded_server_update(
    mesh: FedMesh,
    params: Any,
    rs: torch.Tensor,              # (N,), (N, 1) or (N, k) uploaded scalars
    seeds: torch.Tensor,           # (N,) round seeds
    server_lr: float = 1.0,
    distribution: Distribution = Distribution.RADEMACHER,
    weights: torch.Tensor | None = None,
    mode: ProjectionMode = ProjectionMode.FULL,
    block_weights: torch.Tensor | None = None,
    use_kernel: bool | None = None,
    plan: FedShardPlan | None = None,
    use_fused: bool = False,
) -> Any:
    """Mesh-sharded Algorithm 1 lines 7–13: each shard decodes its slice.

    ≡ :func:`repro_torch.kernels.ops.server_update_kernel` bit for bit
    (≡ ``server_update_fused`` with ``use_fused``): every shard regenerates
    its own slice of the direction chain from the replicated ``(r, ξ)``
    buffers and applies the update locally.  Takes and returns a
    replicated tree (the engine's client and eval stages read the full
    model); a server holding the model sharded across rounds calls
    :func:`sharded_apply_blocks` and skips the shard/unshard round trip.
    """
    if plan is None:
        plan = plan_tree(params, num_mesh_shards(mesh))
    outs = sharded_apply_blocks(
        mesh, plan, to_sharded_2d(params, plan), rs, seeds,
        server_lr=server_lr, distribution=distribution, weights=weights,
        mode=mode, block_weights=block_weights, use_kernel=use_kernel,
        use_fused=use_fused)
    return from_sharded_2d(outs, plan, params)


def sharded_project_tree(
    mesh: FedMesh,
    delta: Any,
    seed,
    distribution: Distribution = Distribution.RADEMACHER,
    num_blocks: int = 1,
    mode: ProjectionMode = ProjectionMode.FULL,
    use_kernel: bool | None = None,
    plan: FedShardPlan | None = None,
) -> torch.Tensor:
    """Mesh-sharded FedScalar encode → float32 ``(num_blocks,)``.

    ≡ :func:`repro_torch.kernels.ops.project_tree_kernel` up to float32
    reassociation: each device encodes its shards' slices in one tree
    launch (and its reduction), then the devices' k partial scalars are
    summed on the first device in shard order.  ``delta`` is a tree, split
    here, or a resident tree (``sharding/resident.py``), whose shards are
    encoded where they lie (its padding must be zero).
    """
    resident = getattr(delta, "shards", None)
    if resident is not None:
        plan = delta.plan
        local = [[x.detach()[None] if x.dtype in LEAF_DTYPES
                  else x.detach().to(torch.float32)[None] for x in sh]
                 for sh in resident]
    else:
        if plan is None:
            plan = plan_tree(delta, num_mesh_shards(mesh))
        views = [x if x.dtype in LEAF_DTYPES else x.to(torch.float32)
                 for x in to_sharded_2d(delta, plan)]
        local = [[x[None] for x in _split(v, ls, mesh)]
                 for ls, v in zip(plan.leaves, views)]
    dist = _dist_name(distribution)
    seeds = u32(seed).reshape(1)
    total = None
    for dev, _, entries, tplan in _device_entries(mesh, plan, local, "encode",
                                                  num_blocks, mode):
        kernel = dev.type == "cuda" if use_kernel is None else use_kernel
        fn = project_tree if kernel else project_tree_plain
        r = fn(entries, seeds.to(dev), tplan, dist)[0]
        total = r if total is None else total + r.to(total.device)
    return total
