"""Parameters resident in shards over a mesh: the port's counterpart of the
reference's ``named`` + ``jax.device_put`` (``repro/sharding/rules.py``)
and of its restore into shardings (``repro/checkpoint/msgpack_ckpt.py``).

A :class:`ResidentTree` keeps a parameter tree in the federation server's
shard layout (``fed_rules.plan_tree``): each leaf's 2-D view is cut into
``mesh.size`` contiguous, equal slices along its larger axis, the last
ones padded with zeros, and shard ``s``'s slice lives on
``mesh.shard_device(s)``.  One layout serves the three stages of the mesh
train step (``launch/train.py::make_train_step(..., mesh=)``):

* local SGD gathers each period's (or layer's) weights onto a data
  group's device inside the period's checkpoint (:meth:`compute_tree`,
  :class:`StackedLeaf`, ``models/lm.py::remat_call``; the models name
  their stacked subtrees), so the backward
  pass gathers them again instead of keeping them, and autograd sums each
  shard's gradient on the shard's own device;
* the encode and the close run on the shards where they lie
  (``fed_rules.sharded_project_tree``, ``fed_rules.sharded_apply_blocks``)
  over the shard plans of ``kernels/tree.py``: the close moves no d-sized
  bytes between devices.

The padding is zero and stays zero: no gather reads it, the gradient
there is zero, and the close's writes into it are cleared
(:meth:`ResidentTree.clear_padding`).  A tree is placed one leaf at a
time (:func:`shard_resident`, :meth:`ResidentTree.write`), so the whole
tree never sits on one device.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.launch.mesh import FedMesh
from repro_torch.sharding.fed_rules import FedShardPlan, plan_tree, shard_tree

__all__ = ["ResidentTree", "StackedLeaf", "ShardSlice", "RowTrees", "ReplicaStack",
           "shard_resident", "place_rows"]


class ShardSlice:
    """One period's slice of a stacked leaf, not yet gathered: ``inputs``
    are views of the shards that hold it (a checkpoint's inputs), and
    ``build(inputs)`` gathers them into the slice."""

    def __init__(self, inputs: list, build: Callable):
        self.inputs = inputs
        self.build = build


class StackedLeaf:
    """A stacked leaf of a resident tree inside a forward on ``device``:
    :meth:`slice` hands out each period's :class:`ShardSlice`.  With
    ``clients`` it is the same leaf of N replicas (``trees``, one plan),
    and a slice gathers each replica's and stacks them on a leading client
    axis (the client-parallel forward, ``models/lm.py::stack_slice(...,
    clients=True)``)."""

    def __init__(self, trees: list, leaf: int, device: torch.device,
                 clients: bool = False):
        self.trees, self.leaf, self.device, self.clients = list(trees), leaf, device, clients

    @property
    def shape(self) -> tuple:
        lead = (len(self.trees),) if self.clients else ()
        return lead + tuple(self.trees[0].plan.leaves[self.leaf].layout.shape)

    def slice(self, index: int) -> ShardSlice:
        leaf, dev = self.leaf, self.device
        pieces = [t.pieces(leaf, index) for t in self.trees]

        def build(parts):
            out, at = [], 0
            for tree, p in zip(self.trees, pieces):
                out.append(tree.assemble(leaf, parts[at:at + len(p)], dev, index))
                at += len(p)
            return torch.stack(out) if self.clients else out[0]

        return ShardSlice([x for p in pieces for x in p], build)


class ResidentTree:
    """A parameter tree held as shards across ``mesh``.

    ``plan`` is the shard plan, ``like`` the tree's structure with each
    leaf as a ``meta`` tensor of its shape and dtype, and ``shards`` per
    leaf (sorted-key order) the shards' local 2-D views, each on its
    shard's device."""

    def __init__(self, mesh: FedMesh, plan: FedShardPlan, like: Any,
                 shards: list[list[torch.Tensor]]):
        self.mesh, self.plan, self.like, self.shards = mesh, plan, like, shards
        if len(shards) != len(plan.leaves):
            raise ValueError(f"{len(shards)} leaves of shards for a plan of "
                             f"{len(plan.leaves)}")

    # ---- placing ----

    @classmethod
    def empty(cls, like: Any, mesh: FedMesh) -> "ResidentTree":
        """Zero shards for a tree shaped and typed like ``like`` (tensors of
        any device, ``meta`` included)."""
        meta = _meta(like)
        plan = plan_tree(meta, mesh.size)
        shards = []
        for ls, w in zip(plan.leaves, tree_leaves(meta)):
            ll = ls.layout
            local = (ls.per_shard, ll.cols) if ls.axis == 0 else (ll.rows, ls.per_shard)
            shards.append([torch.zeros(local, dtype=w.dtype, device=mesh.shard_device(s))
                           for s in range(mesh.size)])
        return cls(mesh, plan, meta, shards)

    def _region(self, leaf: int, index: int | None):
        """→ (rows, cols, shape): the view's rows and cols that leaf
        ``leaf`` (or slice ``index`` of its leading axis) covers."""
        ll = self.plan.leaves[leaf].layout
        if index is None:
            return (0, ll.rows), (0, ll.cols), ll.shape
        n = ll.shape[0] if ll.shape else 0
        if not 0 <= index < n:
            raise IndexError(f"slice {index} of a leaf of shape {ll.shape}")
        if len(ll.shape) == 1:                  # the view is (1, n)
            return (0, 1), (index, index + 1), ()
        per = ll.rows // n
        return (index * per, (index + 1) * per), (0, ll.cols), ll.shape[1:]

    def _spans(self, leaf: int, index: int | None):
        """→ per shard holding any of the region: (shard, the region's rows
        or cols in that shard's local view, the same in the region)."""
        ls = self.plan.leaves[leaf]
        rows, cols, _ = self._region(leaf, index)
        lo, hi = rows if ls.axis == 0 else cols
        per = ls.per_shard
        for s in range(lo // per, -(-hi // per)):
            a, b = max(lo, s * per), min(hi, (s + 1) * per)
            yield s, slice(a - s * per, b - s * per), slice(a - lo, b - lo)

    def write(self, leaf: int, value: torch.Tensor, index: int | None = None) -> None:
        """Copy ``value`` (any device) into leaf ``leaf``'s shards, or into
        slice ``index`` of its leading axis."""
        ls = self.plan.leaves[leaf]
        rows, cols, shape = self._region(leaf, index)
        if tuple(value.shape) != tuple(shape):
            raise ValueError(f"leaf {leaf}: a value of shape {tuple(value.shape)} "
                             f"for {tuple(shape)}")
        v = value.reshape(rows[1] - rows[0], cols[1] - cols[0])
        with torch.no_grad():
            for s, local, part in self._spans(leaf, index):
                x = self.shards[leaf][s]
                if ls.axis == 0:
                    x[local, cols[0]:cols[1]].copy_(v[part])
                else:
                    x[rows[0]:rows[1], local].copy_(v[:, part])

    def leaf_start(self, path: tuple) -> int:
        """The ordinal of the first leaf under ``path`` (dict keys and list
        indices from the root)."""
        node, start = self.like, 0
        for key in path:
            for k in (sorted(node) if isinstance(node, dict) else range(len(node))):
                if k == key:
                    break
                start += len(tree_leaves(node[k]))
            node = node[key]
        return start

    def write_tree(self, path: tuple, sub: Any, index: int | None = None) -> None:
        """:meth:`write` each leaf of ``sub``, the subtree at ``path`` (or
        slice ``index`` of each of its stacked leaves)."""
        start = self.leaf_start(path)
        for j, leaf in enumerate(tree_leaves(sub)):
            self.write(start + j, leaf, index)

    # ---- gathering ----

    def pieces(self, leaf: int, index: int | None = None) -> list[torch.Tensor]:
        """Views of exactly the shards' parts that hold leaf ``leaf`` (or its
        slice ``index``), in shard order; no padding."""
        ls = self.plan.leaves[leaf]
        rows, cols, _ = self._region(leaf, index)
        out = []
        for s, local, _ in self._spans(leaf, index):
            x = self.shards[leaf][s]
            out.append(x[local, cols[0]:cols[1]] if ls.axis == 0
                       else x[rows[0]:rows[1], local])
        return out

    def assemble(self, leaf: int, parts: list[torch.Tensor], device,
                 index: int | None = None) -> torch.Tensor:
        """:meth:`pieces`' parts → the leaf (or its slice ``index``),
        contiguous on ``device``; differentiable."""
        _, _, shape = self._region(leaf, index)
        parts = [p.to(device) for p in parts]
        x = parts[0] if len(parts) == 1 else torch.cat(parts,
                                                       dim=self.plan.leaves[leaf].axis)
        return x.reshape(shape).contiguous()

    def gather(self, leaf: int, device, index: int | None = None) -> torch.Tensor:
        """Leaf ``leaf``, or slice ``index`` of its leading axis (one period's
        rows of the view), rebuilt on ``device`` from the shards that hold
        it."""
        return self.assemble(leaf, self.pieces(leaf, index), device, index)

    def unshard(self, device) -> Any:
        """The whole tree on ``device`` (fresh tensors, no autograd history)."""
        with torch.no_grad():
            leaves = [self.gather(j, device).clone() for j in range(len(self.shards))]
        return tree_unflatten(self.like, leaves)

    def compute_tree(self, device, stacked_keys: tuple) -> Any:
        """The tree a forward on ``device`` reads: each leaf outside the
        top-level subtrees ``stacked_keys`` (the model's stacks of periods
        or layers) gathered once, each leaf inside them a
        :class:`StackedLeaf` whose periods are gathered inside their
        checkpoints."""
        device = torch.device(device)
        leaves = [StackedLeaf([self], j, device) if stacked else self.gather(j, device)
                  for j, stacked in enumerate(self.stacked_leaves(stacked_keys))]
        return tree_unflatten(self.like, leaves)

    def group_trees(self) -> list[tuple[torch.device, "ResidentTree"]]:
        """→ ``(compute device, this tree)`` per data row of the mesh: a
        serve of the reference's ``zero3`` layout, each row's slice of the
        batch gathering from every shard (``models/api.py``)."""
        return [(dev, self) for dev, _ in self.mesh.data_groups()]

    def stacked_leaves(self, stacked_keys: tuple) -> list[bool]:
        """Per leaf: does it lie under one of the top-level keys
        ``stacked_keys``?"""
        if not isinstance(self.like, dict):
            return [False] * len(self.shards)
        return [key in stacked_keys for key in sorted(self.like)
                for _ in tree_leaves(self.like[key])]

    # ---- in place, shard by shard ----

    def clone(self, requires_grad: bool = False) -> "ResidentTree":
        """A shard-by-shard copy (each shard a leaf of autograd with
        ``requires_grad``)."""
        return ResidentTree(self.mesh, self.plan, self.like,
                            [[x.detach().clone().requires_grad_(requires_grad)
                              for x in sh] for sh in self.shards])

    def flat_shards(self) -> list[torch.Tensor]:
        """Every shard tensor, leaf-major."""
        return [x for sh in self.shards for x in sh]

    def _valid(self, leaf: int, s: int) -> int:
        """The rows (axis 0) or cols of shard ``s`` of leaf ``leaf`` that
        lie inside the leaf's view; the rest is padding."""
        ls = self.plan.leaves[leaf]
        extent = ls.layout.rows if ls.axis == 0 else ls.layout.cols
        return min(max(extent - s * ls.per_shard, 0), ls.per_shard)

    def data_shards(self) -> list[torch.Tensor]:
        """:meth:`flat_shards` less the shards of padding alone (which no
        gather reads)."""
        return [x for j, sh in enumerate(self.shards) for s, x in enumerate(sh)
                if self._valid(j, s)]

    def clear_padding(self) -> None:
        """Zero every shard's elements past its leaf's view."""
        with torch.no_grad():
            for j, (ls, sh) in enumerate(zip(self.plan.leaves, self.shards)):
                for s, x in enumerate(sh):
                    valid = self._valid(j, s)
                    if valid < ls.per_shard:
                        (x[valid:] if ls.axis == 0 else x[:, valid:]).zero_()

    def resident_bytes(self) -> list[int]:
        """Bytes held by each mesh entry that holds a shard
        (``mesh.device_groups()``' order), padding included."""
        return [sum(sh[s].numel() * sh[s].element_size()
                    for s in ordinals for sh in self.shards)
                for _, ordinals in self.mesh.device_groups()]


def _meta(like: Any) -> Any:
    return tree_map(lambda w: torch.empty(tuple(w.shape), dtype=w.dtype,
                                          device="meta"), like)


def shard_resident(tree: Any, mesh: FedMesh) -> ResidentTree:
    """Place ``tree`` (any device) in shards over ``mesh``, one leaf at a
    time (``fed_rules.shard_tree``)."""
    tree = tree_map(lambda w: w.detach(), tree)
    plan = plan_tree(tree, mesh.size)
    return ResidentTree(mesh, plan, _meta(tree), shard_tree(tree, plan, mesh))


class RowTrees:
    """The reference's ``tp`` layout (``param_specs(layout="tp")``: weights
    over ``model`` only, replicated over ``data``) on ``mesh``: one
    :class:`ResidentTree` a data row, over that row's M entries
    (``FedMesh.row_mesh``), so a row's forward gathers from its own row
    alone.  Built by :func:`place_rows`."""

    def __init__(self, mesh: FedMesh, rows: list[ResidentTree]):
        if len(rows) != len(mesh.data_groups()):
            raise ValueError(f"{len(rows)} row trees for a mesh of "
                             f"{len(mesh.data_groups())} data rows")
        self.mesh, self.rows = mesh, rows

    def group_trees(self) -> list[tuple[torch.device, ResidentTree]]:
        """→ ``(compute device, the row's tree)`` per data row."""
        return [(dev, row) for (dev, _), row in zip(self.mesh.data_groups(), self.rows)]

    def resident_bytes(self) -> list[int]:
        """Bytes held by each row's entries, row after row."""
        return [b for row in self.rows for b in row.resident_bytes()]


def place_rows(tree: Any, mesh: FedMesh) -> RowTrees:
    """``tree`` (a tree on any device, or a :class:`ResidentTree` of any
    mesh) in the ``tp`` layout on ``mesh``: each row's tree is
    ``ResidentTree.empty`` on the row's entries, written one leaf at a time
    (a resident tree's leaf gathered onto the row's device first), so the
    whole tree never sits on one device."""
    src = tree if isinstance(tree, ResidentTree) else None
    leaves = None if src is not None else [w.detach() for w in tree_leaves(tree)]
    like = src.like if src is not None else tree
    rows = []
    for r, (dev, _) in enumerate(mesh.data_groups()):
        row = ResidentTree.empty(like, mesh.row_mesh(r))
        for j in range(len(row.shards)):
            row.write(j, src.gather(j, dev) if src is not None else leaves[j])
        rows.append(row)
    return RowTrees(mesh, rows)


class ReplicaStack:
    """N replicas of one model, each a :class:`ResidentTree` of one plan (the
    client-parallel step's clients of a data row, each in the row's ``tp``
    placement), read as the stacked ``(N, …)`` tree of the one-device
    client-parallel forward (``Arch.loss(..., clients=True)``): through
    :meth:`compute_tree` each leaf outside the stacks is gathered from each
    replica and stacked once, each stacked leaf hands out periods that
    gather and stack each replica's slice inside their checkpoint, and the
    gradients flow back to each replica's shards."""

    def __init__(self, replicas: list[ResidentTree]):
        if not replicas or any(r.plan != replicas[0].plan for r in replicas):
            raise ValueError("a replica stack takes one or more trees of one plan")
        self.replicas = replicas

    def compute_tree(self, device, stacked_keys: tuple) -> Any:
        device = torch.device(device)
        reps = self.replicas
        leaves = [StackedLeaf(reps, j, device, clients=True) if stacked
                  else torch.stack([r.gather(j, device) for r in reps])
                  for j, stacked in enumerate(reps[0].stacked_leaves(stacked_keys))]
        return tree_unflatten(reps[0].like, leaves)
