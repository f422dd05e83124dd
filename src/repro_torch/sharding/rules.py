"""Partition-spec assignment for params, inputs and caches (port of
``repro/sharding/rules.py``).

The reference's rules, for the dry run's meshes (``launch/mesh.py``'s
``make_production_mesh``):

* **Weights: 2-D fully-sharded (ZeRO-3 style).**  For each weight leaf,
  the largest eligible dim divisible by the mesh's ``model`` size is
  model-sharded, and the largest remaining dim divisible by ``data`` is
  data-sharded.  Stacked-layer leading axes are never sharded.
  Exception: MoE expert tensors (E, d, f) put the expert axis on
  ``model`` (expert parallelism) before the generic rule runs.
  ``layout="tp"`` shards over ``model`` only.
* **Activations: batch over ('pod', 'data').**
* **KV caches:** batch over data, then the last float dim ≥ 64 that
  ``model`` divides (head_dim; Mamba's d_inner).

Small leaves (< 2¹⁶ elements: norms, biases, scalars) stay replicated.

A spec is a tuple with one entry per dim: ``None``, an axis name, or a
tuple of axis names (``fed_rules.fed_param_specs``' form).  Trees are
walked in ``jax.tree_util``'s order, dict keys sorted, a NamedTuple's
fields in order, and a leaf's path renders as the reference's
``_path_str`` (keys and indices joined by ``/``, a NamedTuple field as
``.name``), so ``_STACKED_MARKERS`` match as there.  The reference's
``named`` (a ``NamedSharding`` per spec, placed by ``jax.device_put``)
has its counterpart in ``sharding/resident.py``, which places a tree in
the federation server's shard layout (``fed_rules.plan_tree``: each
leaf's 2-D view cut into contiguous slices) rather than in these specs'
2-D blocks, whose blocks of a stacked leaf are not contiguous ranges of
its view.  These specs stay the dry run's estimate: :func:`shard_shape`
and :func:`per_device_bytes` give what they would place on each device.
"""
from __future__ import annotations

import math
from typing import Any, Callable

__all__ = ["param_specs", "input_specs_sharding", "batch_spec", "tree_paths",
           "map_with_path", "shard_shape", "per_device_bytes", "path_str"]

_MIN_SHARD_ELEMS = 1 << 16

# pytree path components whose subtrees carry a stacked leading layer axis
_STACKED_MARKERS = ("period", "enc_layers", "dec_layers", "self_caches", "caches")


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node):
    """→ [(path component, child)] in jax.tree_util's order, or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def path_str(path: tuple) -> str:
    return "/".join(path)


def tree_paths(tree: Any, prefix: tuple = ()) -> list:
    """→ ``[(path, leaf)]``; ``path`` a tuple of rendered components."""
    kids = _children(tree)
    if kids is None:
        return [] if tree is None else [(prefix, tree)]
    return [pl for key, child in kids for pl in tree_paths(child, prefix + (key,))]


def map_with_path(fn: Callable, tree: Any, prefix: tuple = ()) -> Any:
    """``fn(path_str, leaf)`` leafwise, rebuilding dicts, lists, tuples and
    NamedTuples (``jax.tree_util.tree_map_with_path``)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, prefix + (str(k),)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_path(fn, getattr(tree, f), prefix + (f".{f}",))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, c, prefix + (str(i),))
                          for i, c in enumerate(tree))
    if tree is None:
        return None
    return fn(path_str(prefix), tree)


def _axes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.shape))


def _is_stacked(pstr: str) -> bool:
    return any(m in pstr for m in _STACKED_MARKERS)


def _leaf_spec(pstr: str, shape, data: int, model: int, num_experts: int) -> tuple:
    ndim = len(shape)
    spec: list = [None] * ndim
    start = 1 if (_is_stacked(pstr) and ndim > 1) else 0
    if math.prod(shape) < _MIN_SHARD_ELEMS:
        return tuple(spec)

    dims = list(range(start, ndim))
    # MoE expert tensors: expert axis → model (expert parallelism).
    if num_experts and ndim - start == 3 and shape[start] == num_experts:
        if num_experts % model == 0:
            spec[start] = "model"
        # FSDP the largest remaining dim over data
        if data > 1:
            rest = sorted(dims[1:], key=lambda i: -shape[i])
            for i in rest:
                if shape[i] % data == 0:
                    spec[i] = "data"
                    break
        return tuple(spec)

    by_size = sorted(dims, key=lambda i: -shape[i])
    if model > 1:
        for i in by_size:
            if shape[i] % model == 0:
                spec[i] = "model"
                break
    if data > 1:
        for i in by_size:
            if spec[i] is None and shape[i] % data == 0:
                spec[i] = "data"
                break
    return tuple(spec)


def param_specs(param_shapes: Any, mesh, num_experts: int = 0,
                layout: str = "zero3"):
    """→ a tree of specs matching ``param_shapes`` (tensors, ``meta`` or not).

    layout='zero3' (baseline): weights 2-D sharded over (data × model),
    gathered per use.  layout='tp': weights sharded over model only.
    """
    axes = _axes(mesh)
    data, model = axes.get("data", 1), axes.get("model", 1)
    if layout == "tp":
        data = 1  # disable the FSDP dim
    return map_with_path(
        lambda p, leaf: _leaf_spec(p, tuple(leaf.shape), data, model, num_experts),
        param_shapes)


def batch_spec(mesh, global_batch: int):
    """Batch-axis spec over ('pod', 'data'), or ('data',), or None if indivisible."""
    axes = _axes(mesh)
    dp = [a for a in ("pod", "data") if a in axes]
    n = math.prod(axes[a] for a in dp)
    if global_batch % n == 0 and global_batch >= n:
        return tuple(dp)
    if "data" in axes and global_batch % axes["data"] == 0:
        return ("data",)
    return None


def input_specs_sharding(inputs: Any, mesh, global_batch: int):
    """Specs for a dry-run input tree (batch dicts / caches / scalars).

    Per leaf: the first dim whose extent equals ``global_batch`` becomes
    the batch axis (over ('pod', 'data')); then, walking from the last
    dim backward, the first dim with extent ≥ 64 divisible by ``model``
    is model-sharded (float leaves only).  Scalars and small leaves stay
    replicated.
    """
    model = _axes(mesh).get("model", 1)
    dp = batch_spec(mesh, global_batch)

    def assign(_, leaf):
        shape = tuple(leaf.shape)
        ndim = len(shape)
        if ndim == 0:
            return ()
        spec: list = [None] * ndim
        if math.prod(shape) < _MIN_SHARD_ELEMS:
            return tuple(spec)
        batch_dim = None
        if dp is not None and global_batch > 1:
            for d in range(ndim):
                if shape[d] == global_batch:
                    batch_dim = d
                    spec[d] = dp if len(dp) > 1 else dp[0]   # P's canonical form
                    break
        if leaf.dtype.is_floating_point:
            for d in range(ndim - 1, -1, -1):
                if d == batch_dim:
                    continue
                if shape[d] >= 64 and shape[d] % model == 0:
                    spec[d] = "model"
                    break
        return tuple(spec)

    return map_with_path(assign, inputs)


def shard_shape(shape, spec, mesh) -> tuple:
    """One device's shard of a ``shape`` laid out by ``spec`` over ``mesh``
    (``NamedSharding(mesh, spec).shard_shape``): each dim divided by the
    product of its axes' sizes, rounded up."""
    axes = _axes(mesh)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, spec):
        names = () if entry is None else ((entry,) if isinstance(entry, str)
                                           else tuple(entry))
        n = math.prod(axes[a] for a in names)
        out.append(-(-dim // n))
    return tuple(out)


def per_device_bytes(tree: Any, specs: Any, mesh) -> int:
    """Bytes one device holds of ``tree`` laid out by ``specs`` (a tree of
    specs of the same structure), each leaf's shard at its dtype's size."""
    leaves = [leaf for _, leaf in tree_paths(tree)]
    spec_leaves = [s for _, s in _spec_paths(specs)]
    if len(spec_leaves) != len(leaves):
        raise ValueError(f"{len(spec_leaves)} specs for {len(leaves)} leaves")
    return sum(math.prod(shard_shape(tuple(leaf.shape), s, mesh)) * leaf.element_size()
               for leaf, s in zip(leaves, spec_leaves))


def _spec_paths(specs: Any, prefix: tuple = ()) -> list:
    """A spec tree's (path, spec) pairs: a spec (a tuple of None / names /
    name tuples) is a leaf, not a node."""
    if isinstance(specs, tuple) and not _is_namedtuple(specs) and all(
            e is None or isinstance(e, str)
            or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
            for e in specs):
        return [(prefix, specs)]
    kids = _children(specs)
    if kids is None:
        return [(prefix, specs)]
    return [pl for key, child in kids for pl in _spec_paths(child, prefix + (key,))]
