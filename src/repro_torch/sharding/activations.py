"""Activation sharding constraints by logical axes (port of
``repro/sharding/activations.py``).

The reference pins key activations with ``constrain(x, BATCH, None,
MODEL)``-style calls: logical axes resolved against the ambient mesh
(``BATCH`` → whichever of ('pod', 'data') exist, or all three axes in
``dp256`` mode, nothing in ``off`` mode; ``MODEL`` → 'model'), an axis
dropped where the mesh's size does not divide the dim, and no constraint
at all off a mesh.  The port has no partitioner to hint: its mesh train
step places the parameters in shards itself (``sharding/resident.py``)
and splits each step's batch over the ``data`` axis itself
(``launch/train.py``, ``FedMesh.data_groups``).  So :func:`constrain`
resolves the spec as the reference does and returns ``x`` unchanged, and
:func:`resolve` is that resolution as a pure function of the dims, the
logical axes, the mesh's axis sizes and the mode (the dry run's).
"""
from __future__ import annotations

import contextlib

__all__ = ["BATCH", "MODEL", "batch_mode", "batch_over_model", "constrain",
           "resolve", "ambient_axes", "use_mesh"]

BATCH = "__batch__"
MODEL = "__model__"

# Layout modes for the BATCH logical axis: "dp" (baseline, ('pod',
# 'data')), "dp256" (('pod', 'data', 'model')), "off" (no constraint: the
# client-parallel placement owns the data axis for the client dim).
_BATCH_MODE = ["dp"]
# The ambient mesh's axis sizes ({} off a mesh), set by use_mesh.
_AMBIENT: list = [None]


@contextlib.contextmanager
def batch_mode(mode: str):
    if mode not in ("dp", "dp256", "off"):
        raise ValueError(f"batch mode {mode!r}")
    prev = _BATCH_MODE[0]
    _BATCH_MODE[0] = mode
    try:
        yield
    finally:
        _BATCH_MODE[0] = prev


def batch_over_model():
    return batch_mode("dp256")


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh``'s axes ambient for :func:`constrain` (the reference's
    ``jax.set_mesh``)."""
    prev = _AMBIENT[0]
    _AMBIENT[0] = dict(zip(mesh.axis_names, mesh.shape))
    try:
        yield
    finally:
        _AMBIENT[0] = prev


def ambient_axes():
    """The ambient mesh's {axis: size}, or None off a mesh."""
    return _AMBIENT[0]


def resolve(shape, logical, axes, mode: str = "dp") -> tuple:
    """The spec ``constrain`` pins for dims ``shape`` and ``logical`` axes
    (BATCH, MODEL or None per dim) on a mesh of ``axes`` sizes."""
    spec = []
    for dim, lg in zip(shape, logical):
        if lg == BATCH:
            if mode == "off":
                spec.append(None)
                continue
            names = ("pod", "data", "model") if mode == "dp256" else ("pod", "data")
            dp = tuple(a for a in names if a in axes)
            n = 1
            for a in dp:
                n *= axes[a]
            if dp and dim % n == 0 and dim >= n:
                spec.append(dp if len(dp) > 1 else dp[0])
            elif "data" in axes and dim % axes["data"] == 0 and dim >= axes["data"]:
                spec.append("data")
            else:
                spec.append(None)
        elif lg == MODEL:
            n = axes.get("model", 1)
            spec.append("model" if n > 1 and dim % n == 0 and dim >= n else None)
        else:
            spec.append(None)
    return tuple(spec)


def constrain(x, *logical):
    """The reference's ``with_sharding_constraint`` by logical axes: the
    spec is resolved on the ambient mesh (none off a mesh) and ``x``
    comes back unchanged."""
    axes = ambient_axes()
    if axes is not None:
        resolve(tuple(x.shape), logical, axes, _BATCH_MODE[0])
    return x
