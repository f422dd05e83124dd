"""The federation server's device mesh (port of ``repro/launch/mesh.py``).

A :class:`FedMesh` names its axes (``data``, ``model``), its shape, and
the devices its shards run on.  The sharded server
(:mod:`repro_torch.sharding.fed_rules`) flattens both axes into one shard
dimension over the parameter vector, row-major, and spreads the shards
over the devices in contiguous groups: shard ``s`` of ``S`` runs on
``devices[s · len(devices) // S]``.  A mesh may hold more shards than
devices: on one card a ``(2, 4)`` mesh is 8 shards on that card, decoded
by one tree launch (one per 64 (shard, leaf) entries).  One process
drives every device of the mesh (a single controller, as one JAX process
drives the reference's mesh): it places the shards
(``sharding/resident.py``), launches each device's kernels and moves
tensors between devices with ``.to``; nothing here uses
``torch.distributed``.  The mesh train step
(``launch/train.py::make_train_step(..., mesh=)``) keeps the parameters
resident in those shards and splits each step's batch over the
``data`` axis (:meth:`FedMesh.data_groups`), or over every entry with
``dp_axes`` naming ``model`` (:meth:`FedMesh.entry_groups`); serving on a
mesh splits its batch over the data rows too, and the reference's ``tp``
layout keeps one replica a row (:meth:`FedMesh.row_mesh`).

:func:`make_production_mesh` gives the dry run's meshes
(``launch/dryrun.py``): the reference's 16 × 16 (``data``, ``model``)
pod and 2 × 16 × 16 (``pod``, ``data``, ``model``) pods, abstract (no
card behind them: their one device is ``meta``; the specs and the
roofline divide the work over their axes), and the one-card mesh (1, 1),
which a card can check.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import resolve_device

__all__ = ["FedMesh", "make_fed_mesh", "make_production_mesh", "mesh_axes_sizes",
           "PRODUCTION_MESHES"]

# The dry run's meshes by name: axis names and shape.
PRODUCTION_MESHES = {
    "pod16x16": (("data", "model"), (16, 16)),
    "pod2x16x16": (("pod", "data", "model"), (2, 16, 16)),
    "one_card": (("data", "model"), (1, 1)),
}


@dataclasses.dataclass(frozen=True)
class FedMesh:
    """Axis names, shape and devices of a federation-server mesh."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        """Shards: the product of the axis sizes."""
        return math.prod(self.shape)

    def shard_device(self, s: int) -> torch.device:
        """The device of flat shard ``s``."""
        return self.devices[s * len(self.devices) // self.size]

    def device_groups(self) -> list[tuple[torch.device, tuple[int, ...]]]:
        """→ ``(device, its shards' ordinals in order)`` for each entry of
        ``devices`` that holds a shard, in shard order.  Entries are groups
        even where they name the same device (``devices=[cpu] * 4``)."""
        groups: list[list[int]] = [[] for _ in self.devices]
        for s in range(self.size):
            groups[s * len(self.devices) // self.size].append(s)
        return [(dev, tuple(g)) for dev, g in zip(self.devices, groups) if g]

    def data_groups(self) -> list[tuple[torch.device, tuple[int, ...]]]:
        """→ ``(compute device, shard ordinals)`` for each ``data`` index:
        the shards of that row of the mesh (every axis before ``model``
        indexes the rows, row-major) and the device of its first shard,
        where the row's slice of a batch is computed."""
        model = self.shape[-1] if self.axis_names[-1] == "model" else 1
        return [(self.shard_device(r * model), tuple(range(r * model, (r + 1) * model)))
                for r in range(self.size // model)]

    def entry_groups(self) -> list[tuple[torch.device, tuple[int, ...]]]:
        """→ ``(device, (s,))`` for each shard ``s``: the D·M groups of a batch
        split over every axis (the reference's ``dp_axes`` with ``model``,
        its ``dp256`` variant), in shard order."""
        return [(self.shard_device(s), (s,)) for s in range(self.size)]

    def row_mesh(self, row: int) -> "FedMesh":
        """The (1, M) mesh of row ``row``'s shards (:meth:`data_groups`'),
        each on the device it has here, over the entries of ``devices``
        that hold them: the place of one replica in the reference's ``tp``
        layout (``sharding/resident.py::RowTrees``)."""
        _, shards = self.data_groups()[row]
        entries = [s * len(self.devices) // self.size for s in shards]
        held = sorted(set(entries))
        if any(entries.count(e) * len(held) != len(shards) for e in held):
            held = entries                     # unequal shares: an entry a shard
        return FedMesh(axis_names=("data", "model"), shape=(1, len(shards)),
                       devices=tuple(self.devices[e] for e in held))


def make_fed_mesh(shape: tuple = (1, 1), device="cuda",
                  devices=None) -> FedMesh:
    """(``data``, ``model``) mesh for the mesh-sharded federation server.

    ``devices`` defaults to every visible card of ``device``'s type (the
    CPU for ``device="cpu"``).  Shape ``(1, 1)`` is the single-device
    layout, bit-identical to the unsharded path.
    """
    shape = tuple(int(s) for s in shape)
    if len(shape) != 2 or min(shape) < 1:
        raise ValueError(f"mesh shape {shape}: want two positive axis sizes")
    if devices is None:
        dev = resolve_device(device)
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   if dev.type == "cuda" else [dev])
    devices = tuple(resolve_device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return FedMesh(axis_names=("data", "model"), shape=shape, devices=devices)


def make_production_mesh(multi_pod: bool = False) -> FedMesh:
    """The reference's production mesh, (16, 16) ``data, model`` or with
    ``multi_pod`` (2, 16, 16) ``pod, data, model``, abstract (its one
    device ``meta``).  The one-card (1, 1) mesh is
    ``PRODUCTION_MESHES["one_card"]``."""
    axes, shape = PRODUCTION_MESHES["pod2x16x16" if multi_pod else "pod16x16"]
    return FedMesh(axis_names=axes, shape=shape, devices=(torch.device("meta"),))


def mesh_axes_sizes(mesh: FedMesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.shape))
