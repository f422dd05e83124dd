"""Dependency-free checkpointing (msgpack envelope + npy blobs), port of
``repro/checkpoint/msgpack_ckpt.py`` with the same layout on disk::

    <dir>/manifest.msgpack   — step, metadata, each leaf's shape and dtype
    <dir>/arrays.npz         — one entry per leaf (its ``||``-joined path)

Paths join dict keys and list indices with ``||`` in the reference's leaf
order (sorted keys), so a float32 tree saved by either package restores
in the other.  The manifest goes through the port's own MessagePack
codec (``msgpack_codec``): the card's machine has no ``msgpack``.

A bf16 leaf is written as the reference writes one — its 16-bit words as
a ``V2`` array, with ``"bfloat16"`` in the manifest — and restored bit
for bit from the manifest's dtype, with no ``ml_dtypes``.  (The
reference's own restore cannot read such a leaf back.)  Arrays pass
through host memory, as in the reference, one leaf at a time: the
archive is written entry by entry (``np.savez``'s layout) and read
lazily.  A tree resident in shards over a mesh (``sharding/resident.py``)
is saved unsharded, leaf by leaf, and ``restore_checkpoint(...,
mesh=)`` places each leaf straight into its shards (the reference's
``shardings=``), so neither the host nor a device holds the whole tree.
"""
from __future__ import annotations

import os
import zipfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint import msgpack_codec
from repro_torch.core.tree import tree_leaves, tree_unflatten
from repro_torch.device import resolve_device
from repro_torch.sharding.resident import ResidentTree

__all__ = ["save_checkpoint", "restore_checkpoint"]

_SEP = "||"


def _flatten_with_paths(tree: Any, prefix: tuple = ()) -> dict:
    """``{"a||0||b": leaf}`` in sorted-key order (``jax.tree_util``'s)."""
    if isinstance(tree, dict):
        out = {}
        for key in sorted(tree):
            out.update(_flatten_with_paths(tree[key], prefix + (str(key),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, sub in enumerate(tree):
            out.update(_flatten_with_paths(sub, prefix + (str(i),)))
        return out
    return {_SEP.join(prefix): tree}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def save_checkpoint(directory: str, tree: Any, step: int = 0,
                    metadata: Optional[dict] = None) -> str:
    """Write ``tree`` (a tree of tensors or a :class:`ResidentTree`) under
    ``directory``; a resident tree is gathered to the host a leaf at a
    time."""
    os.makedirs(directory, exist_ok=True)
    resident = isinstance(tree, ResidentTree)
    flat = _flatten_with_paths(tree.like if resident else tree)
    manifest = {
        "step": step,
        "metadata": metadata or {},
        "leaves": {k: {"shape": list(v.shape), "dtype": _dtype_name(v.dtype)}
                   for k, v in flat.items()},
    }
    with open(os.path.join(directory, "manifest.msgpack"), "wb") as f:
        f.write(msgpack_codec.packb(manifest))
    # np.savez's archive (stored ``<key>.npy`` entries), one leaf at a time
    with zipfile.ZipFile(os.path.join(directory, "arrays.npz"), "w",
                         compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        for j, (key, leaf) in enumerate(flat.items()):
            if resident:
                leaf = tree.gather(j, "cpu")
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, _to_numpy(leaf), allow_pickle=False)
    return directory


def _tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"a bfloat16 leaf stored as {arr.dtype}")
        return torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def restore_checkpoint(directory: str, like: Any, device="cuda",
                       mesh=None) -> tuple:
    """→ (tree shaped like ``like``, step, metadata).

    ``like`` gives the structure and each leaf's shape and dtype (tensors,
    or anything with ``.shape`` and a torch ``.dtype``; a
    :class:`ResidentTree`'s ``like``); leaves land on ``device`` (the card
    unless the caller names the CPU), cast to the ``like`` leaf's dtype as
    the reference casts them.  With ``mesh`` (``launch/mesh.py``) →
    a :class:`ResidentTree` on it, each leaf placed in its shards as it is
    read (``device`` unused).
    """
    if isinstance(like, ResidentTree):
        like = like.like
    out = None if mesh is None else ResidentTree.empty(like, mesh)
    dev = None if mesh is not None else resolve_device(device)
    with open(os.path.join(directory, "manifest.msgpack"), "rb") as f:
        manifest = msgpack_codec.unpackb(f.read())
    flat_like = _flatten_with_paths(like)
    with np.load(os.path.join(directory, "arrays.npz")) as data:
        missing = set(flat_like) - set(data.files)
        if missing:
            raise KeyError(f"checkpoint missing leaves: {sorted(missing)[:5]}…")
        leaves = []
        for key, ref in flat_like.items():
            arr = data[key]
            if list(arr.shape) != list(ref.shape):
                raise ValueError(f"{key}: shape {arr.shape} != expected "
                                 f"{tuple(ref.shape)}")
            t = _tensor(arr, manifest["leaves"][key]["dtype"])
            if out is not None:
                out.write(len(leaves), t.to(dtype=ref.dtype))
                leaves.append(None)
            else:
                leaves.append(t.to(device=dev, dtype=ref.dtype))
    if out is not None:
        return out, manifest["step"], manifest["metadata"]
    # flat_like is in sorted-key order, which tree_unflatten expects
    return tree_unflatten(like, leaves), manifest["step"], manifest["metadata"]
