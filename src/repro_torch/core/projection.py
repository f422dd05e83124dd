"""Scalar projection encode/decode (torch port of ``repro/core/projection.py``).

Client::  r = ⟨δ, v(ξ)⟩        Server::  δ̂ = r · v(ξ)

``v`` is regenerated leaf by leaf from the 32-bit seed with the chain in
:mod:`repro_torch.core.prng`.  FULL mode: each of the m projections
spans all of d (1/m mean on decode).  BLOCK mode: d is split into m
contiguous blocks and block j is projected onto its own direction.

These are the plain per-client functions (the reference's jnp path).
The batched, kernel-backed encode is
:func:`repro_torch.kernels.ops.project_tree_kernel`.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Sequence

import torch

from repro_torch.core.directions import block_bounds, check_block_mask_domain
from repro_torch.core.prng import Distribution, block_seed, random_for_shape
from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten

__all__ = [
    "ProjectionMode",
    "LeafLayout",
    "leaf_layout",
    "tree_size",
    "project_tree",
    "reconstruct_tree",
    "project_reconstruct_mean",
]


class ProjectionMode(enum.Enum):
    FULL = "full"
    BLOCK = "block"


def tree_size(tree: Any) -> int:
    return sum(leaf.numel() for leaf in tree_leaves(tree))


@dataclasses.dataclass(frozen=True)
class LeafLayout:
    """Where one leaf sits in the global flattened parameter vector."""

    tag: int            # leaf ordinal in sorted-key order
    shape: tuple        # original leaf shape
    rows: int           # 2-D view rows (product of leading dims)
    cols: int           # 2-D view cols (last dim; 1-D leaves are a row)
    offset: int         # global flat offset of the leaf's first element
    size: int           # rows * cols

    @property
    def end(self) -> int:
        return self.offset + self.size


def view2d(shape: tuple) -> tuple[int, int]:
    """(rows, cols) of a leaf's 2-D view: leading dims × last dim."""
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return 1, int(shape[0])
    rows = 1
    for s in shape[:-1]:
        rows *= int(s)
    return rows, int(shape[-1])


def leaf_layout(tree: Any) -> tuple[LeafLayout, ...]:
    """→ per-leaf :class:`LeafLayout` in sorted-key (tree_leaves) order."""
    out = []
    offset = 0
    for tag, leaf in enumerate(tree_leaves(tree)):
        shape = tuple(int(d) for d in leaf.shape)
        rows, cols = view2d(shape)
        size = rows * cols
        out.append(LeafLayout(tag=tag, shape=shape, rows=rows, cols=cols,
                              offset=offset, size=size))
        offset += size
    return tuple(out)


def _block_mask(shape: tuple, offset: int, blo: int, bhi: int,
                device=None) -> torch.Tensor:
    """1.0 where the element's global flat index lies in [blo, bhi).

    Compared in leaf-local float32 coordinates, exactly like the
    reference (and the kernels' ``leaf_block_bounds``).
    """
    rows, cols = view2d(shape)
    size = rows * cols
    row = torch.arange(rows, dtype=torch.float32, device=device)[:, None]
    col = torch.arange(cols, dtype=torch.float32, device=device)[None, :]
    flat = row * float(cols) + col
    lo = min(max(blo - offset, 0), size)
    hi = min(max(bhi - offset, 0), size)
    mask = (flat >= float(lo)) & (flat < float(max(hi, lo)))
    return mask.to(torch.float32).reshape(shape)


def _check_masks(leaves) -> None:
    for leaf in leaves:
        check_block_mask_domain(leaf.numel())


def project_tree(
    delta: Any,
    seed,
    distribution: Distribution = Distribution.RADEMACHER,
    num_projections: int = 1,
    mode: ProjectionMode = ProjectionMode.FULL,
) -> torch.Tensor:
    """Encode one client's update into float32 ``(num_projections,)``."""
    leaves = tree_leaves(delta)
    device = leaves[0].device
    total = sum(l.numel() for l in leaves)
    block = mode == ProjectionMode.BLOCK and num_projections > 1
    if block:
        _check_masks(leaves)
    rs = []
    for j in range(num_projections):
        sj = block_seed(torch.as_tensor(seed, device=device), j)
        acc = torch.zeros((), dtype=torch.float32, device=device)
        blo, bhi = block_bounds(total, num_projections, j) if block else (0, total)
        offset = 0
        for tag, leaf in enumerate(leaves):
            size = leaf.numel()
            if offset + size <= blo or offset >= bhi:
                offset += size
                continue
            v = random_for_shape(leaf.shape, sj, tag, distribution)
            x = leaf.to(torch.float32)
            if blo > offset or bhi < offset + size:
                mask = _block_mask(tuple(leaf.shape), offset, blo, bhi, device)
                acc = acc + torch.sum(x * v * mask)
            else:
                acc = acc + torch.sum(x * v)
            offset += size
        rs.append(acc)
    return torch.stack(rs)


def reconstruct_tree(
    like: Any,
    seed,
    r: torch.Tensor,
    distribution: Distribution = Distribution.RADEMACHER,
    num_projections: int = 1,
    mode: ProjectionMode = ProjectionMode.FULL,
    scale: float = 1.0,
    block_weights: torch.Tensor | None = None,
) -> dict:
    """Decode scalars to an update tree: ``δ̂ = (scale/m) Σⱼ rⱼ vⱼ``.

    Returns a tree shaped like ``like`` (float32 accumulation, cast to
    each leaf's dtype).  BLOCK mode reconstructs each block from its
    own scalar with no 1/m factor.
    """
    leaves = tree_leaves(like)
    device = leaves[0].device
    total = sum(l.numel() for l in leaves)
    m = num_projections
    block = mode == ProjectionMode.BLOCK and m > 1
    if block:
        _check_masks(leaves)
    r = torch.as_tensor(r, dtype=torch.float32, device=device).reshape(-1)
    if block_weights is not None:
        r = r * torch.as_tensor(block_weights, dtype=torch.float32,
                                device=device).reshape(-1)
    seed = torch.as_tensor(seed, device=device)
    out = []
    offset = 0
    for tag, leaf in enumerate(leaves):
        size = leaf.numel()
        acc = torch.zeros(leaf.shape, dtype=torch.float32, device=device)
        for j in range(m):
            sj = block_seed(seed, j)
            if block:
                blo, bhi = block_bounds(total, m, j)
                if offset + size <= blo or offset >= bhi:
                    continue
                v = random_for_shape(leaf.shape, sj, tag, distribution)
                if blo > offset or bhi < offset + size:
                    mask = _block_mask(tuple(leaf.shape), offset, blo, bhi,
                                       device)
                    acc = acc + r[j] * v * mask
                else:
                    acc = acc + r[j] * v
            else:
                v = random_for_shape(leaf.shape, sj, tag, distribution)
                acc = acc + (r[j] / m) * v
        out.append((acc * scale).to(leaf.dtype))
        offset += size
    return tree_unflatten(like, out)


def project_reconstruct_mean(
    deltas: Sequence[Any],
    seeds: Sequence,
    distribution: Distribution = Distribution.RADEMACHER,
    num_projections: int = 1,
    mode: ProjectionMode = ProjectionMode.FULL,
) -> Any:
    """Plain end-to-end round: encode every client, decode, average.

    Algorithm 1 lines 4–12 for explicit client lists, on the device of
    the deltas.
    """
    n = len(deltas)
    if n != len(seeds):
        raise ValueError(f"{n} deltas for {len(seeds)} seeds")
    acc = None
    for delta, seed in zip(deltas, seeds):
        r = project_tree(delta, seed, distribution, num_projections, mode)
        rec = reconstruct_tree(delta, seed, r, distribution, num_projections,
                               mode)
        acc = rec if acc is None else tree_map(torch.add, acc, rec)
    return tree_map(lambda x: x / n, acc)
