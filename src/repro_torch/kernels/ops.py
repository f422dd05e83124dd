"""Parameter trees → per-leaf kernel calls (port of ``repro/kernels/ops.py``).

* ``project_tree_kernel``  ≡ ``repro.kernels.ops.project_tree_kernel``
  under ``vmap``: every client's update in one call per leaf → ``(N, k)``.
* ``server_update_fused``  ≡ ``repro.kernels.ops.server_update_fused``:
  the fused round close, bitwise equal to the reference's fused spec for
  the ±1/±2 families.
* ``server_update_kernel`` ≡ ``repro.kernels.ops.server_update_kernel``:
  the per-client decode (clients added one by one, scale applied last),
  the federation runtime's large-cohort apply and its digest replay.
* ``qsgd_roundtrip_kernel`` ≡ ``repro.kernels.ops.qsgd_roundtrip_kernel``:
  the QSGD quantize→dequantize round trip of one update tree.

Each dispatches on the tensor's device inside the kernel wrappers: a
CUDA tensor goes to the hand-written kernel, a CPU tensor to the plain
version.  Leaves are viewed as (leading dims, last dim) matrices in
sorted-key order; the k-block partition is computed over the global
flattened tree and translated to leaf-local flat bounds here.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.directions import block_bounds, check_block_mask_domain
from repro_torch.core.prng import Distribution
from repro_torch.core.projection import ProjectionMode, leaf_layout
from repro_torch.core.tree import tree_leaves, tree_unflatten
from repro_torch.kernels.common import LEAF_DTYPES
from repro_torch.kernels.reconstruct_apply import fused_reconstruct_apply
from repro_torch.kernels.seeded_projection import project_blocks
from repro_torch.kernels.seeded_reconstruct import reconstruct_apply_clients

__all__ = ["leaf_block_bounds", "fold_upload_weights", "project_tree_kernel",
           "server_update_kernel", "server_update_fused",
           "qsgd_roundtrip_kernel"]


def leaf_block_bounds(
    leaf_offset: int, leaf_size: int, total: int, num_blocks: int,
    mode: ProjectionMode = ProjectionMode.BLOCK,
) -> tuple[list[float], list[float]]:
    """Leaf-local flat [lo, hi) of every global block (clamped, floats)."""
    if mode != ProjectionMode.BLOCK or num_blocks == 1:
        return [0.0] * num_blocks, [float(leaf_size)] * num_blocks
    check_block_mask_domain(leaf_size)
    los, his = [], []
    for j in range(num_blocks):
        blo, bhi = block_bounds(total, num_blocks, j)
        lo = min(max(blo - leaf_offset, 0), leaf_size)
        hi = min(max(bhi - leaf_offset, 0), leaf_size)
        los.append(float(lo))
        his.append(float(max(hi, lo)))
    return los, his


def _bounds(ll, total: int, k: int, mode: ProjectionMode, device):
    lo, hi = leaf_block_bounds(ll.offset, ll.size, total, k, mode)
    return (torch.tensor(lo, dtype=torch.float32, device=device),
            torch.tensor(hi, dtype=torch.float32, device=device))


def fold_upload_weights(
    rs: torch.Tensor,
    server_lr: float,
    weights: torch.Tensor | None,
    mode: ProjectionMode,
    block_weights: torch.Tensor | None,
) -> tuple[torch.Tensor, float]:
    """Fold every aggregation coefficient into the scalars → ``(rs, scale)``.

    In the reference's order: ``rs / k`` (FULL, k > 1), ``· block_weights``,
    ``· weights``; ``scale`` is ``server_lr`` with weights, else the
    Python float ``server_lr / n``, cast to float32 once by the caller.
    """
    rs = rs.to(torch.float32)
    if rs.dim() == 1:
        rs = rs[:, None]
    n, k = rs.shape
    if mode == ProjectionMode.FULL and k > 1:
        rs = rs / k
    if block_weights is not None:
        rs = rs * torch.as_tensor(block_weights, device=rs.device).to(
            torch.float32).reshape(1, k)
    if weights is not None:
        rs = rs * torch.as_tensor(weights, device=rs.device).reshape(-1, 1).to(
            torch.float32)
        scale = server_lr
    else:
        scale = server_lr / n
    return rs, scale


def project_tree_kernel(
    deltas: Any,
    seeds: torch.Tensor,
    distribution: Distribution = Distribution.RADEMACHER,
    num_blocks: int = 1,
    mode: ProjectionMode = ProjectionMode.FULL,
) -> torch.Tensor:
    """Encode every client: leaves with a leading client axis → float32 ``(N, k)``.

    float32 and bf16 leaves reach the kernel as they are (it reads them
    as float32, as the reference's kernel does); other dtypes are cast
    to float32 first.
    """
    leaves = tree_leaves(deltas)
    n = leaves[0].shape[0]
    per_client = [leaf[0] for leaf in leaves]
    layout = leaf_layout(per_client)
    total = layout[-1].end if layout else 0
    masked = mode == ProjectionMode.BLOCK and num_blocks > 1
    acc = None
    for ll, leaf in zip(layout, leaves):
        if leaf.dtype not in LEAF_DTYPES:
            leaf = leaf.to(torch.float32)
        x3d = leaf.reshape(n, ll.rows, ll.cols).contiguous()
        lo, hi = _bounds(ll, total, num_blocks, mode, leaf.device)
        r = project_blocks(x3d, seeds, ll.tag, lo, hi, distribution.value,
                           masked, orig_cols=ll.cols)
        acc = r if acc is None else acc + r
    return acc


def server_update_fused(
    params: Any,
    rs: torch.Tensor,                    # (N,), (N, 1) or (N, k)
    seeds: torch.Tensor,                 # (N,) round seeds
    server_lr: float = 1.0,
    distribution: Distribution = Distribution.RADEMACHER,
    weights: torch.Tensor | None = None,
    mode: ProjectionMode = ProjectionMode.FULL,
    block_weights: torch.Tensor | None = None,
) -> Any:
    """Fused round close: x ← x + (lr/N)·Σₙⱼ rₙⱼ vₙⱼ (or lr·Σ wₙ… with weights)."""
    rs, scale = fold_upload_weights(rs, server_lr, weights, mode, block_weights)
    k = rs.shape[1]
    leaves = tree_leaves(params)
    layout = leaf_layout(params)
    total = layout[-1].end if layout else 0
    masked = mode == ProjectionMode.BLOCK and k > 1
    out = []
    for ll, leaf in zip(layout, leaves):
        x2d = leaf.reshape(ll.rows, ll.cols).contiguous()
        lo, hi = _bounds(ll, total, k, mode, leaf.device)
        y = fused_reconstruct_apply(x2d, seeds, rs, ll.tag, scale,
                                    distribution.value, lo=lo, hi=hi,
                                    masked=masked, orig_cols=ll.cols)
        out.append(y.reshape(ll.shape))
    return tree_unflatten(params, out)


def server_update_kernel(
    params: Any,
    rs: torch.Tensor,                    # (N,), (N, 1) or (N, k)
    seeds: torch.Tensor,                 # (N,) round seeds
    server_lr: float = 1.0,
    distribution: Distribution = Distribution.RADEMACHER,
    weights: torch.Tensor | None = None,
    mode: ProjectionMode = ProjectionMode.FULL,
    block_weights: torch.Tensor | None = None,
) -> Any:
    """Per-client decode: x ← x + (lr/N)·Σₙⱼ rₙⱼ vₙⱼ (or lr·Σ wₙ… with weights).

    Same contract as :func:`server_update_fused`; every weight is folded
    into the scalars and each leaf goes through
    :func:`repro_torch.kernels.seeded_reconstruct.reconstruct_apply_clients`.
    """
    rs, scale = fold_upload_weights(rs, server_lr, weights, mode, block_weights)
    k = rs.shape[1]
    leaves = tree_leaves(params)
    layout = leaf_layout(params)
    total = layout[-1].end if layout else 0
    masked = mode == ProjectionMode.BLOCK and k > 1
    seeds = seeds.to(torch.int64)
    out = []
    for ll, leaf in zip(layout, leaves):
        x2d = leaf.reshape(ll.rows, ll.cols).contiguous()
        lo, hi = _bounds(ll, total, k, mode, leaf.device)
        y = reconstruct_apply_clients(x2d, seeds, rs, ll.tag, scale,
                                      distribution.value, lo=lo, hi=hi,
                                      masked=masked, orig_cols=ll.cols)
        out.append(y.reshape(ll.shape))
    return tree_unflatten(params, out)


def qsgd_roundtrip_kernel(tree: Any, seed, bits: int = 8) -> Any:
    """Per-leaf QSGD quantize→dequantize of one update tree (kernel path)."""
    from repro_torch.core.qsgd import quantize_tree

    return quantize_tree(tree, seed, bits)
