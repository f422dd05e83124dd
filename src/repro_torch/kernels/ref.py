"""Plain-torch oracles for the kernels (port of ``repro/kernels/ref.py``).

The projection and aggregation oracles are the core functions.  The
fused oracle writes the chunked spec of :mod:`reconstruct_apply` longhand
with the core generator (``block_seed`` + ``random_for_shape``, not the
kernels' factored chain), so it checks the factoring as well as the sum.
O(chunk·d) memory: a test oracle, not a serving path.  The QSGD oracle
writes the reference's quantizer longhand with the core hash (not the
kernel), on per-leaf norms that a caller may inject.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.fedscalar import FedScalarConfig, server_aggregate
from repro_torch.core.prng import (
    Distribution,
    block_seed,
    fold_seed,
    hash_u32,
    random_for_shape,
    u32,
    uniform01,
)
from repro_torch.core.projection import ProjectionMode, leaf_layout, project_tree
from repro_torch.core.qsgd import QSGD_TAG, _coords_2d
from repro_torch.core.tree import tree_leaves, tree_unflatten
from repro_torch.kernels.ops import fold_upload_weights, leaf_block_bounds
from repro_torch.kernels.reconstruct_apply import FUSED_CHUNK, pad_cohort

__all__ = ["project_tree_ref", "server_update_ref", "server_update_fused_ref",
           "qsgd_roundtrip_ref"]




def project_tree_ref(delta: Any, seed,
                     distribution: Distribution = Distribution.RADEMACHER,
                     num_projections: int = 1,
                     mode: ProjectionMode = ProjectionMode.FULL):
    return project_tree(delta, seed, distribution,
                        num_projections=num_projections, mode=mode)


def server_update_ref(params: Any, rs, seeds, server_lr: float = 1.0,
                      distribution: Distribution = Distribution.RADEMACHER,
                      num_projections: int = 1,
                      mode: ProjectionMode = ProjectionMode.FULL,
                      block_weights=None):
    cfg = FedScalarConfig(server_lr=server_lr, distribution=distribution,
                          num_projections=num_projections, mode=mode)
    rs = torch.as_tensor(rs, dtype=torch.float32)
    if rs.dim() == 1:
        rs = rs.reshape(-1, 1)
    return server_aggregate(params, rs, seeds, cfg, block_weights=block_weights)


def server_update_fused_ref(params: Any, rs, seeds, server_lr: float = 1.0,
                            distribution: Distribution = Distribution.RADEMACHER,
                            num_projections: int = 1,
                            mode: ProjectionMode = ProjectionMode.FULL,
                            weights=None, block_weights=None):
    """Bitwise oracle for the fused reconstruct+apply numeric spec."""
    rs, scale = fold_upload_weights(torch.as_tensor(rs), server_lr, weights,
                                    mode, block_weights)
    rs = rs * torch.tensor(scale, dtype=torch.float32, device=rs.device)
    n, k = rs.shape
    seeds, rs = pad_cohort(torch.as_tensor(seeds, device=rs.device)
                           .to(torch.int64), rs)
    masked = mode == ProjectionMode.BLOCK and k > 1
    layout = leaf_layout(params)
    total = layout[-1].end if layout else 0
    out = []
    for ll, leaf in zip(layout, tree_leaves(params)):
        dev = leaf.device
        x2d = leaf.reshape(ll.rows, ll.cols)
        lo, hi = leaf_block_bounds(ll.offset, ll.size, total, k, mode)
        if masked:
            flat = (torch.arange(ll.rows, dtype=torch.float32, device=dev)[:, None]
                    * float(ll.cols)
                    + torch.arange(ll.cols, dtype=torch.float32, device=dev)[None, :])
        acc = torch.zeros((ll.rows, ll.cols), dtype=torch.float32, device=dev)
        for b in range(k):
            mask = None
            if masked:
                mask = ((flat >= lo[b]) & (flat < hi[b])).to(torch.float32)
            for c in range(0, seeds.numel(), FUSED_CHUNK):
                s = None
                for i in range(c, c + FUSED_CHUNK):
                    v = random_for_shape((ll.rows, ll.cols),
                                         block_seed(seeds[i], b), ll.tag,
                                         distribution)
                    contrib = rs[i, b] * v
                    if mask is not None:
                        contrib = contrib * mask
                    s = contrib if s is None else s + contrib
                acc = acc + s
        y = (x2d.to(torch.float32) + acc).to(leaf.dtype)
        out.append(y.reshape(ll.shape))
    return tree_unflatten(params, out)


def qsgd_roundtrip_ref(tree: Any, seed, bits: int = 8, norms=None):
    """Oracle of the QSGD round trip, one leaf at a time (reference op order)."""
    levels = (1 << (bits - 1)) - 1
    out = []
    for tag, leaf in enumerate(tree_leaves(tree)):
        dev = leaf.device
        (rows, cols), row, col = _coords_2d(tuple(leaf.shape), dev)
        xf = leaf.to(torch.float32).reshape(rows, cols)
        if norms is None:
            norm = torch.linalg.vector_norm(xf.reshape(-1))
            norm = torch.where(norm == 0, torch.ones_like(norm), norm)
        else:
            norm = torch.as_tensor(norms[tag], dtype=torch.float32, device=dev)
        u = uniform01(hash_u32(fold_seed(u32(seed, dev), tag), row, col,
                               QSGD_TAG))
        scaled = torch.abs(xf) / norm * float(levels)
        floor = torch.floor(scaled)
        level = floor + (u < (scaled - floor)).to(torch.float32)
        signed = torch.sign(xf) * level
        q = norm * signed / torch.tensor(float(levels), device=dev)
        out.append(q.to(leaf.dtype).reshape(leaf.shape))
    return tree_unflatten(tree, out)
