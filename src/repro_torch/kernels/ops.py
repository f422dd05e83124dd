"""Parameter trees → tree launches of the kernels (port of ``repro/kernels/ops.py``).

* ``project_tree_kernel``  ≡ ``repro.kernels.ops.project_tree_kernel``
  under ``vmap``: every client's update in one tree launch → ``(N, k)``.
* ``server_update_fused``  ≡ ``repro.kernels.ops.server_update_fused``:
  the fused round close in one tree launch, bitwise equal to the
  reference's fused spec for the ±1/±2 families; ``block``/``row_slab``
  take the tuned knobs (``kernels/tune.py``).
* ``server_update_kernel`` ≡ ``repro.kernels.ops.server_update_kernel``:
  the per-client decode (clients added one by one, scale applied last),
  the federation runtime's large-cohort apply and its digest replay, one
  tree launch; with ``per_client_rounding`` the LLM train step's
  close, bitwise the reference's ``server_aggregate``.
* ``qsgd_roundtrip_kernel`` ≡ ``repro.kernels.ops.qsgd_roundtrip_kernel``:
  the QSGD quantize→dequantize round trip of one update tree, one
  ``qsgd_tree`` launch (and its norm pass).

Each dispatches on the tensors' device inside the kernel wrappers: CUDA
tensors go to the hand-written kernels, CPU tensors to the plain
versions.  Leaves are viewed as (leading dims, last dim) matrices in
sorted-key order; the k-block partition is computed over the global
flattened tree and translated to leaf-local flat bounds once per tree
layout (``kernels/tree.py``'s cached plans, kept on the device).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.prng import Distribution
from repro_torch.core.projection import ProjectionMode
from repro_torch.core.tree import tree_leaves, tree_unflatten
from repro_torch.kernels.common import LEAF_DTYPES
from repro_torch.kernels.reconstruct_apply import fused_tree
from repro_torch.kernels.seeded_projection import project_tree
from repro_torch.kernels.seeded_reconstruct import reconstruct_tree
from repro_torch.kernels.tree import leaf_block_bounds, tree_plan

__all__ = ["leaf_block_bounds", "fold_upload_weights", "project_tree_kernel",
           "server_update_kernel", "server_update_fused",
           "qsgd_roundtrip_kernel"]


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
    to float32 first.  One tree launch (plus its reduction) per group of
    ``tree.MAX_TREE_LEAVES`` leaves.
    """
    leaves = [leaf if leaf.dtype in LEAF_DTYPES else leaf.to(torch.float32)
              for leaf in tree_leaves(deltas)]
    leaves = [leaf if leaf.is_contiguous() else leaf.contiguous() for leaf in leaves]
    plan = tree_plan("encode", [tuple(leaf.shape[1:]) for leaf in leaves],
                     [leaf.dtype for leaf in leaves], num_blocks, mode,
                     leaves[0].device)
    return project_tree(leaves, seeds.to(torch.int64), plan, distribution.value)


def server_update_fused(
    params: Any,
    rs: torch.Tensor,                    # (N,), (N, 1) or (N, k)
    seeds: torch.Tensor,                 # (N,) round seeds
    server_lr: float = 1.0,
    distribution: Distribution = Distribution.RADEMACHER,
    weights: torch.Tensor | None = None,
    mode: ProjectionMode = ProjectionMode.FULL,
    block_weights: torch.Tensor | None = None,
    block=None,                          # the kernel's tile (tuned)
    row_slab: int | None = None,         # the plain version's slab (tuned)
) -> Any:
    """Fused round close: x ← x + (lr/N)·Σₙⱼ rₙⱼ vₙⱼ (or lr·Σ wₙ… with weights).

    One tree launch per group of ``tree.MAX_TREE_LEAVES`` leaves.  ``block``
    (the kernel's tile, one of ``tree.CLOSE_TILES``; the card) and
    ``row_slab`` (the plain version's rows at once; the CPU) take
    ``kernels.tune``'s winners; neither moves a bit.
    """
    rs, scale = fold_upload_weights(rs, server_lr, weights, mode, block_weights)
    leaves = [leaf if leaf.is_contiguous() else leaf.contiguous()
              for leaf in tree_leaves(params)]
    plan = tree_plan("close", [tuple(leaf.shape) for leaf in leaves],
                     [leaf.dtype for leaf in leaves], rs.shape[1], mode,
                     leaves[0].device, tile=block)
    out = fused_tree(leaves, seeds.to(torch.int64), rs.contiguous(), scale, plan,
                     distribution.value, row_slab)
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
    per_client_rounding: bool = False,
) -> Any:
    """Per-client decode: x ← x + (lr/N)·Σₙⱼ rₙⱼ vₙⱼ (or lr·Σ wₙ… with weights).

    Same contract as :func:`server_update_fused`; every weight is folded
    into the scalars, and one tree launch per group of
    ``tree.MAX_TREE_LEAVES`` leaves decodes the tree
    (:func:`repro_torch.kernels.seeded_reconstruct.reconstruct_tree`).
    ``per_client_rounding`` rounds each client's reconstruction to the
    leaf dtype before the float32 sum and applies x + lr·(Σ/N) (Σ alone
    with weights), as the reference's ``server_aggregate`` does.
    """
    rs, scale = fold_upload_weights(rs, server_lr, weights, mode, block_weights)
    n, k = rs.shape
    div = 1.0
    if per_client_rounding:
        scale, div = server_lr, (float(n) if weights is None else 1.0)
    leaves = [leaf if leaf.is_contiguous() else leaf.contiguous()
              for leaf in tree_leaves(params)]
    plan = tree_plan("decode", [tuple(leaf.shape) for leaf in leaves],
                     [leaf.dtype for leaf in leaves], k, mode, leaves[0].device)
    out = reconstruct_tree(leaves, seeds.to(torch.int64), rs.contiguous(), scale, div,
                           plan, distribution.value, per_client_rounding)
    return tree_unflatten(params, out)


def qsgd_roundtrip_kernel(tree: Any, seed, bits: int = 8) -> Any:
    """Per-leaf QSGD quantize→dequantize of one update tree: one ``qsgd_tree``
    call through ``core.qsgd.quantize_tree`` (kernel path)."""
    from repro_torch.core.qsgd import quantize_tree

    return quantize_tree(tree, seed, bits)
