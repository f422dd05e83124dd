"""Direction families and the k-block partition (torch port).

Counterpart of ``repro/core/directions.py``.  A :class:`DirectionFamily`
names the sampling chain in :mod:`repro_torch.core.prng`, its kurtosis
κ = E[v⁴] for the estimator-variance model (d − 2 + κ)·‖δ‖² per block,
and its wire cost.  :func:`block_bounds` is the single source of the
k-block partition over the flattened parameter vector.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core.prng import SPARSE_S, Distribution, random_for_shape
from repro_torch.core.tree import tree_leaves

__all__ = [
    "DirectionFamily",
    "FAMILIES",
    "get_family",
    "MAX_MASKED_LEAF",
    "check_block_mask_domain",
    "block_bounds",
    "block_dims",
    "tree_block_sqnorms",
    "optimal_block_weights",
]

# float32 flat-index block masks are exact only below 2**24 elements per leaf.
MAX_MASKED_LEAF = 1 << 24


def check_block_mask_domain(leaf_size: int) -> None:
    """BLOCK-mode guard: loud failure instead of silently-rounded bounds."""
    if leaf_size > MAX_MASKED_LEAF:
        raise ValueError(
            f"leaf of {leaf_size} elements exceeds the exact float32 "
            f"block-mask domain (2**24); use fewer/larger blocks or "
            f"split the leaf")


@dataclasses.dataclass(frozen=True)
class DirectionFamily:
    """One projection-direction distribution, as a value."""

    name: str
    distribution: Distribution
    kurtosis: float
    description: str = ""

    def sample(self, shape: tuple, seed, leaf_tag: int,
               dtype=torch.float32, device=None) -> torch.Tensor:
        """This family's direction slice for one leaf (see ``random_for_shape``)."""
        return random_for_shape(shape, seed, leaf_tag, self.distribution,
                                dtype=dtype, device=device)

    def variance_coeff(self, d: int) -> float:
        """Var‖δ̂ − δ‖² per unit ‖δ‖² for one block of dimension d."""
        return float(d) - 2.0 + self.kurtosis

    def predicted_variance(self, total_dim: int, num_blocks: int = 1,
                           block_sqnorms: Sequence[float] | None = None,
                           total_sqnorm: float = 1.0) -> float:
        dims = block_dims(total_dim, num_blocks)
        if block_sqnorms is None:
            block_sqnorms = [total_sqnorm * dj / total_dim for dj in dims]
        if len(block_sqnorms) != num_blocks:
            raise ValueError(
                f"{len(block_sqnorms)} block energies for {num_blocks} blocks")
        return float(sum(self.variance_coeff(dj) * float(e)
                         for dj, e in zip(dims, block_sqnorms)))

    def bits_per_upload(self, num_blocks: int = 1, scalar_bits: int = 32,
                        seed_bits: int = 32) -> int:
        from repro_torch.fed.costmodel import upload_bits

        return upload_bits(num_blocks, scalar_bits, seed_bits)


FAMILIES = {
    "gaussian": DirectionFamily(
        "gaussian", Distribution.GAUSSIAN, kurtosis=3.0,
        description="paper baseline N(0, I); κ=3"),
    "rademacher": DirectionFamily(
        "rademacher", Distribution.RADEMACHER, kurtosis=1.0,
        description="paper Thm 2 low-variance choice; κ=1"),
    "sparse_rademacher": DirectionFamily(
        "sparse_rademacher", Distribution.SPARSE_RADEMACHER,
        kurtosis=float(SPARSE_S),
        description=f"Achlioptas ±√s/0, s={SPARSE_S}"),
    "hadamard": DirectionFamily(
        "hadamard", Distribution.HADAMARD, kurtosis=1.0,
        description="random Walsh row; 4-wise dependent"),
}

_BY_DISTRIBUTION = {f.distribution: f for f in FAMILIES.values()}


def get_family(family: str | Distribution | DirectionFamily) -> DirectionFamily:
    """Resolve a family by name, by Distribution, or pass one through."""
    if isinstance(family, DirectionFamily):
        return family
    if isinstance(family, Distribution):
        return _BY_DISTRIBUTION[family]
    try:
        return FAMILIES[family]
    except KeyError:
        raise ValueError(
            f"unknown direction family {family!r}; want one of {list(FAMILIES)}"
        ) from None


def block_bounds(total: int, num_blocks: int, j: int) -> tuple[int, int]:
    """Contiguous ``[lo, hi)`` bounds of block j of k over ``total`` elements."""
    lo = (total * j) // num_blocks
    hi = (total * (j + 1)) // num_blocks
    return lo, hi


def block_dims(total: int, num_blocks: int) -> list[int]:
    """Sizes of the k blocks (they differ by at most one element)."""
    return [block_bounds(total, num_blocks, j)[1]
            - block_bounds(total, num_blocks, j)[0]
            for j in range(num_blocks)]


def tree_block_sqnorms(tree: Any, num_blocks: int) -> np.ndarray:
    """Per-block ‖δⱼ‖² under the k-block flat partition (host float64)."""
    flat = np.concatenate([
        leaf.detach().to("cpu", torch.float32).numpy().reshape(-1)
        for leaf in tree_leaves(tree)])
    total = flat.size
    out = np.zeros(num_blocks, np.float64)
    for j in range(num_blocks):
        lo, hi = block_bounds(total, num_blocks, j)
        out[j] = float(np.sum(flat[lo:hi].astype(np.float64) ** 2))
    return out


def optimal_block_weights(
    family: str | Distribution | DirectionFamily,
    total_dim: int,
    num_blocks: int,
    mean_block_sqnorms: Sequence[float],
    client_block_sqnorm_sums: Sequence[float],
    num_clients: int,
) -> np.ndarray:
    """Wiener shrinkage cⱼ* = ‖ḡⱼ‖² / (‖ḡⱼ‖² + Vⱼ) per block (host float64)."""
    fam = get_family(family)
    dims = block_dims(total_dim, num_blocks)
    s = np.asarray(mean_block_sqnorms, np.float64)
    q = np.asarray(client_block_sqnorm_sums, np.float64)
    if s.shape != (num_blocks,) or q.shape != (num_blocks,):
        raise ValueError((s.shape, q.shape, num_blocks))
    v = np.array([fam.variance_coeff(dj) for dj in dims]) * q / num_clients**2
    denom = s + v
    return np.where(denom > 0, s / np.maximum(denom, 1e-38), 1.0)
