"""The FedScalar direction chain, written out from its definition.

A seeded Rademacher direction v(ξ) over a parameter tree, as the
FedScalar protocol defines it (full mode, one projection):

    s  = splitmix32(ξ ⊕ PROJ_SALT)                    the projection's seed
    sₗ = splitmix32(s ⊕ splitmix32(tag))              folded with the leaf's
                                                      ordinal in sorted-key order
    h  = splitmix32(splitmix32(splitmix32(sₗ ⊕ TAG_U1) ⊕ row) ⊕ col)
    v  = +1 if bit 8 of h is set, else −1

``row`` is the flat index over a leaf's leading dims and ``col`` the
index in its last dim.  Every 32-bit word is carried in an int64 tensor
holding a value in [0, 2³²), masked after each add and multiply; both
SplitMix32 multipliers are below 2³¹, so a product stays below 2⁶³.

This file is the benchmark's own copy: it imports nothing of the
program, so a change to the program's chain shows as a wrong answer.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
TAG_U1 = 0x9E3779B9
PROJ_SALT = 0xA511E9B3


def splitmix32(x: torch.Tensor) -> torch.Tensor:
    x = (x + GOLDEN) & M32
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & M32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & M32
    return x ^ (x >> 15)


def leaf_seeds(seeds: torch.Tensor, tags: torch.Tensor) -> torch.Tensor:
    """(A,) upload seeds × (E,) leaf ordinals → (A, E) folded seeds sₗ."""
    s = splitmix32((seeds.to(torch.int64) & M32) ^ PROJ_SALT)
    return splitmix32(s[:, None] ^ splitmix32(tags.to(torch.int64))[None, :])


def signs(folded: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """±1.0 (float64) at (row, col) under folded seeds; arguments broadcast."""
    h = splitmix32(splitmix32(splitmix32(folded ^ TAG_U1) ^ rows) ^ cols)
    return ((h >> 8) & 1).to(torch.float64) * 2.0 - 1.0


def direction(seed: int, tag: int, rows: int, cols: int, row0: int = 0,
              device=None) -> torch.Tensor:
    """v(ξ) over rows [row0, row0 + rows) of one leaf's 2-D view, (rows, cols) float64."""
    folded = leaf_seeds(torch.tensor([seed], device=device),
                        torch.tensor([tag], device=device))[0, 0]
    r = torch.arange(row0, row0 + rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    return signs(folded, r, c)
