"""The kernels' direction chain in plain torch (counterpart of ``repro/kernels/common.py``).

``hash_u32(s, row, col, tag)`` is three chained SplitMix32 rounds; the
first depends only on the seed and the second only on (seed, row).
:func:`row_state` evaluates those two rounds once per (seed, row), and
:func:`tile_from_state` finishes with the one per-element round plus the
family's value map.  It is a re-bracketing of the same chain, so values
equal :func:`repro_torch.core.prng.random_for_shape` bit for bit.
``csrc/chain.cuh`` is the same chain as CUDA ``__device__`` functions
in native uint32; the kernels' plain versions use this module.

Words are int64 tensors holding uint32 values, as in
:mod:`repro_torch.core.prng`.
"""
from __future__ import annotations

import torch

from repro_torch.core.prng import (
    _TAG_U1,
    _TAG_U2,
    _box_muller,
    _sign,
    _sparse_from_bits,
    fold_seed,
    hadamard_params,
    parity32,
    splitmix32,
)

__all__ = ["DIST_NAMES", "DIST_CODES", "LEAF_DTYPES", "fold_seed", "row_state",
           "tile_from_state", "gen_tile", "check_cuda_tensor", "check_cohort",
           "raise_on_cuda_error"]

# Family names as the kernels take them; the code is the CUDA switch value.
DIST_NAMES = ("rademacher", "gaussian", "sparse_rademacher", "hadamard")
DIST_CODES = {name: i for i, name in enumerate(DIST_NAMES)}
# Leaf dtypes the FedScalar and QSGD kernels read and write, with their
# ``fs::DType`` codes (csrc/chain.cuh); arithmetic is float32 either way.
LEAF_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def row_state(seed_folded: torch.Tensor, row: torch.Tensor,
              distribution: str) -> tuple:
    """Hoisted per-(seed, row) chain state; arguments broadcast."""
    s, r = seed_folded, row
    if distribution in ("rademacher", "sparse_rademacher"):
        return (splitmix32(splitmix32(s ^ _TAG_U1) ^ r),)
    if distribution == "gaussian":
        return (splitmix32(splitmix32(s ^ _TAG_U1) ^ r),
                splitmix32(splitmix32(s ^ _TAG_U2) ^ r))
    if distribution == "hadamard":
        m_r, m_c, t_r, t_c = hadamard_params(s)
        return (parity32((r ^ t_r) & m_r), m_c, t_c)
    raise ValueError(distribution)


def tile_from_state(state: tuple, col: torch.Tensor,
                    distribution: str) -> torch.Tensor:
    """float32 direction values from a :func:`row_state` and a broadcastable col."""
    c = col
    if distribution == "rademacher":
        return _sign(splitmix32(state[0] ^ c))
    if distribution == "gaussian":
        return _box_muller(splitmix32(state[0] ^ c), splitmix32(state[1] ^ c))
    if distribution == "sparse_rademacher":
        return _sparse_from_bits(splitmix32(state[0] ^ c))
    if distribution == "hadamard":
        pr, m_c, t_c = state
        bit = pr ^ parity32((c ^ t_c) & m_c)
        return torch.where(bit == 0, 1.0, -1.0).to(torch.float32)
    raise ValueError(distribution)


def gen_tile(seed_folded: torch.Tensor, row: torch.Tensor, col: torch.Tensor,
             distribution: str) -> torch.Tensor:
    """Direction values at (row, col) for an already leaf-folded seed."""
    return tile_from_state(row_state(seed_folded, row, distribution), col,
                           distribution)


def check_cuda_tensor(name: str, t: torch.Tensor, dtype, ndim: int,
                      device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``ndim`` on ``device`` whose
    dtype is ``dtype`` (or one of them, for a collection)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    allowed = (dtype,) if isinstance(dtype, torch.dtype) else tuple(dtype)
    if t.dtype not in allowed:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {allowed}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has {t.dim()} dims, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_cohort(seeds: torch.Tensor, rs: torch.Tensor, distribution: str,
                 device: torch.device) -> tuple[int, int]:
    """Raise unless ``seeds`` (N,) int64 and ``rs`` (N, k) float32 are a
    cohort on ``device`` and ``distribution`` a family name; → (N, k)."""
    check_cuda_tensor("seeds", seeds, torch.int64, 1, device)
    check_cuda_tensor("rs", rs, torch.float32, 2, device)
    n, k = rs.shape
    if seeds.numel() != n:
        raise ValueError(f"seeds {seeds.numel()} / rs {tuple(rs.shape)} disagree")
    if distribution not in DIST_CODES:
        raise ValueError(f"unknown distribution {distribution!r}")
    return n, k


def raise_on_cuda_error(fn: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err} at launch")
