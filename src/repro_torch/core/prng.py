"""Counter-based PRNG for seeded random-projection vectors (torch port).

Counterpart of ``repro/core/prng.py``: the same SplitMix32 chain over
``(seed, tag, hi, lo)`` or ``(seed ⊕ leaf_tag, row, col)``, giving the
same bits as the reference for every direction family (gaussian's
``log``/``cos`` may differ by an ulp).

Torch on the CPU has no uint32 add, multiply or shift, so every 32-bit
word is carried in an ``int64`` tensor holding a value in ``[0, 2³²)``
and masked back to 32 bits after each op.  A product of such a value
with a constant below 2³¹ (both SplitMix32 multipliers) stays below
2⁶³; larger multipliers go through :func:`mul32`, which splits the
constant into 16-bit halves so the low 32 bits stay exact.
"""
from __future__ import annotations

import enum
import math

import numpy as np
import torch

__all__ = [
    "Distribution",
    "SPARSE_S",
    "PROJ_SALT",
    "U32_MASK",
    "u32",
    "mul32",
    "splitmix32",
    "hash_u32",
    "uniform01",
    "parity32",
    "block_seed",
    "fold_seed",
    "rademacher_flat",
    "gaussian_flat",
    "random_flat",
    "random_like",
    "random_for_shape",
]

U32_MASK = 0xFFFFFFFF

_TAG_U1 = 0x9E3779B9
_TAG_U2 = 0x85EBCA6B
_TAG_HAD_MR = 0xC2B2AE35
_TAG_HAD_MC = 0x27D4EB2F
_TAG_HAD_TR = 0x165667B1
_TAG_HAD_TC = 0x9E3779F9
_HAD_MASK_FALLBACK = 0x9E3779B9

SPARSE_S = 4
PROJ_SALT = 0xA511E9B3

INDEX_LO_BITS = 16
INDEX_LO_MASK = (1 << INDEX_LO_BITS) - 1

# float32(2π), exactly as the reference rounds it.
TWO_PI_F32 = float(np.float32(2.0 * math.pi))
# √SPARSE_S is exact in float32 for s = 4.
_SPARSE_VAL = float(SPARSE_S) ** 0.5


class Distribution(enum.Enum):
    """Sampling distribution for the projection vector v."""

    GAUSSIAN = "gaussian"
    RADEMACHER = "rademacher"
    SPARSE_RADEMACHER = "sparse_rademacher"
    HADAMARD = "hadamard"


def u32(x, device=None) -> torch.Tensor:
    """→ int64 tensor holding ``x mod 2³²`` (Python int, array or tensor)."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.int64:
            x = x.to(torch.int64)
        if device is not None:
            x = x.to(device)
        return x & U32_MASK
    if isinstance(x, np.ndarray):
        return torch.from_numpy(
            x.astype(np.int64) & U32_MASK).to(device or "cpu")
    return torch.tensor(int(x) & U32_MASK, dtype=torch.int64, device=device)


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """Low 32 bits of ``x · c`` for any 32-bit constant, exact in int64."""
    c &= U32_MASK
    lo = x * (c & 0xFFFF)                        # < 2⁴⁸
    hi = ((x * (c >> 16)) & 0xFFFF) << 16        # < 2³²
    return (lo + hi) & U32_MASK


def splitmix32(x: torch.Tensor) -> torch.Tensor:
    """SplitMix32 finalizer on int64-carried uint32 words."""
    x = (x + 0x9E3779B9) & U32_MASK
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & U32_MASK
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & U32_MASK
    x = x ^ (x >> 15)
    return x


def hash_u32(seed, hi, lo, tag: int = 0) -> torch.Tensor:
    """Hash ``(seed, tag, hi, lo)``; arguments broadcast against each other."""
    h = splitmix32(seed ^ (tag & U32_MASK))
    h = splitmix32(h ^ hi)
    h = splitmix32(h ^ lo)
    return h


def _split_index(base: int, n: int, device=None):
    """(hi, lo) words of global indices ``base + [0, n)``."""
    if base < 0:
        raise ValueError(f"negative base offset: {base}")
    off = torch.arange(n, dtype=torch.int64, device=device)
    base_lo = base & INDEX_LO_MASK
    base_hi = base >> INDEX_LO_BITS
    lo_sum = base_lo + (off & INDEX_LO_MASK)
    carry = lo_sum >> INDEX_LO_BITS
    lo = lo_sum & INDEX_LO_MASK
    hi = ((base_hi & U32_MASK) + (off >> INDEX_LO_BITS) + carry) & U32_MASK
    return hi, lo


def uniform01(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits → float32 uniform in (0, 1] (``(f32(bits) + 1)·2⁻³²``)."""
    return (bits.to(torch.float32) + 1.0) * (2.0 ** -32)


def parity32(x: torch.Tensor) -> torch.Tensor:
    """XOR-fold parity of each 32-bit word."""
    x = x ^ (x >> 16)
    x = x ^ (x >> 8)
    x = x ^ (x >> 4)
    x = x ^ (x >> 2)
    x = x ^ (x >> 1)
    return x & 1


def block_seed(seed, j) -> torch.Tensor:
    """Per-projection seed ``splitmix32(seed ⊕ (PROJ_SALT + j))``."""
    s = u32(seed)
    salt = (PROJ_SALT + u32(j, s.device)) & U32_MASK
    return splitmix32(s ^ salt)


def fold_seed(seed, leaf_tag) -> torch.Tensor:
    """Fold a leaf ordinal into the seed: ``splitmix32(seed ⊕ splitmix32(tag))``."""
    s = u32(seed)
    return splitmix32(s ^ splitmix32(u32(leaf_tag, s.device)))


def _sign(bits: torch.Tensor) -> torch.Tensor:
    """±1.0 from bit 8 of a hash."""
    return torch.where(((bits >> 8) & 1) == 1, 1.0, -1.0).to(torch.float32)


def _box_muller(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    u1 = uniform01(b1)
    u2 = uniform01(b2)
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos(TWO_PI_F32 * u2)


def _sparse_from_bits(bits: torch.Tensor) -> torch.Tensor:
    active = (bits & (SPARSE_S - 1)) == 0
    return torch.where(active, _sign(bits) * _SPARSE_VAL,
                       torch.zeros((), dtype=torch.float32, device=bits.device))


def hadamard_params(s: torch.Tensor) -> tuple:
    """Per-seed Walsh masks and translations ``(m_a, m_b, t_a, t_b)``."""
    m_a = splitmix32(s ^ _TAG_HAD_MR)
    m_a = torch.where(m_a == 0, _HAD_MASK_FALLBACK, m_a)
    m_b = splitmix32(s ^ _TAG_HAD_MC)
    m_b = torch.where(m_b == 0, _HAD_MASK_FALLBACK, m_b)
    t_a = splitmix32(s ^ _TAG_HAD_TR)
    t_b = splitmix32(s ^ _TAG_HAD_TC)
    return m_a, m_b, t_a, t_b


def _values(s: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            distribution: Distribution) -> torch.Tensor:
    """Direction values at coordinates ``(a, b)`` under seed ``s``."""
    if distribution == Distribution.RADEMACHER:
        return _sign(hash_u32(s, a, b, _TAG_U1))
    if distribution == Distribution.GAUSSIAN:
        return _box_muller(hash_u32(s, a, b, _TAG_U1),
                           hash_u32(s, a, b, _TAG_U2))
    if distribution == Distribution.SPARSE_RADEMACHER:
        return _sparse_from_bits(hash_u32(s, a, b, _TAG_U1))
    if distribution == Distribution.HADAMARD:
        m_a, m_b, t_a, t_b = hadamard_params(s)
        bit = parity32((a ^ t_a) & m_a) ^ parity32((b ^ t_b) & m_b)
        return torch.where(bit == 0, 1.0, -1.0).to(torch.float32)
    raise ValueError(f"unknown distribution: {distribution}")


def random_flat(seed, base: int, n: int,
                distribution: Distribution = Distribution.RADEMACHER,
                dtype=torch.float32, device=None) -> torch.Tensor:
    """Direction values for global flat indices ``base + [0, n)``."""
    s = u32(seed, device)
    hi, lo = _split_index(base, n, s.device)
    return _values(s, hi, lo, distribution).to(dtype)


def rademacher_flat(seed, base: int, n: int, dtype=torch.float32,
                    device=None) -> torch.Tensor:
    """±1 Rademacher vector for global indices ``base + [0, n)``: bit 8 of
    the ``_TAG_U1`` hash."""
    return random_flat(seed, base, n, Distribution.RADEMACHER, dtype, device)


def gaussian_flat(seed, base: int, n: int, dtype=torch.float32,
                  device=None) -> torch.Tensor:
    """N(0, 1) vector via Box–Muller of the ``_TAG_U1``/``_TAG_U2`` hashes
    for global indices ``base + [0, n)``."""
    return random_flat(seed, base, n, Distribution.GAUSSIAN, dtype, device)


def random_like(leaf: torch.Tensor, seed, base: int,
                distribution: Distribution = Distribution.RADEMACHER,
                dtype=torch.float32) -> torch.Tensor:
    """Direction values shaped like ``leaf``, indexed by global flat
    offsets ``base + [0, leaf.numel())``, on ``leaf``'s device.

    The small-model flat scheme; :func:`random_for_shape` is the
    ``(leaf_tag, row, col)`` scheme the projection uses.
    """
    flat = random_flat(seed, base, leaf.numel(), distribution, dtype,
                       device=leaf.device)
    return flat.reshape(leaf.shape)


def _view2(shape: tuple) -> tuple:
    if len(shape) == 0:
        return (1, 1)
    if len(shape) == 1:
        return (1,) + tuple(shape)
    return tuple(shape)


def random_for_shape(shape: tuple, seed, leaf_tag: int,
                     distribution: Distribution = Distribution.RADEMACHER,
                     dtype=torch.float32, device=None) -> torch.Tensor:
    """Seeded direction array addressed by ``(leaf_tag, row, col)``.

    ``row`` is the flat index over the leading dims, ``col`` the index
    in the last dim, exactly as ``repro.core.prng.random_for_shape``.
    """
    shape = tuple(int(d) for d in shape)
    shape2 = _view2(shape)
    rows = 1
    for d in shape2[:-1]:
        rows *= d
    if rows > U32_MASK:
        raise ValueError(
            f"leading-dim extent {rows} exceeds uint32 for shape {shape}")
    s = fold_seed(u32(seed, device), leaf_tag)
    row = torch.arange(rows, dtype=torch.int64, device=s.device)[:, None]
    col = torch.arange(shape2[-1], dtype=torch.int64, device=s.device)[None, :]
    out = _values(s, row, col, distribution)
    return out.to(dtype).reshape(shape)
