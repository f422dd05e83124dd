"""QSGD baseline (Alistarh et al., 2017), torch port of ``repro/core/qsgd.py``.

Each client uploads its update quantized to ``2**(bits−1) − 1`` magnitude
levels with unbiased stochastic rounding, plus one L2 norm per leaf::

    Q(x)_i = ‖x‖₂ · sign(x_i) · ζ_i,   ζ_i = ⌊L·|x_i|/‖x‖₂⌋/L or (⌊·⌋+1)/L

The rounding uniform at element (row, col) of a leaf's 2-D view is
``uniform01(hash_u32(fold_seed(seed, tag), row, col, QSGD_TAG))`` — the
reference's counter-based stream, so the same seeds and norms give the
same levels bit for bit.  Seeds are keyed by (round, client id)
(:func:`quant_seeds`), which lets the runtime's ``qsgd`` protocol
reproduce :func:`qsgd_round` on a sampled cohort.

A tree (:func:`quantize_tree`, :func:`qsgd_round`) goes through
:func:`repro_torch.kernels.qsgd_quant.qsgd_tree`, one call for every leaf
and client: on CUDA tensors the hand-written kernel, which computes the
norms itself, on CPU tensors its plain version, whose norms are
``torch.linalg.vector_norm`` per client and leaf.  One leaf
(:func:`quantize_cohort`, :func:`quantize_levels`, :func:`quantize_leaf`)
goes through :func:`repro_torch.kernels.qsgd_quant.qsgd_quantize` with the
norms computed outside, as in the reference.  Norms may differ from
``jnp.linalg.norm`` by an ulp or so, which can flip a level where the
uniform sits that close to the fraction.  The one-leaf functions take
``norms=`` so a caller (a parity test) can inject its own.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.fedscalar import make_local_sgd, round_seeds_for
from repro_torch.core.prng import fold_seed, u32
from repro_torch.core.projection import tree_size, view2d
from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.kernels.common import LEAF_DTYPES
from repro_torch.kernels.qsgd_quant import (
    QSGD_TAG,
    RoundSeeds,
    guarded_norms,
    qsgd_quantize,
    qsgd_tree,
)

__all__ = [
    "QSGD_TAG",
    "QSGDConfig",
    "quant_seeds",
    "round_quant_seeds",
    "leaf_norm",
    "quantize_levels",
    "dequantize_levels",
    "quantize_leaf",
    "quantize_tree",
    "quantize_cohort",
    "tree_inputs",
    "qsgd_round",
    "upload_bits_per_client",
]

# Salt of the per-(round, client) quantization seed chain.
_QUANT_SALT = 0x0A5D


@dataclasses.dataclass(frozen=True)
class QSGDConfig:
    local_steps: int = 5
    local_lr: float = 3e-3
    server_lr: float = 1.0
    bits: int = 8                 # paper's comparison point
    norm_bits: int = 32

    @property
    def levels(self) -> int:
        return (1 << (self.bits - 1)) - 1  # one bit spent on sign


def quant_seeds(round_idx, client_ids, device=None) -> torch.Tensor:
    """Per-(round, client) quantization seeds (int64 words)."""
    return round_seeds_for(round_idx, client_ids, salt=_QUANT_SALT,
                           device=device)


def round_quant_seeds(round_idx, client_ids: torch.Tensor) -> RoundSeeds:
    """:func:`quant_seeds` as :func:`qsgd_tree` takes them, derived in the
    kernel from the ``(N,)`` client ids."""
    ids = client_ids if client_ids.dtype == torch.int64 else client_ids.to(torch.int64)
    return RoundSeeds(int(round_idx), ids.contiguous(), _QUANT_SALT)


def _coords_2d(shape: tuple, device=None):
    """(rows, cols) of a leaf's 2-D view and its int64 (row, col) grids."""
    shape2 = view2d(tuple(shape))
    row = torch.arange(shape2[0], dtype=torch.int64, device=device)[:, None]
    col = torch.arange(shape2[1], dtype=torch.int64, device=device)[None, :]
    return shape2, row.expand(shape2), col.expand(shape2)


def leaf_norm(x: torch.Tensor, batched: bool = False) -> torch.Tensor:
    """Guarded float32 L2 norm (per client when ``batched``); zero → 1."""
    if batched:
        return guarded_norms(x)
    norm = torch.linalg.vector_norm(x.to(torch.float32).reshape(-1), dim=-1)
    return torch.where(norm == 0, torch.ones_like(norm), norm)


def quantize_cohort(x: torch.Tensor, seeds: torch.Tensor, levels: int,
                    tag: int = 0, want_q: bool = True, want_levels: bool = False,
                    norms: torch.Tensor | None = None):
    """One leaf of every client (leading axis N) → ``(q, signed, norms)``.

    ``q`` (x's dtype) and ``signed`` (float32 level codes) are None where
    not asked for; ``norms`` are the ``(N,)`` guarded norms used.
    """
    n = x.shape[0]
    rows, cols = view2d(tuple(x.shape[1:]))
    x3d = x.reshape(n, rows, cols).contiguous()
    if norms is None:
        norms = leaf_norm(x3d, batched=True)
    norms = norms.to(device=x.device, dtype=torch.float32).reshape(n).contiguous()
    folded = fold_seed(u32(seeds, x.device), tag).reshape(n).contiguous()
    # float32 and bf16 leaves reach the kernel as they are (it reads them as
    # float32 and rounds q once to their dtype); other dtypes go as float32.
    q, lv = qsgd_quantize(x3d if x3d.dtype in LEAF_DTYPES else x3d.to(torch.float32),
                          folded, norms, levels, want_q, want_levels)
    if q is not None:
        q = q.to(x.dtype).reshape(x.shape)
    if lv is not None:
        lv = lv.reshape(x.shape)
    return q, lv, norms


def quantize_levels(x: torch.Tensor, seed, levels: int, tag: int = 0,
                    norm: torch.Tensor | None = None):
    """→ ``(signed_levels, norm)`` of one leaf: the QSGD wire content."""
    _, lv, norms = quantize_cohort(
        x.unsqueeze(0), u32(seed, x.device).reshape(1), levels, tag,
        want_q=False, want_levels=True,
        norms=None if norm is None else torch.as_tensor(norm).reshape(1))
    return lv[0], norms[0]


def dequantize_levels(signed_levels: torch.Tensor, norm, levels: int) -> torch.Tensor:
    """Server-side decode: q = norm · signed_level / levels (float32).

    The divisor is a device tensor: CUDA divides by a host scalar as a
    multiply by its reciprocal, which is not the kernel's IEEE division.
    """
    dev = signed_levels.device
    return (torch.as_tensor(norm, dtype=torch.float32, device=dev)
            * signed_levels.to(torch.float32)
            / torch.tensor(float(levels), device=dev))


def quantize_leaf(x: torch.Tensor, seed, levels: int, tag: int = 0,
                  norm: torch.Tensor | None = None) -> torch.Tensor:
    """Unbiased stochastic quantization of one leaf (full round trip)."""
    q, _, _ = quantize_cohort(
        x.unsqueeze(0), u32(seed, x.device).reshape(1), levels, tag,
        norms=None if norm is None else torch.as_tensor(norm).reshape(1))
    return q[0]


def tree_inputs(leaves, batched: bool = True) -> list:
    """The leaves as :func:`qsgd_tree` takes them: each with a leading client
    axis (added when not ``batched``), contiguous, float32 or bf16 (other
    dtypes as float32)."""
    xs = []
    for leaf in leaves:
        x = leaf if batched else leaf.unsqueeze(0)
        if x.dtype not in LEAF_DTYPES:
            x = x.to(torch.float32)
        xs.append(x if x.is_contiguous() else x.contiguous())
    return xs


def quantize_tree(tree: Any, seeds, bits: int, batched: bool = False) -> Any:
    """Quantize each leaf with its own norm; the leaf ordinal folds the seed.

    ``batched``: every leaf carries a leading client axis and ``seeds``
    is ``(N,)``.  One :func:`qsgd_tree` call for the whole tree.
    """
    leaves = tree_leaves(tree)
    sd = u32(seeds, leaves[0].device).reshape(-1)
    qs, _, _ = qsgd_tree(tree_inputs(leaves, batched), sd, (1 << (bits - 1)) - 1,
                         want_q=True)
    return tree_unflatten(tree, [q.to(leaf.dtype).reshape(leaf.shape)
                                 for q, leaf in zip(qs, leaves)])


def qsgd_round(
    params: Any,
    client_batches: Any,   # leading axes (N, S, ...)
    round_idx,
    grad_fn: Callable,
    cfg: QSGDConfig,
    client_ids: torch.Tensor | None = None,
):
    """One QSGD round over N explicit clients → ``(new_params, {})``.

    ``client_ids`` (default ``arange(N)``) key the rounding streams by
    (round, id), as in the reference.
    """
    device = tree_leaves(params)[0].device
    deltas = make_local_sgd(grad_fn, cfg.local_lr, cfg.local_steps)(
        params, client_batches)
    n = tree_leaves(deltas)[0].shape[0]
    if client_ids is None:
        client_ids = torch.arange(n, dtype=torch.int64, device=device)
    seeds = quant_seeds(round_idx, client_ids, device)
    qdeltas = quantize_tree(deltas, seeds, cfg.bits, batched=True)
    mean_delta = tree_map(lambda d: torch.mean(d.to(torch.float32), dim=0),
                          qdeltas)
    new_params = tree_map(lambda p, g: (p + cfg.server_lr * g).to(p.dtype),
                          params, mean_delta)
    return new_params, {}


def upload_bits_per_client(params: Any, cfg: QSGDConfig) -> int:
    """d·bits + one norm per quantized tensor (costmodel single source)."""
    from repro_torch.fed.costmodel import quantized_upload_bits

    return quantized_upload_bits(tree_size(params), cfg.bits,
                                 num_norms=len(tree_leaves(params)),
                                 norm_bits=cfg.norm_bits)
