"""Fused server close y = x + Σ_b Σ_chunks leftfold₁₆((r·v)·mask_b) — one launch per tree.

Port of ``repro/kernels/reconstruct_apply.py::_fused_kernel``.  The CUDA
kernel is ``csrc/reconstruct_apply.cu``; this module holds its plain
PyTorch version (the fused spec written out) and the wrappers:
:func:`fused_tree` closes every leaf of a tree in one launch (one per
group of ``tree.MAX_TREE_LEAVES`` leaves), :func:`fused_reconstruct_apply`
one leaf's 2-D view, as a tree of one.

The numeric spec is the reference's:

    rs ← f32(scale) · rs                       # folded once, before the sum
    pad the cohort to a multiple of FUSED_CHUNK (zero seeds, zero scalars)
    for block b, then chunk c, in order:
      s = p₀ + p₁ + … + p₁₅  (left to right),  pᵢ = (rᵢ_b · vᵢ_b) · mask_b
      acc = acc + s                            # float32
    y = x + acc                                # x read as float32, y cast
                                               # once to x's dtype

The reference oracle (``repro.kernels.ref.server_update_fused_ref``)
reduces each chunk with XLA's CPU sum, which is that same left fold;
``torch.sum`` is not, so both versions here spell the 16 adds out.
FUSED_CHUNK is a numerics constant: changing it changes output bits.
The kernel folds the scale in as it stages each chunk and skips the
padded slots, which leaves these bits unchanged (its note says why).
The counter ``close.launches`` (:mod:`repro_torch.obs`) counts kernel
launches.

Two knobs move no bit, as in the reference, and ``kernels/tune.py``
tunes them: the kernel's tile (``block``, one of ``tree.CLOSE_TILES``;
the plan of a tree fixes it) and the plain version's ``row_slab``, the
rows it computes at once (None: as many as keep its temporaries near
2²² elements).  Each element's value depends only on its coordinates and
the chunk spec, never on which thread or slab computes it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import obs
from repro_torch.core.prng import PROJ_SALT, U32_MASK, splitmix32
from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    DIST_CODES,
    LEAF_DTYPES,
    check_cohort,
    check_cuda_tensor,
    fold_seed,
    gen_tile,
    raise_on_cuda_error,
)
from repro_torch.kernels.tree import (
    CLOSE_TILES,
    TreePlan,
    TreeTable,
    check_leaves,
    close_tile,
    single_table,
)

__all__ = ["FUSED_CHUNK", "fused_tree", "fused_tree_plain",
           "fused_reconstruct_apply", "fused_apply_plain", "pad_cohort"]

FUSED_CHUNK = 16

# Elements per row slab of the plain version (bounds its temporaries).
_PLAIN_SLAB_ELEMS = 1 << 22


def pad_cohort(seeds: torch.Tensor, rs: torch.Tensor):
    """Zero-pad (seeds, rs) to a FUSED_CHUNK multiple (exact no-ops)."""
    n, k = rs.shape
    pad = (-n) % FUSED_CHUNK
    if pad:
        seeds = torch.cat([seeds, seeds.new_zeros((pad,))])
        rs = torch.cat([rs, rs.new_zeros((pad, k))])
    return seeds, rs


def fused_apply_plain(x2d: torch.Tensor, seeds: torch.Tensor, rs: torch.Tensor,
                      leaf_tag: int, lo: torch.Tensor, hi: torch.Tensor,
                      distribution: str = "rademacher", masked: bool = False,
                      row_offset: int = 0, col_offset: int = 0,
                      orig_cols: int | None = None,
                      row_slab: int | None = None) -> torch.Tensor:
    """Plain version of the fused kernel on padded, pre-scaled ``rs``.

    ``row_slab`` rows are computed at once (None: enough to keep the
    temporaries near ``_PLAIN_SLAB_ELEMS``).  Every element's value is
    independent of the slab, so the bits do not depend on it.
    """
    rows, cols = x2d.shape
    n_pad, k = rs.shape
    orig_cols = cols if orig_cols is None else orig_cols
    dev = x2d.device
    col = ((torch.arange(cols, dtype=torch.int64, device=dev) + col_offset)
           & U32_MASK)[None, None, :]
    salts = (PROJ_SALT + torch.arange(k, dtype=torch.int64, device=dev)) & U32_MASK
    folded = fold_seed(splitmix32(seeds[:, None] ^ salts[None, :]), leaf_tag)
    slab = (max(1, _PLAIN_SLAB_ELEMS // (FUSED_CHUNK * max(cols, 1)))
            if row_slab is None else int(row_slab))
    if slab < 1:
        raise ValueError(f"row_slab {row_slab} must be positive")
    out = []
    for r0 in range(0, rows, slab):
        r1 = min(r0 + slab, rows)
        row = ((torch.arange(r0, r1, dtype=torch.int64, device=dev) + row_offset)
               & U32_MASK)[None, :, None]
        if masked:
            flat = (row[0].to(torch.float32) * float(orig_cols)
                    + col[0].to(torch.float32))
        acc = torch.zeros((r1 - r0, cols), dtype=torch.float32, device=dev)
        for b in range(k):
            mask = None
            if masked:
                mask = ((flat >= lo[b]) & (flat < hi[b])).to(torch.float32)
            for c in range(0, n_pad, FUSED_CHUNK):
                v = gen_tile(folded[c:c + FUSED_CHUNK, b, None, None], row, col,
                             distribution)
                p = rs[c:c + FUSED_CHUNK, b, None, None] * v
                if mask is not None:
                    p = p * mask
                s = p[0]
                for i in range(1, FUSED_CHUNK):
                    s = s + p[i]
                acc = acc + s
        out.append((x2d[r0:r1].to(torch.float32) + acc).to(x2d.dtype))
    return torch.cat(out) if len(out) > 1 else out[0]


def fused_tree_plain(leaves, seeds: torch.Tensor, rs: torch.Tensor, scale: float,
                     plan: TreePlan, distribution: str = "rademacher",
                     row_slab: int | None = None) -> list:
    """Plain version of a tree close: the cohort scaled and padded once,
    then :func:`fused_apply_plain` entry by entry (``row_slab`` rows at
    once), at the plan's coordinates → the new leaves."""
    rs = rs * torch.tensor(scale, dtype=torch.float32, device=rs.device)
    seeds_p, rs_p = pad_cohort(seeds.to(torch.int64) & U32_MASK, rs)
    out = []
    for group in plan.groups:
        for i in range(group.start, group.stop):
            ll, x = plan.layout[i], leaves[i]
            y = fused_apply_plain(x.reshape(ll.rows, ll.cols), seeds_p, rs_p,
                                  ll.tag, plan.lo[i], plan.hi[i], distribution,
                                  plan.masked, *plan.coords[i], row_slab=row_slab)
            out.append(y.reshape(x.shape))
    return out


def _lib():
    lib = _build.library("reconstruct_apply")
    if not getattr(lib, "_fs_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fs_fused_tree.argtypes = [p, p, p, f, p, p, i, i, i, i, i, p]
        lib.fs_fused_tree.restype = i
        for name in ("fs_fused_chunk", "fs_fused_num_tiles", "fs_fused_table_bytes"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i
        ip = ctypes.POINTER(i)
        lib.fs_fused_tile.argtypes = [i, ip, ip, ip]
        lib.fs_fused_tile.restype = i
        tiles = []
        for t in range(lib.fs_fused_num_tiles()):
            rows, threads, vec = i(), i(), i()
            lib.fs_fused_tile(t, rows, threads, vec)
            tiles.append((rows.value, threads.value, bool(vec.value)))
        if (lib.fs_fused_chunk() != FUSED_CHUNK or tuple(tiles) != CLOSE_TILES
                or lib.fs_fused_table_bytes() != ctypes.sizeof(TreeTable)):
            raise RuntimeError("csrc/reconstruct_apply.cu disagrees on FUSED_CHUNK, "
                               "its tiles or its leaf table")
        lib._fs_typed = True
    return lib


def _launch(table: TreeTable, seeds: torch.Tensor, rs: torch.Tensor, scale: float,
            lo: int | None, hi: int | None, masked: bool, distribution: str,
            tile: tuple, dev: torch.device) -> None:
    n, k = rs.shape
    if dev.type == "meta":           # the dry run: plan and buffers, no launch
        return
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().fs_fused_tree(ctypes.addressof(table), seeds.data_ptr(),
                                   rs.data_ptr(), float(scale), lo, hi, n, k,
                                   int(masked), DIST_CODES[distribution],
                                   CLOSE_TILES.index(tile), stream)
    raise_on_cuda_error("fs_fused_tree", err)
    if table.num_tiles > 0:          # a table of empty leaves launches nothing
        obs.count("close.launches")


def fused_tree(leaves, seeds: torch.Tensor, rs: torch.Tensor, scale: float,
               plan: TreePlan, distribution: str = "rademacher",
               row_slab: int | None = None) -> list:
    """→ the new leaves ``x + Σₙⱼ (scale·rₙⱼ)·vₙⱼ`` of a tree, in leaf order.

    ``leaves`` are the tree's leaves in sorted-key order with the shapes
    and dtypes ``plan`` was made for; ``seeds`` the ``(N,)`` round seeds
    (int64 words), ``rs`` the ``(N, k)`` float32 scalars with every weight
    but ``scale`` folded in.  CUDA tensors take one launch per launch
    group of ``plan``, with the plan's tile (or raise); CPU tensors the
    plain version, ``row_slab`` rows at once.
    """
    dev = rs.device
    if dev.type == "cpu":
        return fused_tree_plain(leaves, seeds, rs, scale, plan, distribution,
                                row_slab)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {dev}")
    _, k = check_cohort(seeds, rs, distribution, dev)
    check_leaves(plan, leaves, k, dev)
    out = [torch.empty_like(leaf) for leaf in leaves]
    row_bytes = 4 * plan.k
    for group in plan.groups:
        sl = slice(group.start, group.stop)
        _launch(group.table(leaves[sl], out[sl]), seeds, rs, scale,
                plan.lo.data_ptr() + group.start * row_bytes,
                plan.hi.data_ptr() + group.start * row_bytes, plan.masked,
                distribution, plan.tile, dev)
    return out


def fused_reconstruct_apply(x2d: torch.Tensor, seeds: torch.Tensor,
                            rs: torch.Tensor, leaf_tag: int, scale: float,
                            distribution: str = "rademacher",
                            lo: torch.Tensor | None = None,
                            hi: torch.Tensor | None = None,
                            masked: bool = False, row_offset: int = 0,
                            col_offset: int = 0,
                            orig_cols: int | None = None, block=None,
                            row_slab: int | None = None) -> torch.Tensor:
    """→ ``x + Σₙⱼ (scale·rₙⱼ)·vₙⱼ`` for one leaf's 2-D view (shape/dtype of x2d).

    ``seeds`` are the ``(N,)`` round seeds (int64 words), ``rs`` the
    ``(N,)`` or ``(N, k)`` float32 scalars; ``x2d`` is float32 or bf16.
    A CUDA tensor launches the kernel on a one-leaf table with the tile
    ``block`` (``tree.close_tile``; None: the default) or raises; a CPU
    tensor takes the plain version, ``row_slab`` rows at once.
    """
    tile = close_tile(block)
    rs = rs.to(torch.float32)
    if rs.dim() == 1:
        rs = rs[:, None]
    n, k = rs.shape
    rows, cols = x2d.shape
    if (lo is None or hi is None) and masked:
        raise ValueError("masked k-block calls must pass leaf-local lo/hi")
    if x2d.device.type == "cpu":
        if lo is None or hi is None:
            lo = torch.zeros((k,), dtype=torch.float32)
            hi = torch.full((k,), float(rows) * float(cols), dtype=torch.float32)
        # Spec line 1: fold the scale into the scalars, so the apply is a bare add.
        rs = rs * torch.tensor(scale, dtype=torch.float32)
        seeds_p, rs_p = pad_cohort(seeds.to(torch.int64) & U32_MASK, rs)
        return fused_apply_plain(x2d, seeds_p, rs_p, leaf_tag, lo, hi,
                                 distribution, masked, row_offset, col_offset,
                                 orig_cols, row_slab)
    if x2d.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {x2d.device}")
    dev = x2d.device
    check_cuda_tensor("x2d", x2d, LEAF_DTYPES, 2, dev)
    rs = rs.contiguous()
    check_cohort(seeds, rs, distribution, dev)
    if masked:
        check_cuda_tensor("lo", lo, torch.float32, 1, dev)
        check_cuda_tensor("hi", hi, torch.float32, 1, dev)
        if lo.numel() != k or hi.numel() != k:
            raise ValueError(f"lo {lo.numel()} / hi {hi.numel()} / rs "
                             f"{tuple(rs.shape)} disagree")
    y = torch.empty_like(x2d)
    table = single_table("close", x2d, rows, cols,
                         cols if orig_cols is None else orig_cols, leaf_tag,
                         row_offset, col_offset, y, tile=tile)
    _launch(table, seeds, rs, scale, lo.data_ptr() if masked else None,
            hi.data_ptr() if masked else None, masked, distribution, tile, dev)
    return y

