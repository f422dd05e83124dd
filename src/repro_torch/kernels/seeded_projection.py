"""Client encode r[n, j] = ⟨x_n · 𝟙[block j], v_j(ξ_n)⟩ for every client of a round.

Port of ``repro/kernels/seeded_projection.py::_proj_kernel``.  The CUDA
kernel is ``csrc/seeded_projection.cu`` (its note gives the design and
the bound); this module holds its plain PyTorch version and the wrappers.

:func:`project_tree` encodes a whole tree in one launch (plus one
fixed-order reduction launch; a tree of more than
``tree.MAX_TREE_LEAVES`` leaves takes a pair per group of leaves):
every leaf is ``(N, *shape)`` float32 or bf16 (read as float32, as the
reference's ``x.astype(float32)``), ``seeds`` the ``(N,)`` round seeds
as int64 words, and the result float32 ``(N, k)``, the leaves summed in
sorted-key order.  :func:`project_blocks` is the same kernel on one
leaf's ``(N, rows, cols)`` view.  Per-block seeds are
``fold_seed(block_seed(seed, j), leaf_tag)``; ``lo``/``hi`` are
leaf-local flat bounds (float32, ``k`` per leaf) applied only when
``masked`` (BLOCK mode with k > 1).  The sum order within a leaf is not
part of the contract: kernel and plain version agree within a
tolerance, and the kernel gives the same bits run after run.  The plain
version can sum in float64 (``dtype``), which gives the exact value to
hold the kernel's float32 sum against.

The counter ``encode.launches`` (:mod:`repro_torch.obs`) counts kernel
launches, two per tree group
(``project_tree_kernel`` and ``sum_tree_partials_kernel``) and two per
:func:`project_blocks` call.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import obs
from repro_torch.core.prng import U32_MASK, block_seed
from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    DIST_CODES,
    LEAF_DTYPES,
    check_cuda_tensor,
    fold_seed,
    gen_tile,
    raise_on_cuda_error,
)
from repro_torch.kernels.tree import (
    ENCODE_TILE_ROWS,
    TreePlan,
    TreeTable,
    single_table,
)

__all__ = ["project_blocks", "project_blocks_plain", "project_tree",
           "project_tree_plain", "encode_tolerance", "tree_encode_tolerance"]

# Elements per client group in the plain version (bounds its temporaries).
_PLAIN_GROUP_ELEMS = 1 << 22
# seeded_projection.cu's TILE_ROWS and THREADS / 32.
_TILE_ROWS, _WARPS = ENCODE_TILE_ROWS, 8
# Largest |v| of each family (gaussian: Box–Muller from 32-bit uniforms).
VMAX = {"rademacher": 1.0, "hadamard": 1.0, "sparse_rademacher": 2.0,
        "gaussian": 6.7}


def encode_tolerance(x: torch.Tensor, distribution: str) -> torch.Tensor:
    """Bound on |kernel r − exact r| per client: ``4·2⁻²³·√h·‖x‖₂·max|v|``, ``(N, 1)``.

    ``h`` is the longest chain of float32 roundings in the kernel's sum
    for one (client, block): the product, one accumulator's sequential
    sum over a lane's columns (the lane alternates two accumulators, half
    of its columns each) and rows of a tile, joining the two, the warp
    butterfly, the warp sums and the second pass over the tiles.  A lane
    takes 16 bytes of a row at a time (4 float32 or 8 bf16 values), so
    its share of a row is counted in whole vectors.  Roundings of random
    sign add up as a random walk, so the error stays near
    ``2⁻²⁴·√(h/3)·‖x∘v‖₂``; the bound is about 14 of those.  Dropping one
    row of ``x`` moves r by about ``√cols`` times the entries' size, far
    more than the bound.
    """
    n, rows, cols = x.shape
    vec = 8 if x.dtype == torch.bfloat16 else 4
    tiles = -(-rows // _TILE_ROWS)
    per_row = vec * -(-cols // (32 * vec))
    lane = -(-per_row // 2) * -(-min(rows, _TILE_ROWS) // _WARPS) + 1
    h = 1 + lane + 5 + (_WARPS - 1) + -(-tiles // 32) + 5
    norm = torch.linalg.vector_norm(x.to(torch.float64).reshape(n, -1), dim=1)
    return (4 * 2.0 ** -23 * h ** 0.5 * VMAX[distribution] * norm)[:, None]


def tree_encode_tolerance(leaves, distribution: str) -> torch.Tensor:
    """Bound on |tree-encode r − exact r|, ``(N, 1)``: every leaf's
    :func:`encode_tolerance` (``leaves`` as ``(N, rows, cols)`` views),
    plus the running sum over the leaves, one rounding per leaf after the
    first, each at most 2⁻²⁴ of a partial sum, which ‖x‖₁·max|v| bounds."""
    tol = sum(encode_tolerance(x, distribution) for x in leaves)
    l1 = sum(x.to(torch.float64).abs().reshape(x.shape[0], -1).sum(dim=1)
             for x in leaves)
    return tol + (2.0 ** -24 * (len(leaves) - 1) * VMAX[distribution] * l1)[:, None]


def project_blocks_plain(x: torch.Tensor, seeds: torch.Tensor, leaf_tag: int,
                         lo: torch.Tensor, hi: torch.Tensor,
                         distribution: str = "rademacher", masked: bool = False,
                         row_offset: int = 0, col_offset: int = 0,
                         orig_cols: int | None = None,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of the encode kernel: → ``(N, k)`` in ``dtype``.

    Products and sums are taken in ``dtype``; ``v`` is float32 either way.
    A leaf of more than ``_PLAIN_GROUP_ELEMS`` elements is summed in row
    slabs of at most that many elements, one client at a time (bounds the
    temporaries of a leaf past 2³¹ elements), each slab's sum added in
    row order.
    """
    n, rows, cols = x.shape
    k = lo.numel()
    orig_cols = cols if orig_cols is None else orig_cols
    group = max(1, _PLAIN_GROUP_ELEMS // max(rows * cols, 1))
    slab = rows if group > 1 else max(1, _PLAIN_GROUP_ELEMS // max(cols, 1))
    out = torch.zeros((n, k), dtype=dtype, device=x.device)
    col = ((torch.arange(cols, dtype=torch.int64, device=x.device) + col_offset)
           & U32_MASK)[None, :]
    for r0 in range(0, rows, slab):
        r1 = min(r0 + slab, rows)
        row = ((torch.arange(r0, r1, dtype=torch.int64, device=x.device)
                + row_offset) & U32_MASK)[:, None]
        if masked:
            flat = row.to(torch.float32) * float(orig_cols) + col.to(torch.float32)
        xf = x[:, r0:r1].to(torch.float32).to(dtype)
        for j in range(k):
            folded = fold_seed(block_seed(seeds, j), leaf_tag)
            if masked:
                mask = ((flat >= lo[j]) & (flat < hi[j])).to(dtype)
            for g in range(0, n, group):
                v = gen_tile(folded[g:g + group, None, None], row, col, distribution)
                contrib = xf[g:g + group] * v.to(dtype)
                if masked:
                    contrib = contrib * mask
                s = contrib.sum(dim=(1, 2))
                out[g:g + group, j] = s if r0 == 0 else out[g:g + group, j] + s
    return out


def project_tree_plain(leaves, seeds: torch.Tensor, plan: TreePlan,
                       distribution: str = "rademacher",
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of a tree encode: the per-entry plain encodes of
    ``leaves`` (each ``(N, *shape)``, ``plan``'s layout, at its
    coordinates) summed in entry order, launch group by launch group as
    the kernel goes → ``(N, k)``."""
    acc = None
    for group in plan.groups:
        for i in range(group.start, group.stop):
            ll = plan.layout[i]
            x3d = leaves[i].reshape(leaves[i].shape[0], ll.rows, ll.cols)
            r = project_blocks_plain(x3d, seeds, ll.tag, plan.lo[i], plan.hi[i],
                                     distribution, plan.masked, *plan.coords[i],
                                     dtype=dtype)
            acc = r if acc is None else acc + r
    return acc


def _lib():
    lib = _build.library("seeded_projection")
    if not getattr(lib, "_fs_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fs_project_tree.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
        lib.fs_project_tree.restype = i
        for name in ("fs_project_tile_rows", "fs_tree_table_bytes"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i
        if (lib.fs_project_tile_rows() != _TILE_ROWS
                or lib.fs_tree_table_bytes() != ctypes.sizeof(TreeTable)):
            raise RuntimeError("csrc/seeded_projection.cu disagrees on its tile "
                               "or its leaf table")
        lib._fs_typed = True
    return lib


def _check_launch(n: int, k: int, distribution: str) -> None:
    if not (0 < n <= 65535 and 0 < k <= 65535) or n * k * 32 >= 1 << 31:
        raise ValueError(f"cohort {n} x blocks {k} exceeds the launch grid")
    if distribution not in DIST_CODES:
        raise ValueError(f"unknown distribution {distribution!r}")


def _launch(table: TreeTable, seeds: torch.Tensor, lo: int | None,
            hi: int | None, out: torch.Tensor, n: int, k: int, masked: bool,
            distribution: str, accumulate: bool) -> None:
    """One tree launch: the tile kernel and the reduction into ``out``."""
    dev = out.device
    partials = torch.empty((n, k, max(table.num_tiles, 1)), dtype=torch.float32,
                           device=dev)
    if dev.type == "meta":           # the dry run: plan and buffers, no launch
        return
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().fs_project_tree(
            ctypes.addressof(table), seeds.data_ptr(), lo, hi, partials.data_ptr(),
            out.data_ptr(), n, k, int(masked), DIST_CODES[distribution],
            int(accumulate), stream)
    raise_on_cuda_error("fs_project_tree", err)
    # project_tree_kernel (not launched for a table with no tiles) and
    # sum_tree_partials_kernel
    obs.count("encode.launches", 2 if table.num_tiles > 0 else 1)


def project_tree(leaves, seeds: torch.Tensor, plan: TreePlan,
                 distribution: str = "rademacher") -> torch.Tensor:
    """Encode every client's tree: → float32 ``(N, k)``.

    ``leaves`` are the tree's leaves in sorted-key order, each ``(N,
    *shape)`` with the shapes and dtypes ``plan`` was made for.  CUDA
    tensors take one tree launch per launch group of ``plan`` (or raise);
    CPU tensors the plain version.
    """
    dev = seeds.device
    if dev.type == "cpu":
        return project_tree_plain(leaves, seeds, plan, distribution)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {dev}")
    n, k = seeds.shape[0], plan.k
    check_cuda_tensor("seeds", seeds, torch.int64, 1, dev)
    _check_launch(n, k, distribution)
    for leaf, dtype in zip(leaves, plan.dtypes):
        if leaf.device != dev or leaf.dtype != dtype or not leaf.is_contiguous():
            raise ValueError(f"leaf {tuple(leaf.shape)} {leaf.dtype} on "
                             f"{leaf.device} does not fit the plan ({dtype}, "
                             f"contiguous, on {dev})")
        if leaf.shape[0] != n:
            raise ValueError(f"leaf {tuple(leaf.shape)} does not lead with the "
                             f"{n} clients")
    out = torch.empty((n, k), dtype=torch.float32, device=dev)
    row_bytes = 4 * k
    for g, group in enumerate(plan.groups):
        _launch(group.table(leaves[group.start:group.stop]), seeds,
                plan.lo.data_ptr() + group.start * row_bytes,
                plan.hi.data_ptr() + group.start * row_bytes, out, n, k,
                plan.masked, distribution, accumulate=g > 0)
    return out


def project_blocks(x: torch.Tensor, seeds: torch.Tensor, leaf_tag: int,
                   lo: torch.Tensor, hi: torch.Tensor,
                   distribution: str = "rademacher", masked: bool = False,
                   row_offset: int = 0, col_offset: int = 0,
                   orig_cols: int | None = None) -> torch.Tensor:
    """Encode every client's leaf: → float32 ``(N, k)``.

    A CUDA tensor launches the kernel on a one-leaf table (or raises); a
    CPU tensor takes the plain version.
    """
    if x.device.type == "cpu":
        return project_blocks_plain(x, seeds, leaf_tag, lo, hi, distribution,
                                    masked, row_offset, col_offset, orig_cols)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {x.device}")
    dev = x.device
    check_cuda_tensor("x", x, LEAF_DTYPES, 3, dev)
    check_cuda_tensor("seeds", seeds, torch.int64, 1, dev)
    check_cuda_tensor("lo", lo, torch.float32, 1, dev)
    check_cuda_tensor("hi", hi, torch.float32, 1, dev)
    n, rows, cols = x.shape
    k = lo.numel()
    if seeds.numel() != n or hi.numel() != k:
        raise ValueError(f"seeds {tuple(seeds.shape)} / lo {k} / hi "
                         f"{hi.numel()} do not match x {tuple(x.shape)}")
    _check_launch(n, k, distribution)
    table = single_table("encode", x, rows, cols,
                         cols if orig_cols is None else orig_cols, leaf_tag,
                         row_offset, col_offset)
    out = torch.empty((n, k), dtype=torch.float32, device=dev)
    _launch(table, seeds, lo.data_ptr(), hi.data_ptr(), out, n, k, masked,
            distribution, accumulate=False)
    return out

