"""Client encode r[n, j] = ⟨x_n · 𝟙[block j], v_j(ξ_n)⟩ for every client of a round.

Port of ``repro/kernels/seeded_projection.py::_proj_kernel``.  The CUDA
kernel is ``csrc/seeded_projection.cu`` (its note gives the design and
the bound); this module holds its plain PyTorch version and the wrapper.

One call covers one leaf for all N clients: ``x`` is ``(N, rows, cols)``
float32 or bf16 (read as float32, as the reference's ``x.astype(float32)``),
``seeds`` the ``(N,)`` round seeds as int64 words, and the result is
float32 ``(N, k)`` — the reference's per-client call under
``vmap``.  Per-block seeds are ``fold_seed(block_seed(seed, j), leaf_tag)``;
``lo``/``hi`` are leaf-local flat bounds (float32 ``(k,)``) applied only
when ``masked`` (BLOCK mode with k > 1).  The sum order is not part of
the contract: kernel and plain version agree within a tolerance, and the
kernel gives the same bits run after run.  The plain version can sum in
float64 (``dtype``), which gives the exact value to hold the kernel's
float32 sum against.

Each kernel call launches two ``__global__`` functions, ``project_kernel``
(per-tile partial sums) and ``sum_partials_kernel`` (their fixed-order
sum); ``project_blocks.launches`` counts both.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.prng import U32_MASK, block_seed
from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    DIST_CODES,
    LEAF_DTYPES,
    check_cuda_tensor,
    fold_seed,
    gen_tile,
    raise_on_cuda_error,
    seeds_as_u32_bits,
)

__all__ = ["project_blocks", "project_blocks_plain", "encode_tolerance"]

# Elements per client group in the plain version (bounds its temporaries).
_PLAIN_GROUP_ELEMS = 1 << 22
# seeded_projection.cu's TILE_ROWS and THREADS / 32.
_TILE_ROWS, _WARPS = 32, 8
# Largest |v| of each family (gaussian: Box–Muller from 32-bit uniforms).
VMAX = {"rademacher": 1.0, "hadamard": 1.0, "sparse_rademacher": 2.0,
        "gaussian": 6.7}


def encode_tolerance(x: torch.Tensor, distribution: str) -> torch.Tensor:
    """Bound on |kernel r − exact r| per client: ``4·2⁻²³·√h·‖x‖₂·max|v|``, ``(N, 1)``.

    ``h`` is the longest chain of float32 roundings in the kernel's sum
    for one (client, block): the product, one lane's sequential sum over
    its rows and columns of a tile, the warp butterfly, the warp sums and
    the second pass over the tiles.  Roundings of random sign add up as a
    random walk, so the error stays near ``2⁻²⁴·√(h/3)·‖x∘v‖₂``; the bound
    is about 14 of those.  Dropping one row of ``x`` moves r by about
    ``√cols`` times the entries' size, far more than the bound.
    """
    n, rows, cols = x.shape
    tiles = -(-rows // _TILE_ROWS)
    lane = -(-cols // 32) * -(-min(rows, _TILE_ROWS) // _WARPS)
    h = 1 + lane + 5 + (_WARPS - 1) + -(-tiles // 32) + 5
    norm = torch.linalg.vector_norm(x.to(torch.float64).reshape(n, -1), dim=1)
    return (4 * 2.0 ** -23 * h ** 0.5 * VMAX[distribution] * norm)[:, None]


def project_blocks_plain(x: torch.Tensor, seeds: torch.Tensor, leaf_tag: int,
                         lo: torch.Tensor, hi: torch.Tensor,
                         distribution: str = "rademacher", masked: bool = False,
                         row_offset: int = 0, col_offset: int = 0,
                         orig_cols: int | None = None,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of the encode kernel: → ``(N, k)`` in ``dtype``.

    Products and sums are taken in ``dtype``; ``v`` is float32 either way.
    """
    n, rows, cols = x.shape
    k = lo.numel()
    orig_cols = cols if orig_cols is None else orig_cols
    row = ((torch.arange(rows, dtype=torch.int64, device=x.device) + row_offset)
           & U32_MASK)[:, None]
    col = ((torch.arange(cols, dtype=torch.int64, device=x.device) + col_offset)
           & U32_MASK)[None, :]
    if masked:
        flat = row.to(torch.float32) * float(orig_cols) + col.to(torch.float32)
    group = max(1, _PLAIN_GROUP_ELEMS // max(rows * cols, 1))
    xf = x.to(torch.float32).to(dtype)
    out = torch.empty((n, k), dtype=dtype, device=x.device)
    for j in range(k):
        folded = fold_seed(block_seed(seeds, j), leaf_tag)
        if masked:
            mask = ((flat >= lo[j]) & (flat < hi[j])).to(dtype)
        for g in range(0, n, group):
            v = gen_tile(folded[g:g + group, None, None], row, col, distribution)
            contrib = xf[g:g + group] * v.to(dtype)
            if masked:
                contrib = contrib * mask
            out[g:g + group, j] = contrib.sum(dim=(1, 2))
    return out


def _lib():
    lib = _build.library("seeded_projection")
    if not getattr(lib, "_fs_typed", False):
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        lib.fs_project.argtypes = [p, p, p, p, p, p, i, i, i, i, u, u, u, i, i, i,
                                   i, p]
        lib.fs_project.restype = i
        lib.fs_project_tile_rows.argtypes = []
        lib.fs_project_tile_rows.restype = i
        lib._fs_typed = True
    return lib


def project_blocks(x: torch.Tensor, seeds: torch.Tensor, leaf_tag: int,
                   lo: torch.Tensor, hi: torch.Tensor,
                   distribution: str = "rademacher", masked: bool = False,
                   row_offset: int = 0, col_offset: int = 0,
                   orig_cols: int | None = None) -> torch.Tensor:
    """Encode every client's leaf: → float32 ``(N, k)``.

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version.  ``project_blocks.launches`` counts kernel launches,
    two per call.
    """
    if x.device.type == "cpu":
        return project_blocks_plain(x, seeds, leaf_tag, lo, hi, distribution,
                                    masked, row_offset, col_offset, orig_cols)
    if x.device.type != "cuda":
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
    if not (0 < n <= 65535 and 0 < k <= 65535) or n * k * 32 >= 1 << 31:
        raise ValueError(f"cohort {n} x blocks {k} exceeds the launch grid")
    if distribution not in DIST_CODES:
        raise ValueError(f"unknown distribution {distribution!r}")
    lib = _lib()
    tiles = -(-rows // lib.fs_project_tile_rows())
    partials = torch.empty((n, k, tiles), dtype=torch.float32, device=dev)
    out = torch.empty((n, k), dtype=torch.float32, device=dev)
    seeds32 = seeds_as_u32_bits(seeds)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fs_project(
            x.data_ptr(), seeds32.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            partials.data_ptr(), out.data_ptr(), n, k, rows, cols,
            leaf_tag & U32_MASK, row_offset & U32_MASK, col_offset & U32_MASK,
            cols if orig_cols is None else orig_cols, int(masked),
            DIST_CODES[distribution], LEAF_DTYPES[x.dtype], stream)
    raise_on_cuda_error("fs_project", err)
    project_blocks.launches += 2     # project_kernel, sum_partials_kernel
    return out


project_blocks.launches = 0
