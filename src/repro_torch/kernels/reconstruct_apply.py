"""Fused server close y = x + Σ_b Σ_chunks leftfold₁₆((r·v)·mask_b) — one pass per leaf.

Port of ``repro/kernels/reconstruct_apply.py::_fused_kernel``.  The CUDA
kernel is ``csrc/reconstruct_apply.cu``; this module holds its plain
PyTorch version (the fused spec written out) and the wrapper.

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
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.prng import PROJ_SALT, U32_MASK, splitmix32
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

__all__ = ["FUSED_CHUNK", "fused_reconstruct_apply", "fused_apply_plain",
           "pad_cohort"]

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
                      orig_cols: int | None = None) -> torch.Tensor:
    """Plain version of the fused kernel on padded, pre-scaled ``rs``.

    Row slabs only bound memory: every element's value is independent of
    the slab, so the bits do not depend on it.
    """
    rows, cols = x2d.shape
    n_pad, k = rs.shape
    orig_cols = cols if orig_cols is None else orig_cols
    dev = x2d.device
    col = ((torch.arange(cols, dtype=torch.int64, device=dev) + col_offset)
           & U32_MASK)[None, None, :]
    salts = (PROJ_SALT + torch.arange(k, dtype=torch.int64, device=dev)) & U32_MASK
    folded = fold_seed(splitmix32(seeds[:, None] ^ salts[None, :]), leaf_tag)
    slab = max(1, _PLAIN_SLAB_ELEMS // (FUSED_CHUNK * max(cols, 1)))
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


def _lib():
    lib = _build.library("reconstruct_apply")
    if not getattr(lib, "_fs_typed", False):
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        lib.fs_fused_apply.argtypes = [p, p, p, p, p, p, i, i, i, i, u, u, u, i, i,
                                       i, i, p]
        lib.fs_fused_apply.restype = i
        for name in ("fs_fused_chunk", "fs_fused_max_rows"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i
        if lib.fs_fused_chunk() != FUSED_CHUNK:
            raise RuntimeError("csrc/reconstruct_apply.cu disagrees on FUSED_CHUNK")
        lib._fs_typed = True
    return lib


def fused_reconstruct_apply(x2d: torch.Tensor, seeds: torch.Tensor,
                            rs: torch.Tensor, leaf_tag: int, scale: float,
                            distribution: str = "rademacher",
                            lo: torch.Tensor | None = None,
                            hi: torch.Tensor | None = None,
                            masked: bool = False, row_offset: int = 0,
                            col_offset: int = 0,
                            orig_cols: int | None = None) -> torch.Tensor:
    """→ ``x + Σₙⱼ (scale·rₙⱼ)·vₙⱼ`` for one leaf's 2-D view (shape/dtype of x2d).

    ``seeds`` are the ``(N,)`` round seeds (int64 words), ``rs`` the
    ``(N,)`` or ``(N, k)`` float32 scalars; ``x2d`` is float32 or bf16.
    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version.
    ``fused_reconstruct_apply.launches`` counts kernel launches.
    """
    rs = rs.to(torch.float32)
    if rs.dim() == 1:
        rs = rs[:, None]
    # Spec line 1: fold the scale into the scalars, so the apply is a bare add.
    rs = rs * torch.tensor(scale, dtype=torch.float32, device=rs.device)
    n, k = rs.shape
    rows, cols = x2d.shape
    if lo is None or hi is None:
        if masked:
            raise ValueError("masked k-block calls must pass leaf-local lo/hi")
        lo = torch.zeros((k,), dtype=torch.float32, device=x2d.device)
        hi = torch.full((k,), float(rows) * float(cols), dtype=torch.float32,
                        device=x2d.device)
    seeds_p, rs_p = pad_cohort(seeds.to(torch.int64) & U32_MASK, rs)
    if x2d.device.type == "cpu":
        return fused_apply_plain(x2d, seeds_p, rs_p, leaf_tag, lo, hi,
                                 distribution, masked, row_offset, col_offset,
                                 orig_cols)
    if x2d.device.type != "cuda":
        raise ValueError(f"unsupported device {x2d.device}")
    dev = x2d.device
    check_cuda_tensor("x2d", x2d, LEAF_DTYPES, 2, dev)
    check_cuda_tensor("seeds", seeds_p, torch.int64, 1, dev)
    rs_p = rs_p.contiguous()
    check_cuda_tensor("rs", rs_p, torch.float32, 2, dev)
    check_cuda_tensor("lo", lo, torch.float32, 1, dev)
    check_cuda_tensor("hi", hi, torch.float32, 1, dev)
    if seeds.numel() != n or lo.numel() != k or hi.numel() != k:
        raise ValueError(f"seeds {seeds.numel()} / rs {tuple(rs.shape)} / "
                         f"lo {lo.numel()} / hi {hi.numel()} disagree")
    if distribution not in DIST_CODES:
        raise ValueError(f"unknown distribution {distribution!r}")
    lib = _lib()
    if rows > lib.fs_fused_max_rows():
        raise ValueError(f"{rows} rows exceed the kernel's launch grid")
    y = torch.empty_like(x2d)
    seeds32 = seeds_as_u32_bits(seeds_p)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fs_fused_apply(
            x2d.data_ptr(), seeds32.data_ptr(), rs_p.data_ptr(), lo.data_ptr(),
            hi.data_ptr(), y.data_ptr(), rs_p.shape[0], k, rows, cols,
            leaf_tag & U32_MASK, row_offset & U32_MASK, col_offset & U32_MASK,
            cols if orig_cols is None else orig_cols, int(masked),
            DIST_CODES[distribution], LEAF_DTYPES[x2d.dtype], stream)
    raise_on_cuda_error("fs_fused_apply", err)
    fused_reconstruct_apply.launches += 1
    return y


fused_reconstruct_apply.launches = 0
