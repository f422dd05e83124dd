"""Per-client server decode y = x + scale·Σ_b Σ_n r[n,b]·(v[n,b]·mask_b) — one pass per leaf.

Port of ``repro/kernels/seeded_reconstruct.py::_rec_kernel``.  The CUDA
kernel is ``csrc/seeded_reconstruct.cu``; this module holds its plain
PyTorch version (the reference's arithmetic written out) and the wrapper.

The numeric spec is the reference kernel's, float32 throughout::

    pad the cohort with zero seeds and zero scalars to a multiple of
      min(CLIENT_CHUNK, N)                     (exact no-ops)
    acc = 0
    for block b = 0..k−1, then client n = 0..N_pad−1, in order:
      v = v_{n,b}(row, col)                    (per-block seed
                                                splitmix32(ξ ^ (PROJ_SALT + b)),
                                                folded with the leaf tag)
      v = v · mask_b                           (BLOCK mode only)
      acc = acc + r[n,b] · v
    y = x + scale · acc                        (x read as float32, y cast
                                                once to x's dtype)

With ``per_client_rounding`` (the LLM train step's close, the reference's
``server_aggregate`` on bf16 leaves) the clients come first::

    for client n = 0..N−1, in order:
      part = 0;  part = part + r[n,b] · (v_{n,b} · mask_b)  for b = 0..k−1
      acc  = acc + f32(round_to_x_dtype(part))
    y = x + scale · (acc / div)                (scale = server_lr, div = N,
                                                or 1 with weights)

which is the port's ``core.fedscalar.server_aggregate`` bit for bit for
the ±1/±2 families.

Unlike the fused close (:mod:`reconstruct_apply`) the clients are added
one by one and the scale is applied once at the end, so the two agree
within a tolerance, not bitwise.  The reference's fori oracle
(``ref.server_update_ref``) takes p + lr·(Σ/n) instead and is close, not
equal.  Each element's value depends only on its own chain, so row slabs
of the plain version and the kernel's tile skipping leave the bits alone.
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
)

__all__ = ["CLIENT_CHUNK", "reconstruct_apply_clients", "reconstruct_plain",
           "pad_clients"]

CLIENT_CHUNK = 32

# Elements per row slab of the plain version (bounds its temporaries).
_PLAIN_SLAB_ELEMS = 1 << 22


def pad_clients(seeds: torch.Tensor, rs: torch.Tensor):
    """Zero-pad (seeds, rs) to a multiple of ``min(CLIENT_CHUNK, N)``."""
    n, k = rs.shape
    pad = (-n) % min(CLIENT_CHUNK, max(n, 1))
    if pad:
        seeds = torch.cat([seeds, seeds.new_zeros((pad,))])
        rs = torch.cat([rs, rs.new_zeros((pad, k))])
    return seeds, rs


def reconstruct_plain(x2d: torch.Tensor, seeds: torch.Tensor, rs: torch.Tensor,
                      leaf_tag: int, scale: float, lo: torch.Tensor | None,
                      hi: torch.Tensor | None, distribution: str = "rademacher",
                      masked: bool = False, row_offset: int = 0,
                      col_offset: int = 0, orig_cols: int | None = None,
                      per_client_rounding: bool = False,
                      div: float = 1.0) -> torch.Tensor:
    """Plain version of the kernel on ``(N,)`` int64 seeds and ``(N, k)`` rs."""
    rows, cols = x2d.shape
    seeds, rs = pad_clients(seeds.to(torch.int64) & U32_MASK,
                            rs.to(torch.float32))
    n_pad, k = rs.shape
    orig_cols = cols if orig_cols is None else orig_cols
    dev = x2d.device
    col = ((torch.arange(cols, dtype=torch.int64, device=dev) + col_offset)
           & U32_MASK)[None, None, :]
    salts = (PROJ_SALT + torch.arange(k, dtype=torch.int64, device=dev)) & U32_MASK
    folded = fold_seed(splitmix32(seeds[:, None] ^ salts[None, :]), leaf_tag)
    scale_f = torch.tensor(scale, dtype=torch.float32, device=dev)
    div_f = torch.tensor(div, dtype=torch.float32, device=dev)
    slab = max(1, _PLAIN_SLAB_ELEMS // (CLIENT_CHUNK * max(cols, 1)))
    out = []
    for r0 in range(0, rows, slab):
        r1 = min(r0 + slab, rows)
        row = ((torch.arange(r0, r1, dtype=torch.int64, device=dev) + row_offset)
               & U32_MASK)[None, :, None]
        masks = [None] * k
        if masked:
            flat = (row[0].to(torch.float32) * float(orig_cols)
                    + col[0].to(torch.float32))
            masks = [((flat >= lo[b]) & (flat < hi[b])).to(torch.float32)
                     for b in range(k)]
        acc = torch.zeros((r1 - r0, cols), dtype=torch.float32, device=dev)
        if not per_client_rounding:
            for b in range(k):
                for c in range(0, n_pad, CLIENT_CHUNK):
                    v = gen_tile(folded[c:c + CLIENT_CHUNK, b, None, None], row,
                                 col, distribution)
                    if masks[b] is not None:
                        v = v * masks[b]
                    p = rs[c:c + CLIENT_CHUNK, b, None, None] * v
                    for i in range(p.shape[0]):
                        acc = acc + p[i]
            y = x2d[r0:r1].to(torch.float32) + scale_f * acc
        else:
            for c in range(0, n_pad, CLIENT_CHUNK):
                part = torch.zeros((min(CLIENT_CHUNK, n_pad - c), r1 - r0, cols),
                                   dtype=torch.float32, device=dev)
                for b in range(k):
                    v = gen_tile(folded[c:c + CLIENT_CHUNK, b, None, None], row,
                                 col, distribution)
                    if masks[b] is not None:
                        v = v * masks[b]
                    part = part + rs[c:c + CLIENT_CHUNK, b, None, None] * v
                part = part.to(x2d.dtype).to(torch.float32)
                for i in range(part.shape[0]):
                    acc = acc + part[i]
            y = x2d[r0:r1].to(torch.float32) + scale_f * (acc / div_f)
        out.append(y.to(x2d.dtype))
    return torch.cat(out) if len(out) > 1 else out[0]


def _lib():
    lib = _build.library("seeded_reconstruct")
    if not getattr(lib, "_fs_typed", False):
        p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
        lib.fs_rec_apply.argtypes = [p, p, p, f, f, p, p, p, i, i, i, i, u, u, u, i,
                                     i, i, i, i, p]
        lib.fs_rec_apply.restype = i
        lib.fs_rec_chunk.argtypes = []
        lib.fs_rec_chunk.restype = i
        if lib.fs_rec_chunk() != CLIENT_CHUNK:
            raise RuntimeError("csrc/seeded_reconstruct.cu disagrees on CLIENT_CHUNK")
        lib._fs_typed = True
    return lib


def reconstruct_apply_clients(x2d: torch.Tensor, seeds: torch.Tensor,
                              rs: torch.Tensor, leaf_tag: int, scale: float,
                              distribution: str = "rademacher",
                              lo: torch.Tensor | None = None,
                              hi: torch.Tensor | None = None,
                              masked: bool = False, row_offset: int = 0,
                              col_offset: int = 0,
                              orig_cols: int | None = None,
                              per_client_rounding: bool = False,
                              div: float = 1.0) -> torch.Tensor:
    """→ ``x + scale·Σₙⱼ rₙⱼ·vₙⱼ`` for one leaf's 2-D view (shape/dtype of x2d).

    ``x2d`` is float32 or bf16 on the card (any float dtype on the CPU).

    ``seeds`` are the ``(N,)`` round seeds (int64 words, unfolded), ``rs``
    the ``(N,)`` or ``(N, k)`` float32 scalars with every aggregation
    weight already folded in; ``lo``/``hi`` the ``(k,)`` leaf-local block
    bounds, needed only when ``masked``.  ``per_client_rounding`` takes
    the train step's close, ``x + scale·(Σₙ round(Σⱼ rₙⱼ·vₙⱼ) / div)``.
    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version.  ``reconstruct_apply_clients.launches`` counts kernel
    launches.
    """
    rs = rs.to(torch.float32)
    if rs.dim() == 1:
        rs = rs[:, None]
    n, k = rs.shape
    rows, cols = x2d.shape
    if masked and (lo is None or hi is None):
        raise ValueError("masked k-block calls must pass leaf-local lo/hi")
    if x2d.device.type == "cpu":
        return reconstruct_plain(x2d, seeds, rs, leaf_tag, scale, lo, hi,
                                 distribution, masked, row_offset, col_offset,
                                 orig_cols, per_client_rounding, div)
    if x2d.device.type != "cuda":
        raise ValueError(f"unsupported device {x2d.device}")
    dev = x2d.device
    check_cuda_tensor("x2d", x2d, LEAF_DTYPES, 2, dev)
    check_cuda_tensor("seeds", seeds, torch.int64, 1, dev)
    rs = rs.contiguous()
    check_cuda_tensor("rs", rs, torch.float32, 2, dev)
    if masked:
        check_cuda_tensor("lo", lo, torch.float32, 1, dev)
        check_cuda_tensor("hi", hi, torch.float32, 1, dev)
        if lo.numel() != k or hi.numel() != k:
            raise ValueError(f"lo {lo.numel()} / hi {hi.numel()} / rs "
                             f"{tuple(rs.shape)} disagree")
    if seeds.numel() != n:
        raise ValueError(f"seeds {seeds.numel()} / rs {tuple(rs.shape)} disagree")
    if distribution not in DIST_CODES:
        raise ValueError(f"unknown distribution {distribution!r}")
    y = torch.empty_like(x2d)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().fs_rec_apply(
            x2d.data_ptr(), seeds.data_ptr(), rs.data_ptr(), float(scale),
            float(div), lo.data_ptr() if masked else None,
            hi.data_ptr() if masked else None, y.data_ptr(), n, k, rows, cols,
            leaf_tag & U32_MASK, row_offset & U32_MASK, col_offset & U32_MASK,
            cols if orig_cols is None else orig_cols, int(masked),
            int(per_client_rounding), DIST_CODES[distribution],
            LEAF_DTYPES[x2d.dtype], stream)
    raise_on_cuda_error("fs_rec_apply", err)
    reconstruct_apply_clients.launches += 1
    return y


reconstruct_apply_clients.launches = 0
