"""Per-client server decode y = x + scale·Σ_b Σ_n r[n,b]·(v[n,b]·mask_b) — one launch per tree.

Port of ``repro/kernels/seeded_reconstruct.py::_rec_kernel``.  The CUDA
kernel is ``csrc/seeded_reconstruct.cu``; this module holds its plain
PyTorch version (the reference's arithmetic written out) and the
wrappers: :func:`reconstruct_tree` decodes every leaf of a tree in one
launch (one per group of ``tree.MAX_TREE_LEAVES`` leaves),
:func:`reconstruct_apply_clients` one leaf's 2-D view, as a tree of one.

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
CLIENT_CHUNK is the reference's padding, not a sum order: the kernel
stages its own number of (client, block) pairs at a time.
Of the port's counters (:mod:`repro_torch.obs`), ``decode.launches``
counts kernel launches (one per launch group) and ``decode.slots`` the
cohort rows :func:`reconstruct_tree` decodes, bucket padding included,
on the card and on the plain route.
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
    CLOSE_TILE_ROWS,
    CLOSE_TILE_THREADS,
    TreePlan,
    TreeTable,
    check_leaves,
    decode_vector,
    single_table,
)

__all__ = ["CLIENT_CHUNK", "reconstruct_tree", "reconstruct_tree_plain",
           "reconstruct_apply_clients", "reconstruct_plain", "pad_clients"]

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


def reconstruct_tree_plain(leaves, seeds: torch.Tensor, rs: torch.Tensor,
                           scale: float, div: float, plan: TreePlan,
                           distribution: str = "rademacher",
                           per_client_rounding: bool = False) -> list:
    """Plain version of a tree decode: :func:`reconstruct_plain` entry by
    entry, with the plan's tags, block bounds and coordinates → the new
    leaves."""
    out = []
    for i, (ll, x) in enumerate(zip(plan.layout, leaves)):
        lo, hi = (plan.lo[i], plan.hi[i]) if plan.masked else (None, None)
        row_offset, col_offset, orig_cols = plan.coords[i]
        y = reconstruct_plain(x.reshape(ll.rows, ll.cols), seeds, rs, ll.tag, scale,
                              lo, hi, distribution, plan.masked, row_offset,
                              col_offset, orig_cols, per_client_rounding, div)
        out.append(y.reshape(x.shape))
    return out


def _lib():
    lib = _build.library("seeded_reconstruct")
    if not getattr(lib, "_fs_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fs_rec_tree.argtypes = [p, p, p, f, f, p, p, i, i, i, i, i, i, p]
        lib.fs_rec_tree.restype = i
        for name in ("fs_rec_tile_rows", "fs_rec_tile_threads", "fs_rec_table_bytes"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i
        if (lib.fs_rec_tile_rows() != CLOSE_TILE_ROWS
                or lib.fs_rec_tile_threads() != CLOSE_TILE_THREADS
                or lib.fs_rec_table_bytes() != ctypes.sizeof(TreeTable)):
            raise RuntimeError("csrc/seeded_reconstruct.cu disagrees on its tile "
                               "or its leaf table")
        lib._fs_typed = True
    return lib


def _launch(table: TreeTable, seeds: torch.Tensor, rs: torch.Tensor, scale: float,
            div: float, lo: int | None, hi: int | None, masked: bool,
            per_client_rounding: bool, vector: bool, distribution: str,
            dev: torch.device) -> None:
    n, k = rs.shape
    if dev.type == "meta":           # the dry run: plan and buffers, no launch
        return
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().fs_rec_tree(ctypes.addressof(table), seeds.data_ptr(),
                                 rs.data_ptr(), float(scale), float(div), lo, hi, n,
                                 k, int(masked), int(per_client_rounding),
                                 int(vector), DIST_CODES[distribution], stream)
    raise_on_cuda_error("fs_rec_tree", err)
    if table.num_tiles > 0:          # a table of empty leaves launches nothing
        obs.count("decode.launches")


def reconstruct_tree(leaves, seeds: torch.Tensor, rs: torch.Tensor, scale: float,
                     div: float, plan: TreePlan, distribution: str = "rademacher",
                     per_client_rounding: bool = False) -> list:
    """→ the new leaves ``x + scale·Σₙⱼ rₙⱼ·vₙⱼ`` of a tree, in leaf order
    (``x + scale·(Σₙ round(Σⱼ rₙⱼ·vₙⱼ) / div)`` with ``per_client_rounding``).

    ``leaves`` are the tree's leaves in sorted-key order with the shapes
    and dtypes ``plan`` (a "decode" plan) was made for; ``seeds`` the
    ``(N,)`` round seeds (int64 words), ``rs`` the ``(N, k)`` float32
    scalars with every aggregation weight folded in.  CUDA tensors take
    one launch per launch group of ``plan`` (or raise); CPU tensors the
    plain version.
    """
    dev = rs.device
    if dev.type != "meta":
        obs.count("decode.slots", rs.shape[0])
    if dev.type == "cpu":
        return reconstruct_tree_plain(leaves, seeds, rs, scale, div, plan,
                                      distribution, per_client_rounding)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {dev}")
    _, k = check_cohort(seeds, rs, distribution, dev)
    if plan.kind != "decode":
        raise ValueError(f"a {plan.kind} plan does not tile the decode")
    check_leaves(plan, leaves, k, dev)
    out = [torch.empty_like(leaf) for leaf in leaves]
    row_bytes = 4 * plan.k
    for group in plan.groups:
        sl = slice(group.start, group.stop)
        masked = plan.masked
        _launch(group.table(leaves[sl], out[sl]), seeds, rs, scale, div,
                plan.lo.data_ptr() + group.start * row_bytes if masked else None,
                plan.hi.data_ptr() + group.start * row_bytes if masked else None,
                masked, per_client_rounding, group.vector, distribution, dev)
    return out


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
    A CUDA tensor launches the kernel on a one-leaf table (or raises); a
    CPU tensor takes the plain version.
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
    vector = decode_vector([(rows, cols, x2d.dtype)])
    table = single_table("decode", x2d, rows, cols,
                         cols if orig_cols is None else orig_cols, leaf_tag,
                         row_offset, col_offset, y, vector)
    _launch(table, seeds, rs, scale, div, lo.data_ptr() if masked else None,
            hi.data_ptr() if masked else None, masked, per_client_rounding, vector,
            distribution, dev)
    return y

