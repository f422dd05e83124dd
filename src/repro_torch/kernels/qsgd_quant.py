"""QSGD stochastic quantize→dequantize of a parameter tree for every client of a cohort.

Port of ``repro/kernels/qsgd_quant.py::_qsgd_kernel``.  The CUDA kernel is
``csrc/qsgd_quant.cu`` (its note gives the design and the bound); this
module holds its plain PyTorch versions and the wrappers.

:func:`qsgd_tree` quantizes every leaf of a tree for every client in one
tree launch (``kernels/tree.py``'s ``"qsgd"`` plan; a tree of more than
``tree.MAX_TREE_LEAVES`` leaves takes one per group of leaves), plus a
norm pass before it unless the caller gives the norms.  Leaves are
``(N, *shape)`` float32 or bf16 in sorted-key order, ``seeds`` the ``(N,)``
client seeds as int64 words (or a :class:`RoundSeeds`, whose seeds the
kernel derives from the client ids), folded with each leaf's ordinal in
the kernel (``fold_seed(seed, tag)``).  It writes the round trip ``q`` per
leaf in the leaf's dtype and/or the wire payload: an ``(N, d + L)``
float32 array holding each leaf's signed levels at its flat offset and
the leaf norms in the last L columns, the layout of the ``qsgd``
protocol's frames.  :func:`qsgd_quantize` is the same kernel on a
one-leaf table, for one leaf's ``(N, rows, cols)`` view with seeds
already folded and norms given.

The numeric spec, in the reference's op order (float32 throughout)::

    L      = 2^(bits−1) − 1
    u      = (f32(hash_u32(seed, row, col, QSGD_TAG)) + 1) · 2⁻³²
    scaled = (|x| / norm) · L
    level  = ⌊scaled⌋ + 𝟙[u < scaled − ⌊scaled⌋]
    signed = sign(x) · level                     (the wire's level code)
    q      = ((norm · sign(x)) · level) / L      (= norm · signed / L)

``(row, col)`` are the coordinates of the 2-D view, with ``sign(0) = 0``;
``norm`` is the client's L2 norm of the leaf with zero replaced by 1.  The
plain versions take it from ``torch.linalg.vector_norm``; the kernel sums
the squares in its own order (:func:`norm_tolerance` bounds the
difference) and gives the same bits run after run.  Given the same norms
the kernel and the plain versions give the same bits.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch import obs
from repro_torch.core.prng import U32_MASK, hash_u32, uniform01
from repro_torch.core.projection import view2d
from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    LEAF_DTYPES,
    check_cuda_tensor,
    fold_seed,
    raise_on_cuda_error,
)
from repro_torch.kernels.tree import (
    QSGD_NORM_UNIT_ELEMS,
    QSGD_NORM_UNITS_MAX,
    QSGD_TILE_ELEMS,
    TreeTable,
    qsgd_norm_units,
    qsgd_plan,
    single_table,
)

__all__ = ["QSGD_TAG", "RoundSeeds", "qsgd_quantize", "qsgd_quantize_plain",
           "qsgd_tree", "qsgd_tree_plain", "guarded_norms", "norm_depth",
           "norm_tolerance"]

# Stream tag of the rounding uniforms (repro.core.qsgd.QSGD_TAG).
QSGD_TAG = 0x7FEB352D

# Elements per client group in the plain version (bounds its temporaries).
_PLAIN_GROUP_ELEMS = 1 << 22


@dataclasses.dataclass(frozen=True)
class RoundSeeds:
    """Each client's seed ``round_seeds_for(round_idx, id, salt)``
    (``core/fedscalar.py``) for ``client_ids`` ((N,) int64 words): the
    kernel derives them itself, so a call launches nothing to make them."""

    round_idx: int
    client_ids: torch.Tensor
    salt: int

    @property
    def shape(self):
        return self.client_ids.shape

    @property
    def device(self):
        return self.client_ids.device

    def words(self) -> torch.Tensor:
        """The seeds as int64 words, in plain torch."""
        from repro_torch.core.fedscalar import round_seeds_for

        return round_seeds_for(self.round_idx, self.client_ids, self.salt,
                               self.client_ids.device)

    def round_word(self) -> int:
        """``mul32(round_idx, 0x9E3779B9) ^ salt``, the part of every seed
        that does not depend on the client."""
        return ((int(self.round_idx) & U32_MASK) * 0x9E3779B9 & U32_MASK) ^ (
            self.salt & U32_MASK)


def guarded_norms(x3d: torch.Tensor) -> torch.Tensor:
    """Each client's float32 L2 norm of its slice of ``x3d`` (leading axis N),
    zero → 1: the plain versions' norms (``core.qsgd.leaf_norm(batched=True)``)."""
    norm = torch.linalg.vector_norm(
        x3d.to(torch.float32).reshape(x3d.shape[0], -1), dim=-1)
    return torch.where(norm == 0, torch.ones_like(norm), norm)


def norm_depth(size: int) -> int:
    """h, the longest chain of float32 roundings in the kernel's norm of one
    (client, leaf) of ``size`` elements: the square, a lane's running sums
    over its share of a span (its two sums counted as one chain, plus one
    partial 16-byte vector), joining them, the warp butterfly, the
    finishing lane's sum over the spans' partials, its butterfly, and the
    square root."""
    units, span = qsgd_norm_units(size)
    return 1 + (-(-span // 32) + 8) + 1 + 5 + -(-units // 32) + 5 + 1


def norm_tolerance(x: torch.Tensor) -> torch.Tensor:
    """Bound on |kernel norm − exact norm| of each client's leaf ``x`` (``(N,
    *shape)``): ``h·2⁻²⁴·‖x‖₂``, h = :func:`norm_depth`, float64 ``(N,)``.

    A sum of h-deep roundings of nonnegative terms is within about
    h·2⁻²⁴ of its value, and the square root halves that relative error
    and adds half an ulp, so the bound holds with room to spare.
    """
    n = x.shape[0]
    size = x[0].numel() if n else 0
    exact = torch.linalg.vector_norm(x.to(torch.float64).reshape(n, -1), dim=1)
    return norm_depth(size) * 2.0 ** -24 * exact


def qsgd_quantize_plain(x: torch.Tensor, seeds: torch.Tensor,
                        norms: torch.Tensor, levels: int, want_q: bool = True,
                        want_levels: bool = False, row_offset: int = 0,
                        col_offset: int = 0):
    """Plain version of one leaf → ``(q or None, signed or None)``; ``seeds``
    already folded, ``norms`` ``(N,)``."""
    n, rows, cols = x.shape
    dev = x.device
    row = ((torch.arange(rows, dtype=torch.int64, device=dev) + row_offset)
           & U32_MASK)[None, :, None]
    col = ((torch.arange(cols, dtype=torch.int64, device=dev) + col_offset)
           & U32_MASK)[None, None, :]
    group = max(1, _PLAIN_GROUP_ELEMS // max(rows * cols, 1))
    # A device tensor, not a Python float: CUDA divides by a host scalar as
    # a multiply by its reciprocal, which is not the kernel's IEEE division.
    lv_f = torch.tensor(float(levels), dtype=torch.float32, device=dev)
    q_out = torch.empty_like(x) if want_q else None
    lv_out = (torch.empty(x.shape, dtype=torch.float32, device=dev)
              if want_levels else None)
    for g in range(0, n, group):
        sl = slice(g, g + group)
        s = (seeds[sl].to(torch.int64) & U32_MASK)[:, None, None]
        u = uniform01(hash_u32(s, row, col, QSGD_TAG))
        xf = x[sl].to(torch.float32)
        norm = norms[sl].to(torch.float32)[:, None, None]
        scaled = xf.abs() / norm * float(levels)
        floor = torch.floor(scaled)
        level = floor + (u < (scaled - floor)).to(torch.float32)
        sign = torch.sign(xf)
        if want_levels:
            lv_out[sl] = sign * level
        if want_q:
            q_out[sl] = (norm * sign * level / lv_f).to(x.dtype)
    return q_out, lv_out


def qsgd_tree_plain(leaves, seeds: torch.Tensor | RoundSeeds, levels: int, *,
                    want_q: bool = True, want_levels: bool = False,
                    norms: torch.Tensor | None = None):
    """Plain version of :func:`qsgd_tree`: per leaf, :func:`guarded_norms` (or
    the given norms) and :func:`qsgd_quantize_plain` with the seeds folded
    by the leaf's ordinal → ``(q leaves or None, payload or None, norms)``."""
    n = seeds.shape[0]
    dev = seeds.device
    views = [view2d(tuple(x.shape[1:])) for x in leaves]
    d = sum(rows * cols for rows, cols in views)
    payload = (torch.empty((n, d + len(leaves)), dtype=torch.float32, device=dev)
               if want_levels else None)
    out_norms = (payload[:, d:] if want_levels else
                 torch.empty((n, len(leaves)), dtype=torch.float32, device=dev))
    qs = [] if want_q else None
    words = (seeds.words() if isinstance(seeds, RoundSeeds)
             else seeds.to(torch.int64) & U32_MASK)
    offset = 0
    for tag, (x, (rows, cols)) in enumerate(zip(leaves, views)):
        x3d = x.reshape(n, rows, cols)
        if norms is None:
            nm = guarded_norms(x3d)
        else:                            # given as (N, L) or, for every leaf, (N,)
            nm = norms[:, tag] if norms.dim() == 2 else norms
        q, lv = qsgd_quantize_plain(x3d, fold_seed(words, tag), nm, levels,
                                    want_q, want_levels)
        if want_q:
            qs.append(q.reshape(x.shape))
        if want_levels:
            payload[:, offset:offset + rows * cols] = lv.reshape(n, -1)
        out_norms[:, tag] = nm
        offset += rows * cols
    return qs, payload, out_norms


def _lib():
    lib = _build.library("qsgd_quant")
    if not getattr(lib, "_fs_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fs_qsgd_tree.argtypes = [p, p, i, i, i, i, ctypes.c_uint32, p, ll, ll, p,
                                     i, p, ll, p, ll, p]
        lib.fs_qsgd_tree.restype = i
        consts = ("fs_qsgd_tile_elems", "fs_qsgd_norm_unit_elems",
                  "fs_qsgd_norm_units_max", "fs_tree_table_bytes")
        for name in consts:
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i
        if [getattr(lib, name)() for name in consts] != [
                QSGD_TILE_ELEMS, QSGD_NORM_UNIT_ELEMS, QSGD_NORM_UNITS_MAX,
                ctypes.sizeof(TreeTable)]:
            raise RuntimeError("csrc/qsgd_quant.cu disagrees on its tiles, its norm "
                               "spans or its leaf table")
        lib._fs_typed = True
    return lib


def _check_levels(levels: int) -> None:
    if not 1 <= levels <= 127:
        raise ValueError(f"levels {levels} outside 1..127 (bits 2..8)")


def _launch(table: TreeTable, seeds: torch.Tensor, n: int, levels: int, fold: bool,
            round_word: int | None, norms_in, norms_sn: int, norms_sl: int,
            partials, parts: int, lv, lv_ld: int, norms_out, norms_ld: int) -> None:
    """One tree launch (and its norm pass when ``norms_in`` is None); the
    tensor arguments are device addresses or None.  With ``round_word``,
    ``seeds`` holds client ids whose seeds the kernel derives."""
    dev = seeds.device
    if dev.type == "meta":           # the dry run: plan and buffers, no launch
        return
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().fs_qsgd_tree(
            ctypes.addressof(table), seeds.data_ptr(), n, levels, int(fold),
            int(round_word is not None), round_word or 0, norms_in, norms_sn,
            norms_sl, partials, parts, lv, lv_ld, norms_out, norms_ld, stream)
    raise_on_cuda_error("fs_qsgd_tree", err)
    # qsgd_norm_kernel (unless the norms are given) and qsgd_quant_kernel
    obs.count("qsgd.launches", 1 if norms_in is not None else 2)


def _refuse_leaf(x: torch.Tensor, n: int, dev: torch.device) -> None:
    if x.dtype not in LEAF_DTYPES:
        raise TypeError(f"leaf has dtype {x.dtype}, expected one of "
                        f"{tuple(LEAF_DTYPES)}")
    if x.device != dev:
        raise ValueError(f"leaf is on {x.device}, expected {dev}")
    if not x.is_contiguous():
        raise ValueError("leaves must be contiguous")
    raise ValueError(f"leaf {tuple(x.shape)} does not lead with the {n} clients, "
                     "or holds no element")


def qsgd_tree(leaves, seeds: torch.Tensor | RoundSeeds, levels: int, *,
              want_q: bool = True, want_levels: bool = False,
              norms: torch.Tensor | None = None):
    """Quantize every client's tree → ``(q leaves or None, payload or None, norms)``.

    ``leaves`` are ``(N, *shape)`` in sorted-key order, ``seeds`` ``(N,)``
    int64 or a :class:`RoundSeeds`.  ``q`` is a list of the leaves' round trips in their dtypes;
    ``payload`` the ``(N, d + L)`` float32 wire payload (levels, then the
    norms); ``norms`` the ``(N, L)`` float32 norms used (a view of the
    payload's last L columns when it is asked for).  ``norms`` given as
    ``(N,)`` (every leaf) or ``(N, L)`` skip the norm pass.  CUDA tensors
    launch the kernel (or raise): one launch per group of 64 leaves, two
    with the norm pass.  CPU tensors take :func:`qsgd_tree_plain`.
    """
    if not (want_q or want_levels):
        raise ValueError("ask for q, the levels, or both")
    dev = seeds.device
    if dev.type == "cpu":
        return qsgd_tree_plain(leaves, seeds, levels, want_q=want_q,
                               want_levels=want_levels, norms=norms)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {dev}")
    round_word = None
    if isinstance(seeds, RoundSeeds):
        round_word = seeds.round_word()
        seeds = seeds.client_ids
    check_cuda_tensor("seeds", seeds, torch.int64, 1, dev)
    _check_levels(levels)
    n, n_leaves = seeds.shape[0], len(leaves)
    for x in leaves:
        if (x.dtype not in LEAF_DTYPES or x.device != dev or not x.is_contiguous()
                or x.dim() < 1 or x.shape[0] != n or x.numel() == 0):
            _refuse_leaf(x, n, dev)
    plan = qsgd_plan([tuple(x.shape[1:]) for x in leaves], [x.dtype for x in leaves],
                     dev)
    d = sum(ll.size for ll in plan.layout)
    if norms is not None:
        check_cuda_tensor("norms", norms, torch.float32, norms.dim(), dev)
        if norms.shape not in ((n,), (n, n_leaves)):
            raise ValueError(f"norms {tuple(norms.shape)}: expected ({n},) or "
                             f"({n}, {n_leaves})")
    payload = (torch.empty((n, d + n_leaves), dtype=torch.float32, device=dev)
               if want_levels else None)
    if want_levels:
        out_norms = payload[:, d:]
    elif norms is None:
        out_norms = torch.empty((n, n_leaves), dtype=torch.float32, device=dev)
    else:
        out_norms = None                 # nothing to write: the norms are given
    qs = [torch.empty_like(x) for x in leaves] if want_q else None
    n_sn, n_sl = (1, 0) if norms is None or norms.dim() == 1 else (n_leaves, 1)
    o_ld = d + n_leaves if want_levels else n_leaves
    for group in plan.groups:
        a, b = group.start, group.stop
        table = group.table(leaves[a:b], None if qs is None else qs[a:b])
        partials = (torch.empty((n, group.num_parts), dtype=torch.float32, device=dev)
                    if norms is None else None)
        _launch(table, seeds, n, levels, True, round_word,
                None if norms is None else norms.data_ptr() + 4 * a * n_sl, n_sn,
                n_sl, None if partials is None else partials.data_ptr(),
                group.num_parts, None if payload is None else payload.data_ptr(),
                d + n_leaves,
                None if out_norms is None else out_norms.data_ptr() + 4 * a, o_ld)
    if out_norms is None:
        out_norms = norms if norms.dim() == 2 else norms[:, None].expand(n, n_leaves)
    return qs, payload, out_norms


def qsgd_quantize(x: torch.Tensor, seeds: torch.Tensor, norms: torch.Tensor,
                  levels: int, want_q: bool = True, want_levels: bool = False,
                  row_offset: int = 0, col_offset: int = 0):
    """Quantize every client's leaf → ``(q or None, signed levels or None)``.

    ``x`` is one leaf's ``(N, rows, cols)`` view, ``seeds`` the ``(N,)``
    leaf-folded seeds ``fold_seed(ξ, tag)`` as int64 words, ``norms`` the
    ``(N,)`` float32 norms with zero already replaced by 1.  ``q`` is the
    round trip in x's dtype, ``signed`` the float32 level codes; either
    pass writes only what is asked for.  A CUDA tensor launches the tree
    kernel on a one-leaf table with the norms given (or raises); a CPU
    tensor takes the plain version.  The counter ``qsgd.launches``
    (:mod:`repro_torch.obs`) counts kernel launches, those of
    :func:`qsgd_tree` too.
    """
    if not (want_q or want_levels):
        raise ValueError("ask for q, the levels, or both")
    if x.device.type == "cpu":
        return qsgd_quantize_plain(x, seeds, norms, levels, want_q,
                                   want_levels, row_offset, col_offset)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {x.device}")
    dev = x.device
    check_cuda_tensor("x", x, LEAF_DTYPES, 3, dev)
    check_cuda_tensor("seeds", seeds, torch.int64, 1, dev)
    check_cuda_tensor("norms", norms, torch.float32, 1, dev)
    n, rows, cols = x.shape
    if seeds.numel() != n or norms.numel() != n:
        raise ValueError(f"seeds {seeds.numel()} / norms {norms.numel()} do "
                         f"not match x {tuple(x.shape)}")
    _check_levels(levels)
    q = torch.empty_like(x) if want_q else None
    lv = torch.empty(x.shape, dtype=torch.float32, device=dev) if want_levels else None
    if x.numel() == 0:
        return q, lv
    table = single_table("qsgd", x, rows, cols, 0, 0, row_offset, col_offset, y=q)
    _launch(table, seeds, n, levels, False, None, norms.data_ptr(), 1, 0, None, 0,
            None if lv is None else lv.data_ptr(), rows * cols, None, 0)
    return q, lv

