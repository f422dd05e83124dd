"""Leaf tables and launch plans for the tree launches of the encode, the two closes and QSGD.

One launch of ``csrc/seeded_projection.cu``, ``csrc/reconstruct_apply.cu``,
``csrc/seeded_reconstruct.cu`` or ``csrc/qsgd_quant.cu`` covers every
leaf of a parameter tree:
it carries a leaf table (``csrc/tree.cuh``: data pointers, the 2-D view,
leaf tag, offsets, dtype code and each leaf's first tile in one flat
tile space) by value as a kernel parameter, so a launch copies nothing
to the card.  A tree of more than :data:`MAX_TREE_LEAVES` leaves is
split into several launches of the same kernel, in leaf order.  The fused
close runs with one of several tiles (:data:`CLOSE_TILES`), which its plan
fixes.

A :class:`TreePlan` holds what does not change from call to call for one
tree layout: the leaves' views and tags, each launch group's table with
every field but the data pointers filled in, and the k-block bounds of
every leaf, computed once and kept on the device.  Plans are cached per
(kernel, leaf shapes and dtypes, k, mode, device, shard layout, close
tile), so a call's host work is filling in the pointers and launching.

A shard plan (:func:`shard_plan`) tiles the shards of a mesh-sharded
tree: its entries are (shard, leaf) pairs, shard-major, each the local
padded view of one leaf's shard at its global coordinates (the offsets
``ordinal · per_shard`` on the sharded axis, ``orig_cols`` the leaf's
global cols, the leaf's tag and k-block bounds), so a launch over the
shards on one device computes what the unsharded launch computes on
those elements.  Each entry's (row offset, col offset, orig cols) is in
the plan's ``coords``, which the plain versions read too.

The QSGD plan (kind ``"qsgd"``, :func:`qsgd_plan`) tiles differently: a
tile is a span of whole rows of one (client, leaf), about
``QSGD_TILE_ELEMS`` elements, worked by one warp, so a narrow leaf packs
many rows into a warp's work; each leaf carries its column in the flat
payload (``offset``, 64-bit: a leaf may start past column 2³¹) and its
first norm partial (``part0``): the norm pass splits each (client, leaf)
into :func:`qsgd_norm_units` spans.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.core.directions import block_bounds, check_block_mask_domain
from repro_torch.core.projection import LeafLayout, ProjectionMode, view2d
from repro_torch.kernels.common import LEAF_DTYPES

__all__ = ["MAX_TREE_LEAVES", "ENCODE_TILE_ROWS", "CLOSE_TILE_ROWS",
           "CLOSE_TILE_THREADS", "CLOSE_TILES", "DEFAULT_CLOSE_TILE", "close_tile",
           "DECODE_MIN_TILES", "QSGD_TILE_ELEMS",
           "QSGD_NORM_UNIT_ELEMS", "QSGD_NORM_UNITS_MAX", "TreeLeaf", "TreeTable",
           "TreePlan", "LaunchGroup", "leaf_block_bounds", "decode_vector",
           "qsgd_rows_per_tile", "qsgd_norm_units", "tree_plan", "shard_plan",
           "qsgd_plan", "MAX_DIM", "check_entry_range",
           "check_leaves", "single_table"]

# csrc/tree.cuh's MAX_TREE_LEAVES.
MAX_TREE_LEAVES = 64
# Tile shapes: the encode's tile is ENCODE_TILE_ROWS rows of a leaf
# (seeded_projection.cu's TILE_ROWS); the per-client decode's
# CLOSE_TILE_ROWS rows by CLOSE_TILE_THREADS · V columns (below).
ENCODE_TILE_ROWS = 32
CLOSE_TILE_ROWS = 8
CLOSE_TILE_THREADS = 32
# The fused close's tiles, the instantiations of reconstruct_apply.cu in
# its order: (rows, threads across a row, vector); a thread owns V = 16 /
# element bytes consecutive columns of its row (vector) or one (V = 1), so
# a tile is rows × threads · V columns.  The tile only decides which thread
# computes which element, never an element's sum order, so every tile gives
# the same bits; kernels/tune.py picks one per workload.  The default is
# the decode's tile.
CLOSE_TILES = ((8, 32, True), (16, 16, True), (32, 16, True), (4, 64, True),
               (8, 32, False))
DEFAULT_CLOSE_TILE = CLOSE_TILES[0]
# The per-client decode ("decode", seeded_reconstruct.cu) tiles as the
# close does, CLOSE_TILE_ROWS rows by CLOSE_TILE_THREADS · V columns, and
# chooses V once per launch: V = 16 / element bytes (a thread owns one
# 16-byte vector of a row) when the launch then has at least
# DECODE_MIN_TILES tiles, else V = 1.  Each thread walks the whole cohort
# in order (the decode's sum order), so nothing but more threads shortens
# a small tree's launch: the paper MLP's leaves are at most 24 columns
# wide, and V = 4 there would idle three lanes in four.  DECODE_MIN_TILES
# is two blocks for each of the H100's 132 SMs.
DECODE_MIN_TILES = 2 * 132
# QSGD (qsgd_quant.cu): a tile is max(1, QSGD_TILE_ELEMS // cols) rows of
# one (client, leaf), worked by one warp.  The norm pass splits each
# (client, leaf) of s elements into min(QSGD_NORM_UNITS_MAX,
# ⌈s / QSGD_NORM_UNIT_ELEMS⌉) spans of ⌈s / units⌉ elements rounded up to
# a multiple of 8 (so 16-byte loads stay aligned), one float32 partial
# each; the cap keeps the partials a quantize warp sums for a norm short.
QSGD_TILE_ELEMS = 256
QSGD_NORM_UNIT_ELEMS = 512
QSGD_NORM_UNITS_MAX = 512
# The largest rows or cols of an entry's view: the kernels index a row and
# a column in int, with up to a tile's overhang (CLOSE_TILE_ROWS rows; a
# warp's UNROLL · 32 16-byte vectors of the encode) past the edge.
MAX_DIM = (1 << 31) - (1 << 16)
_KINDS = ("encode", "close", "decode", "qsgd")
_PLAN_CACHE_MAX = 64


class _CloseCols(ctypes.Structure):
    _fields_ = [("orig_cols", ctypes.c_int), ("col_tiles", ctypes.c_int)]


class _ColsOrOffset(ctypes.Union):
    _anonymous_ = ("_c",)
    _fields_ = [("_c", _CloseCols), ("offset", ctypes.c_longlong)]


class TreeLeaf(ctypes.Structure):
    """``fs::TreeLeaf``; QSGD's 64-bit payload ``offset`` shares the slots
    of ``orig_cols`` and ``col_tiles`` (the encode and the closes)."""

    _anonymous_ = ("_u0",)
    _fields_ = [("x", ctypes.c_void_p), ("y", ctypes.c_void_p),
                ("tile0", ctypes.c_longlong), ("_u0", _ColsOrOffset),
                ("rows", ctypes.c_int), ("cols", ctypes.c_int),
                ("tag", ctypes.c_uint32), ("row_offset", ctypes.c_uint32),
                ("col_offset", ctypes.c_uint32), ("part0", ctypes.c_uint16),
                ("dtype", ctypes.c_uint8), ("vec", ctypes.c_uint8)]


class TreeTable(ctypes.Structure):
    """``fs::TreeTable``: the leaves of one launch."""

    _fields_ = [("num_tiles", ctypes.c_longlong), ("num_leaves", ctypes.c_int),
                ("pad_", ctypes.c_int), ("leaf", TreeLeaf * MAX_TREE_LEAVES)]


def leaf_block_bounds(
    leaf_offset: int, leaf_size: int, total: int, num_blocks: int,
    mode: ProjectionMode = ProjectionMode.BLOCK,
) -> tuple[list[float], list[float]]:
    """Leaf-local flat [lo, hi) of every global block (clamped, floats)."""
    if mode != ProjectionMode.BLOCK or num_blocks == 1:
        return [0.0] * num_blocks, [float(leaf_size)] * num_blocks
    check_block_mask_domain(leaf_size)
    los, his = [], []
    for j in range(num_blocks):
        blo, bhi = block_bounds(total, num_blocks, j)
        lo = min(max(blo - leaf_offset, 0), leaf_size)
        hi = min(max(bhi - leaf_offset, 0), leaf_size)
        los.append(float(lo))
        his.append(float(max(hi, lo)))
    return los, his


def check_entry_range(shape, rows: int, cols: int, row_offset: int,
                      col_offset: int, orig_cols: int) -> None:
    """Raise unless a table entry lies in the kernels' index range: its
    rows, its cols and the global cols each below :data:`MAX_DIM`, its
    coordinates ``row_offset + row`` and ``col_offset + col`` below 2³²
    (the reference's uint32 (tag, row, col) addressing).  The number of
    elements is not limited: the kernels take rows·cols and the flat tile
    space in 64 bits."""
    if max(rows, cols, orig_cols) > MAX_DIM:
        raise ValueError(f"leaf {tuple(shape)}: a dimension of its ({rows}, "
                         f"{cols}) view (of {orig_cols} columns) passes "
                         f"{MAX_DIM}")
    if row_offset + rows > 1 << 32 or col_offset + cols > 1 << 32:
        raise ValueError(f"leaf {tuple(shape)} at ({row_offset}, {col_offset}): "
                         "coordinates past 2^32")


def _elem(dtype: torch.dtype) -> int:
    return 2 if dtype == torch.bfloat16 else 4


def qsgd_rows_per_tile(cols: int) -> int:
    """Rows of one QSGD tile (qsgd_quant.cu's rows_per_tile)."""
    return max(1, QSGD_TILE_ELEMS // max(cols, 1))


def qsgd_norm_units(size: int) -> tuple[int, int]:
    """→ (spans, elements a span) of the QSGD norm pass over one (client,
    leaf) of ``size`` elements (qsgd_quant.cu's norm_units / norm_span)."""
    units = min(QSGD_NORM_UNITS_MAX, max(1, -(-size // QSGD_NORM_UNIT_ELEMS)))
    return units, -(-(-(-size // units)) // 8) * 8


def close_tile(block=None) -> tuple[int, int, bool]:
    """The fused close's tile named by ``block``, ``(rows, threads across a
    row, vector)`` (a list too, as a tuning cache stores it), or the default
    for None; raise unless it is one of :data:`CLOSE_TILES`."""
    if block is None:
        return DEFAULT_CLOSE_TILE
    tile = tuple(block)
    if len(tile) == 3:
        tile = (int(tile[0]), int(tile[1]), bool(tile[2]))
    if tile not in CLOSE_TILES:
        raise ValueError(f"fused close tile {block!r} is not one of {CLOSE_TILES}")
    return tile


def _tiles(kind: str, rows: int, cols: int, dtype: torch.dtype,
           vector: bool = True, tile=None) -> tuple[int, int]:
    """→ (tiles of one leaf, tiles across one of its rows); ``vector`` False
    gives the decode's tiles of one column a thread, ``tile`` the close's
    tile (default :data:`DEFAULT_CLOSE_TILE`)."""
    if rows == 0 or cols == 0:
        return 0, 1
    if kind == "encode":
        return -(-rows // ENCODE_TILE_ROWS), 1
    if kind == "qsgd":
        return -(-rows // qsgd_rows_per_tile(cols)), 1
    if kind == "close":
        tile_rows, threads, vector = tile or DEFAULT_CLOSE_TILE
    else:
        tile_rows, threads = CLOSE_TILE_ROWS, CLOSE_TILE_THREADS
    per_thread = 16 // _elem(dtype) if vector else 1
    col_tiles = -(-cols // (threads * per_thread))
    return -(-rows // tile_rows) * col_tiles, col_tiles


def decode_vector(leaves) -> bool:
    """The decode's V rule for one launch over ``leaves``, an iterable of
    (rows, cols, dtype): True (V = 16 / element bytes) when that gives at
    least ``DECODE_MIN_TILES`` tiles, else False (V = 1)."""
    return sum(_tiles("decode", r, c, dt)[0] for r, c, dt in leaves) >= DECODE_MIN_TILES


def _fill_static(entry: TreeLeaf, kind: str, rows: int, cols: int, orig_cols: int,
                 dtype: torch.dtype, tag: int, row_offset: int, col_offset: int,
                 tile0: int, vector: bool = True, part0: int = 0,
                 tile=None) -> int:
    """Fill every field of ``entry`` but the pointers and ``vec``; → its tiles.

    For ``kind`` "qsgd", ``orig_cols`` is the leaf's payload offset and
    ``part0`` its first norm partial; ``tile`` is the close's tile."""
    tiles, col_tiles = _tiles(kind, rows, cols, dtype, vector, tile)
    entry.rows, entry.cols = rows, cols
    entry.dtype = LEAF_DTYPES[dtype]
    entry.tag = tag & 0xFFFFFFFF
    entry.row_offset = row_offset & 0xFFFFFFFF
    entry.col_offset = col_offset & 0xFFFFFFFF
    entry.tile0 = tile0
    if kind == "qsgd":
        entry.offset, entry.part0 = orig_cols, part0
    else:
        entry.orig_cols, entry.col_tiles = orig_cols, col_tiles
    return tiles


def _vec(cols: int, dtype: torch.dtype, ptr: int) -> int:
    """1 when every row of a leaf at ``ptr`` starts on a 16-byte boundary."""
    return int(ptr % 16 == 0 and (cols * _elem(dtype)) % 16 == 0)


@dataclasses.dataclass(frozen=True)
class LaunchGroup:
    """Leaves ``start:stop`` of a plan, launched together."""

    start: int
    stop: int
    num_tiles: int
    template: bytes          # the TreeTable with every pointer unset
    vector: bool = True      # the decode's V rule (decode_vector) for this launch
    num_parts: int = 0       # QSGD: norm partials per client of this launch

    def table(self, xs, ys=None) -> TreeTable:
        """The launch's table with the leaves' (and outputs') pointers set."""
        table = TreeTable.from_buffer_copy(self.template)
        for i, x in enumerate(xs):
            entry = table.leaf[i]
            ptr = x.data_ptr()
            entry.x = ptr
            entry.vec = _vec(entry.cols, x.dtype, ptr) and (
                ys is None or _vec(entry.cols, x.dtype, ys[i].data_ptr()))
            if ys is not None:
                entry.y = ys[i].data_ptr()
        return table


@dataclasses.dataclass(frozen=True)
class TreePlan:
    """What a tree launch needs besides the data, for one tree layout.

    ``layout`` has one entry per table entry: a leaf, or in a shard plan a
    (shard, leaf) pair whose rows and cols are the shard's local view and
    whose tag and offset are its leaf's."""

    kind: str
    layout: tuple[LeafLayout, ...]
    dtypes: tuple[torch.dtype, ...]
    k: int
    masked: bool
    lo: torch.Tensor         # (L, k) float32 leaf-local block bounds, on the device
    hi: torch.Tensor
    groups: tuple[LaunchGroup, ...]
    coords: tuple[tuple[int, int, int], ...]   # per entry: (row offset,
                                               # col offset, orig cols)
    tile: tuple | None = None                  # the close's tile (close_tile)


_plans: dict = {}


def tree_plan(kind: str, shapes, dtypes, k: int, mode: ProjectionMode,
              device, shard=None, tile=None) -> TreePlan:
    """The cached plan of ``kind`` ("encode", "close", "decode" or "qsgd")
    for leaves of these per-client shapes and dtypes in sorted-key order
    (``shard``: see :func:`shard_plan`; ``tile``: the close's tile, see
    :func:`close_tile`)."""
    if kind not in _KINDS:
        raise ValueError(kind)
    if kind == "close":
        tile = close_tile(tile)
    elif tile is not None:
        raise ValueError(f"only the fused close takes a tile, not {kind!r}")
    device = torch.device(device)
    # The shard layout and the tile are part of the key: a local view may
    # have the shape of some unsharded leaf, whose plan has offsets 0, and
    # the tile sets the tile space.
    key = (kind, tuple(shapes), tuple(dtypes), k, mode, device, shard, tile)
    plan = _plans.get(key)
    if plan is None:
        if len(_plans) >= _PLAN_CACHE_MAX:
            _plans.clear()
        plan = _plans[key] = _build_plan(kind, key[1], key[2], k, mode, device,
                                         shard, tile)
    return plan


def shard_plan(kind: str, shapes, dtypes, num_shards: int, shards, ordinals,
               k: int, mode: ProjectionMode, device) -> TreePlan:
    """The cached shard plan of ``kind`` ("encode", "close" or "decode"):
    one entry per (shard, leaf) pair, for the shards ``ordinals`` (in that
    order) of a tree whose global leaves have ``shapes`` and ``dtypes``,
    leaf ``i`` split into ``num_shards`` slices of ``per_shard`` rows
    (``axis`` 0) or cols (``axis`` 1), ``shards[i] = (axis, per_shard)``.

    An entry's view is the shard's ``(per_shard, cols)`` or ``(rows,
    per_shard)`` slice of the leaf's view padded to ``num_shards ·
    per_shard``; its coordinates are global, its k-block bounds the
    leaf's.  Groups keep the 64-entry split; the decode's V rule runs
    over each group's local views."""
    if kind == "qsgd":
        raise ValueError("the QSGD plan has no shard layout")
    shard = (int(num_shards), tuple((int(a), int(p)) for a, p in shards),
             tuple(int(s) for s in ordinals))
    return tree_plan(kind, shapes, dtypes, k, mode, device, shard)


def _build_plan(kind, shapes, dtypes, k, mode, device, shard=None,
                tile=None) -> TreePlan:
    leaves, offset = [], 0
    for tag, shape in enumerate(shapes):
        rows, cols = view2d(shape)
        leaves.append(LeafLayout(tag=tag, shape=shape, rows=rows, cols=cols,
                                 offset=offset, size=rows * cols))
        offset += rows * cols
    total = offset
    bounds = [leaf_block_bounds(ll.offset, ll.size, total, k, mode)
              for ll in leaves]
    # The table's entries: every leaf, or every (shard, leaf) pair.
    if shard is None:
        layout, coords = leaves, tuple((0, 0, ll.cols) for ll in leaves)
        which = range(len(leaves))
    else:
        _, per_leaf, ordinals = shard
        layout, coords, which = [], [], []
        for s in ordinals:
            for ll, (axis, per) in zip(leaves, per_leaf):
                rows, cols = (per, ll.cols) if axis == 0 else (ll.rows, per)
                layout.append(LeafLayout(tag=ll.tag, shape=(rows, cols), rows=rows,
                                         cols=cols, offset=ll.offset,
                                         size=rows * cols))
                coords.append((s * per, 0, ll.cols) if axis == 0
                              else (0, s * per, ll.cols))
                which.append(ll.tag)
        dtypes = tuple(dtypes[i] for i in which)
    lo = torch.tensor([bounds[i][0] for i in which],
                      dtype=torch.float32).reshape(-1, k)
    hi = torch.tensor([bounds[i][1] for i in which],
                      dtype=torch.float32).reshape(-1, k)
    groups = []
    for start in range(0, len(layout), MAX_TREE_LEAVES):
        stop = min(start + MAX_TREE_LEAVES, len(layout))
        vector = kind != "decode" or decode_vector(
            (ll.rows, ll.cols, dtypes[start + i])
            for i, ll in enumerate(layout[start:stop]))
        table = TreeTable()
        tiles = parts = 0
        for i, ll in enumerate(layout[start:stop]):
            if kind == "qsgd":
                check_entry_range(ll.shape, ll.rows, ll.cols, 0, 0, ll.cols)
                tiles += _fill_static(table.leaf[i], kind, ll.rows, ll.cols,
                                      ll.offset, dtypes[start + i], ll.tag, 0, 0,
                                      tiles, part0=parts)
                parts += qsgd_norm_units(ll.size)[0]
            else:
                row_offset, col_offset, orig_cols = coords[start + i]
                check_entry_range(ll.shape, ll.rows, ll.cols, row_offset,
                                  col_offset, orig_cols)
                tiles += _fill_static(table.leaf[i], kind, ll.rows, ll.cols,
                                      orig_cols, dtypes[start + i], ll.tag,
                                      row_offset, col_offset, tiles, vector,
                                      tile=tile)
        table.num_leaves, table.num_tiles = stop - start, tiles
        groups.append(LaunchGroup(start, stop, tiles, bytes(table), vector, parts))
    return TreePlan(kind=kind, layout=tuple(layout), dtypes=tuple(dtypes), k=k,
                    masked=mode == ProjectionMode.BLOCK and k > 1,
                    lo=lo.to(device), hi=hi.to(device), groups=tuple(groups),
                    coords=tuple(coords), tile=tile)


def qsgd_plan(shapes, dtypes, device) -> TreePlan:
    """The cached QSGD plan for leaves of these per-client shapes and dtypes."""
    return tree_plan("qsgd", shapes, dtypes, 1, ProjectionMode.FULL, device)


def check_leaves(plan: TreePlan, leaves, k: int, device: torch.device) -> None:
    """Raise unless ``leaves`` are contiguous tensors on ``device`` with the
    dtypes ``plan`` was made for, and ``k`` is its number of blocks."""
    if k != plan.k:
        raise ValueError(f"rs has {k} blocks, the {plan.kind} plan {plan.k}")
    for leaf, dtype in zip(leaves, plan.dtypes):
        if leaf.device != device or leaf.dtype != dtype or not leaf.is_contiguous():
            raise ValueError(f"leaf {tuple(leaf.shape)} {leaf.dtype} on "
                             f"{leaf.device} does not fit the plan ({dtype}, "
                             f"contiguous, on {device})")


def single_table(kind: str, x: torch.Tensor, rows: int, cols: int,
                 orig_cols: int, tag: int, row_offset: int, col_offset: int,
                 y: torch.Tensor | None = None, vector: bool = True,
                 tile=None) -> TreeTable:
    """A one-leaf table: the leaf-level kernels are tree launches of one leaf
    (for "qsgd", ``orig_cols`` is the leaf's payload offset; for "close",
    ``tile`` is its tile)."""
    check_entry_range(tuple(x.shape), rows, cols, row_offset, col_offset,
                      cols if kind == "qsgd" else orig_cols)
    table = TreeTable()
    entry = table.leaf[0]
    table.num_tiles = _fill_static(entry, kind, rows, cols, orig_cols, x.dtype, tag,
                                   row_offset, col_offset, 0, vector, tile=tile)
    table.num_leaves = 1
    entry.x = x.data_ptr()
    entry.vec = _vec(cols, x.dtype, x.data_ptr()) and (
        y is None or _vec(cols, x.dtype, y.data_ptr()))
    if y is not None:
        entry.y = y.data_ptr()
    return table
