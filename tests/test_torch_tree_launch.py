"""The tree launches' plain versions, on the CPU.

``ops.project_tree_kernel`` and ``ops.server_update_fused`` plan one
launch per tree (``kernels/tree.py``: a leaf table of at most 64 leaves;
a longer tree is split into several launches, in leaf order).  On a CPU
tensor each takes its tree-level plain version, which follows the same
plan, group by group.  Held here:

* against the per-leaf composition: the encode bitwise equal to the
  leaves' ``project_blocks_plain`` summed in leaf order, the close
  bitwise equal to ``fused_reconstruct_apply`` leaf by leaf, on a tree of
  70 leaves (two launch groups), float32 and bf16, all four families,
  FULL and BLOCK k = 8;
* against the JAX reference, on a tree of 66 leaves (two launch groups):
  the encode within 1e-6·Σ|x|·max|v| of ``repro.core.projection.
  project_tree`` (the sum order is open); the close bitwise against
  ``repro.kernels.ref.server_update_fused_ref`` for the ±1/±2 families
  (gaussian within rtol/atol 1e-5, plus one bf16 ulp on bf16 leaves: the
  reference's ``log``/``cos`` ulps scaled by the scalars);
* the plans: groups, tiles, cached block bounds, and the k-block bounds
  against the reference's ``leaf_block_bounds``;
* the per-client decode's tree launch (``ops.server_update_kernel``, one
  launch per group since it too takes a leaf table): its plain path
  bitwise equal to ``reconstruct_plain`` leaf by leaf on a tree of 70
  leaves, all four families, float32 and bf16, FULL and BLOCK k = 8 and
  the three modes (plain, per-client rounding at k = 1 and at k = 8); its
  plan's tiles, each leaf's first tile, and the V rule at both ends (the
  paper MLP's 6 leaves take one column a thread, SmolLM-360M's 11 leaves
  a 16-byte vector).

The CUDA kernels are held against these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.prng import Distribution as JD  # noqa: E402
from repro.core.projection import ProjectionMode as JM  # noqa: E402
from repro.core.projection import project_tree as j_project_tree  # noqa: E402
from repro_torch.core.prng import Distribution as TD  # noqa: E402
from repro_torch.core.projection import ProjectionMode as TM  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.reconstruct_apply import fused_reconstruct_apply  # noqa: E402
from repro_torch.kernels.seeded_projection import project_blocks_plain  # noqa: E402
from repro_torch.kernels.seeded_reconstruct import reconstruct_plain  # noqa: E402
from repro_torch.kernels.tree import (  # noqa: E402
    CLOSE_TILE_ROWS,
    CLOSE_TILE_THREADS,
    DECODE_MIN_TILES,
    ENCODE_TILE_ROWS,
    MAX_DIM,
    MAX_TREE_LEAVES,
    TreeTable,
    decode_vector,
    qsgd_plan,
    shard_plan,
    tree_plan,
)
from torch_parity import jax_kernels, seeds_np  # noqa: E402,F401

FAMILIES = ["rademacher", "gaussian", "sparse_rademacher", "hadamard"]
VMAX = {"rademacher": 1.0, "hadamard": 1.0, "sparse_rademacher": 2.0,
        "gaussian": 6.7}
BLOCKS = [(8, "full"), (8, "block")]
DTYPES = ["float32", "bfloat16"]
# 1-D, ragged and 16-byte-multiple columns, a 3-D leaf.
SHAPES = [(24,), (3, 8), (10,), (2, 3, 4), (5, 12), (7,), (4, 40)]


def _shapes(n_leaves):
    return [SHAPES[i % len(SHAPES)] for i in range(n_leaves)]


def _tree(shapes, rng, dtype, lead=()):
    """{key: tensor} in sorted-key order of ``shapes``; bf16 values exact."""
    dt = getattr(torch, dtype)
    return {f"l{i:03d}": torch.from_numpy(
        (rng.randn(*lead, *sh) * 0.3).astype(np.float32)).to(dt)
        for i, sh in enumerate(shapes)}


def _to_jax(tree):
    return {k: jnp.asarray(v.to(torch.float32).numpy()).astype(
        jnp.bfloat16 if v.dtype == torch.bfloat16 else jnp.float32)
        for k, v in tree.items()}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("k,mode", BLOCKS)
def test_tree_encode_plain_is_the_per_leaf_composition(dtype, family, k, mode):
    rng = np.random.RandomState(k + len(family))
    n = 3
    d = _tree(_shapes(70), rng, dtype, lead=(n,))
    seeds = torch.from_numpy(seeds_np(rng, n).astype(np.int64))
    got = ops.project_tree_kernel(d, seeds, TD(family), k, TM(mode))
    assert got.shape == (n, k) and got.dtype == torch.float32
    leaves = tree_leaves(d)
    plan = tree_plan("encode", [x.shape[1:] for x in leaves],
                     [x.dtype for x in leaves], k, TM(mode), "cpu")
    assert [(g.start, g.stop) for g in plan.groups] == [(0, 64), (64, 70)]
    total = sum(int(np.prod(sh)) for sh in _shapes(70))
    acc = None
    for i, (ll, x) in enumerate(zip(plan.layout, leaves)):
        lo, hi = (torch.tensor(b, dtype=torch.float32) for b in
                  ops.leaf_block_bounds(ll.offset, ll.size, total, k, TM(mode)))
        r = project_blocks_plain(x.reshape(n, ll.rows, ll.cols), seeds, ll.tag,
                                 lo, hi, family, mode == "block")
        acc = r if acc is None else acc + r
    assert torch.equal(got, acc)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("k,mode", [(1, "full")] + BLOCKS)
def test_tree_encode_plain_matches_reference(dtype, family, k, mode):
    """66 leaves (two launch groups), one client."""
    rng = np.random.RandomState(3 * k + len(family))
    n = 1
    d = _tree(_shapes(66), rng, dtype, lead=(n,))
    seeds = seeds_np(rng, n)
    got = ops.project_tree_kernel(d, torch.from_numpy(seeds.astype(np.int64)),
                                  TD(family), k, TM(mode)).numpy()
    jd = _to_jax(d)
    for i in range(n):
        want = np.asarray(j_project_tree({key: v[i] for key, v in jd.items()},
                                         jnp.uint32(seeds[i]), JD(family), k,
                                         JM(mode)))
        x1 = sum(float(np.abs(_f32(v[i])).sum()) for v in d.values())
        assert np.abs(got[i] - want).max() <= 1e-6 * x1 * VMAX[family]


def _close_case(dtype, family, k, mode, n, seed, n_leaves=70):
    rng = np.random.RandomState(seed)
    p = _tree(_shapes(n_leaves), rng, dtype)
    rs = (rng.randn(n, k)).astype(np.float32)
    seeds = seeds_np(rng, n)
    got = ops.server_update_fused(p, torch.from_numpy(rs),
                                  torch.from_numpy(seeds.astype(np.int64)), 0.9,
                                  TD(family), mode=TM(mode))
    return p, rs, seeds, got


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("k,mode", BLOCKS)
def test_tree_close_plain_is_the_per_leaf_composition(dtype, family, k, mode):
    n = 19
    p, rs, seeds, got = _close_case(dtype, family, k, mode, n, 5 + k)
    rs_f, scale = ops.fold_upload_weights(torch.from_numpy(rs), 0.9, None, TM(mode),
                                          None)
    total = sum(v.numel() for v in p.values())
    offset = 0
    for key in sorted(p):
        x = p[key]
        rows, cols = (1, x.shape[0]) if x.dim() == 1 else (
            int(np.prod(x.shape[:-1])), x.shape[-1])
        lo, hi = (torch.tensor(b, dtype=torch.float32) for b in
                  ops.leaf_block_bounds(offset, x.numel(), total, k, TM(mode)))
        want = fused_reconstruct_apply(
            x.reshape(rows, cols), torch.from_numpy(seeds.astype(np.int64)), rs_f,
            sorted(p).index(key), scale, family, lo=lo, hi=hi,
            masked=mode == "block")
        assert got[key].dtype == x.dtype
        assert torch.equal(got[key].reshape(rows, cols), want)
        offset += x.numel()


@pytest.mark.parametrize("dtype,family", [("float32", "rademacher"),
                                          ("bfloat16", "hadamard"),
                                          ("float32", "gaussian"),
                                          ("bfloat16", "sparse_rademacher")])
def test_tree_close_plain_matches_reference_oracle(jax_kernels, dtype, family):
    """66 leaves (two launch groups), k = 1, N = 3 (padded to 16); each
    family once (the oracle regenerates every padded client leaf by leaf)."""
    p, rs, seeds, got = _close_case(dtype, family, 1, "full", 3, 11, n_leaves=66)
    want = jax_kernels.ref.server_update_fused_ref(
        _to_jax(p), jnp.asarray(rs), jnp.asarray(seeds), 0.9, JD(family))
    for key, w in want.items():
        a, b = _f32(got[key]), _f32(w)
        if family == "gaussian":
            ulp = 2.0 ** -7 if dtype == "bfloat16" else 0.0
            np.testing.assert_allclose(a, b, rtol=1e-5 + ulp, atol=1e-5)
        else:
            np.testing.assert_array_equal(a, b)


def test_plans_split_cache_and_bound_blocks(jax_kernels):
    shapes = _shapes(130)
    f32 = [torch.float32] * 130
    plan = tree_plan("encode", shapes, f32, 8, TM.BLOCK, "cpu")
    assert plan is tree_plan("encode", shapes, f32, 8, TM.BLOCK, "cpu")
    assert [(g.start, g.stop) for g in plan.groups] == [(0, 64), (64, 128),
                                                        (128, 130)]
    assert MAX_TREE_LEAVES == 64 and plan.masked and plan.lo.shape == (130, 8)
    total = sum(ll.size for ll in plan.layout)
    for i, ll in enumerate(plan.layout):
        lo, hi = jax_kernels.ops.leaf_block_bounds(ll.offset, ll.size, total, 8,
                                                   JM.BLOCK)
        assert plan.lo[i].tolist() == lo and plan.hi[i].tolist() == hi
    for g in plan.groups:
        table = TreeTable.from_buffer_copy(g.template)
        tiles = [-(-ll.rows // ENCODE_TILE_ROWS) for ll in plan.layout[g.start:g.stop]]
        assert table.num_leaves == g.stop - g.start
        assert table.num_tiles == g.num_tiles == sum(tiles)
        assert [table.leaf[i].tile0 for i in range(table.num_leaves)] == \
            list(np.cumsum([0] + tiles[:-1]))
        assert [table.leaf[i].tag for i in range(table.num_leaves)] == \
            list(range(g.start, g.stop))
    close = tree_plan("close", [(3, 300), (1000, 2)], [torch.bfloat16,
                                                      torch.float32], 1,
                      TM.FULL, "cpu")
    table = TreeTable.from_buffer_copy(close.groups[0].template)
    # bf16: 8 columns a thread, 256 a tile; float32: 4 and 128
    assert (table.leaf[0].col_tiles, table.leaf[1].col_tiles) == (2, 1)
    assert table.leaf[1].tile0 == 2
    assert table.num_tiles == 2 + -(-1000 // CLOSE_TILE_ROWS)
    assert not close.masked and close.lo.tolist() == [[0.0], [0.0]]
    assert close.hi.tolist() == [[900.0], [2000.0]]



# The leaves past 2³¹ elements of five reference configs (each a stacked
# (layers or periods, …) leaf of bf16): Qwen3-MoE-30B-A3B's and
# Qwen3-MoE-235B-A22B's expert w_gate/w_up, Jamba-v0.1-52B's expert
# stacks, Falcon-Mamba-7B's in_proj (2³² elements) and out_proj (2³¹),
# Minitron-8B's stacked w_up (2³¹).
LARGE_LEAVES = {"qwen3-moe-30b-a3b": (48, 128, 2048, 768),
                "qwen3-moe-235b-a22b": (94, 128, 4096, 1536),
                "jamba-v0.1-52b": (4, 16, 4096, 14336),
                "falcon-mamba-7b-in": (64, 4096, 16384),
                "falcon-mamba-7b-out": (64, 8192, 4096),
                "minitron-8b": (32, 4096, 16384)}


def _tile_to_element(table, t):
    """The kernels' walk of a flat tile (64-bit): → (leaf, first row, first
    col) of tile ``t``, as find_leaf and the closes' tile split compute it."""
    lo, hi = 0, table.num_leaves - 1
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if table.leaf[mid].tile0 <= t:
            lo = mid
        else:
            hi = mid - 1
    entry = table.leaf[lo]
    local = t - entry.tile0
    return lo, local // entry.col_tiles, local % entry.col_tiles


@pytest.mark.parametrize("kind", ["encode", "close", "decode"])
@pytest.mark.parametrize("name", list(LARGE_LEAVES))
def test_plans_take_leaves_past_the_int_range(kind, name):
    """A leaf of any number of elements is planned (its rows and cols each
    under ``MAX_DIM``): the table holds its view, and the 64-bit tile space
    walks to its last rows; a shard plan whose global index passes 2³² is
    planned with global row offsets."""
    shape = LARGE_LEAVES[name]
    rows, cols = int(np.prod(shape[:-1])), shape[-1]
    bf16 = [torch.bfloat16]
    plan = tree_plan(kind, [shape, (1000,)], bf16 + [torch.float32], 1, TM.FULL,
                     "cpu")
    table = TreeTable.from_buffer_copy(plan.groups[0].template)
    leaf = table.leaf[0]
    assert (leaf.rows, leaf.cols, leaf.orig_cols, leaf.tile0) == (rows, cols, cols, 0)
    per_row = 1 if kind == "encode" else -(-cols // (CLOSE_TILE_THREADS * 8))
    tile_rows = ENCODE_TILE_ROWS if kind == "encode" else CLOSE_TILE_ROWS
    tiles = -(-rows // tile_rows) * per_row
    assert table.leaf[1].tile0 == tiles and table.num_tiles == tiles + 1 + (
        0 if kind == "encode" else -(-1000 // (CLOSE_TILE_THREADS * 4)) - 1)
    assert _tile_to_element(table, tiles - 1) == (0, tiles // per_row - 1, per_row - 1)
    assert (tiles // per_row - 1) * tile_rows < rows <= tiles // per_row * tile_rows
    assert _tile_to_element(table, tiles)[0] == 1
    # sharded over 8 row ranges: shard 7's rows start at 7/8 of the leaf
    shards = [(0, rows // 8)]
    splan = shard_plan(kind, [shape], bf16, 8, shards, [0, 7], 1, TM.FULL, "cpu")
    assert [c[0] for c in splan.coords] == [0, 7 * (rows // 8)]
    stable = TreeTable.from_buffer_copy(splan.groups[0].template)
    assert stable.leaf[1].row_offset == 7 * (rows // 8)


@pytest.mark.parametrize("kind", ["encode", "close", "decode"])
def test_plans_refuse_views_past_the_kernels_index_range(kind):
    """What stays refused: a view with rows or cols past ``MAX_DIM``, and
    coordinates past 2³² (the uint32 (row, col) of the direction chain)."""
    bf16 = [torch.bfloat16]
    with pytest.raises(ValueError, match="passes"):
        tree_plan(kind, [(2**31, 2)], bf16, 1, TM.FULL, "cpu")
    with pytest.raises(ValueError, match="passes"):
        tree_plan(kind, [(2, 2**31)], bf16, 1, TM.FULL, "cpu")
    with pytest.raises(ValueError, match="2\\^32"):
        shard_plan(kind, [(8 * (2**29 + 1), 4)], bf16, 8, [(0, 2**29 + 1)],
                   [7], 1, TM.FULL, "cpu")
    assert tree_plan(kind, [(MAX_DIM, 2)], bf16, 1, TM.FULL, "cpu").layout


def test_qsgd_plan_still_refuses_past_the_int_range():
    """QSGD's payload offset is 64-bit: a leaf of 2³² elements plans, and so
    does a leaf at payload column 2³¹.  What stays in the kernels' int
    range is each view's rows and cols (under ``MAX_DIM``), as for the
    FedScalar kinds: the plan refuses a wider view."""
    assert qsgd_plan([(64, 4096, 16384)], [torch.bfloat16], "cpu").layout
    plan = qsgd_plan([(2**30,), (2**30,), (8,)], [torch.float32] * 3, "cpu")
    table = TreeTable.from_buffer_copy(plan.groups[0].template)
    assert [table.leaf[i].offset for i in range(3)] == [0, 2**30, 2**31]
    with pytest.raises(ValueError, match="passes"):
        qsgd_plan([(2**31,)], [torch.float32], "cpu")
    with pytest.raises(ValueError, match="passes"):
        qsgd_plan([(8, MAX_DIM + 1)], [torch.float32], "cpu")
    assert qsgd_plan([(2**20, 1024)], [torch.float32], "cpu").layout


def test_tile_space_past_2_31_tiles():
    """The table's tile fields are 64-bit: a leaf's first tile and the
    launch's tile count past 2³¹ survive the ctypes round trip."""
    table = TreeTable()
    table.num_tiles = 3 * 2**31 + 5
    table.leaf[1].tile0 = 2**32 + 7
    again = TreeTable.from_buffer_copy(bytes(table))
    assert (again.num_tiles, again.leaf[1].tile0) == (3 * 2**31 + 5, 2**32 + 7)
    assert ctypes.sizeof(TreeTable) == 3600


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rounding", [False, True])
def test_plain_slabs_change_no_bit(monkeypatch, dtype, rounding):
    """The plain versions bound their memory over a large leaf by row
    slabs: slabs of a few rows give the one-slab bits for both closes, and
    the encode's slab sums stay within float32 rounding of one sum (the
    float64 encode within 1e-12)."""
    from repro_torch.kernels import reconstruct_apply as ra
    from repro_torch.kernels import seeded_projection as sp
    from repro_torch.kernels import seeded_reconstruct as sr

    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((4, 37, 200), generator=gen).to(dt)
    params = {"a": x[0], "b": x[1, :3]}
    seeds = torch.tensor([11, 12, 13], dtype=torch.int64)
    rs = torch.randn((3, 1), generator=gen)
    one = (ops.server_update_fused(params, rs, seeds),
           ops.server_update_kernel(params, rs, seeds,
                                    per_client_rounding=rounding),
           ops.project_tree_kernel({"a": x[1:]}, seeds, TD.RADEMACHER))
    exact = sp.project_blocks_plain(x[1:], seeds, 0, torch.zeros(1),
                                    torch.full((1,), 1e9), dtype=torch.float64)
    monkeypatch.setattr(ra, "_PLAIN_SLAB_ELEMS", 3 * 16 * 200)
    monkeypatch.setattr(sr, "_PLAIN_SLAB_ELEMS", 5 * 32 * 200)
    monkeypatch.setattr(sp, "_PLAIN_GROUP_ELEMS", 7 * 200)
    slabs = (ops.server_update_fused(params, rs, seeds),
             ops.server_update_kernel(params, rs, seeds,
                                      per_client_rounding=rounding),
             ops.project_tree_kernel({"a": x[1:]}, seeds, TD.RADEMACHER))
    for key in params:
        assert torch.equal(one[0][key], slabs[0][key])
        assert torch.equal(one[1][key], slabs[1][key])
    tol = sp.encode_tolerance(x[1:], "rademacher")
    assert ((slabs[2] - one[2]).abs() <= tol).all()
    slab64 = sp.project_blocks_plain(x[1:], seeds, 0, torch.zeros(1),
                                     torch.full((1,), 1e9), dtype=torch.float64)
    assert torch.allclose(slab64, exact, rtol=1e-12, atol=1e-12)


# (k, mode, per-client rounding): the plain decode, ROUND_ONE (k = 1) and
# ROUND_ANY (k = 8), FULL and BLOCK.
DECODE_MODES = [(8, "full", False), (8, "block", False), (1, "full", True),
                (8, "full", True), (8, "block", True)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("k,mode,rounding", DECODE_MODES,
                         ids=["plain8f", "plain8b", "round1", "round8f", "round8b"])
def test_tree_decode_plain_is_the_per_leaf_composition(dtype, family, k, mode,
                                                       rounding):
    """70 leaves (two launch groups), N = 5: ``ops.server_update_kernel`` on
    the CPU against ``reconstruct_plain`` leaf by leaf with the reference's
    block bounds and the scale and divisor the train step's close uses."""
    rng = np.random.RandomState(7 * k + len(family) + rounding)
    n = 5
    p = _tree(_shapes(70), rng, dtype)
    rs = torch.from_numpy(rng.randn(n, k).astype(np.float32))
    seeds = torch.from_numpy(seeds_np(rng, n).astype(np.int64))
    got = ops.server_update_kernel(p, rs, seeds, 0.9, TD(family), mode=TM(mode),
                                   per_client_rounding=rounding)
    rs_f, scale = ops.fold_upload_weights(rs, 0.9, None, TM(mode), None)
    scale, div = (0.9, float(n)) if rounding else (scale, 1.0)
    total = sum(v.numel() for v in p.values())
    offset = 0
    for tag, key in enumerate(sorted(p)):
        x = p[key]
        rows, cols = (1, x.shape[0]) if x.dim() == 1 else (
            int(np.prod(x.shape[:-1])), x.shape[-1])
        lo, hi = (torch.tensor(b, dtype=torch.float32) for b in
                  ops.leaf_block_bounds(offset, x.numel(), total, k, TM(mode)))
        want = reconstruct_plain(x.reshape(rows, cols), seeds, rs_f, tag, scale, lo,
                                 hi, family, mode == "block" and k > 1,
                                 per_client_rounding=rounding, div=div)
        assert got[key].dtype == x.dtype
        assert torch.equal(got[key].reshape(rows, cols), want)
        offset += x.numel()


def _smollm_shapes():
    """SmolLM-360M's 11 leaves (shapes and dtypes, sorted-key order) from the
    reference's ``param_shapes``, without allocating them."""
    import jax

    from repro.configs.registry import get_config as j_get_config
    from repro.models.api import Arch as JArch

    leaves = jax.tree_util.tree_leaves(JArch(j_get_config("smollm-360m")).param_shapes())
    return ([tuple(x.shape) for x in leaves],
            [torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32
             for x in leaves])


def test_decode_plans_tile_and_choose_the_vector_width():
    mlp = [(24,), (12,), (10,), (64, 24), (24, 12), (12, 10)]
    plan = tree_plan("decode", mlp, [torch.float32] * 6, 1, TM.FULL, "cpu")
    (group,) = plan.groups
    table = TreeTable.from_buffer_copy(group.template)
    # one column a thread: every leaf is one tile wide, CLOSE_TILE_ROWS rows a tile
    tiles = [-(-ll.rows // CLOSE_TILE_ROWS) for ll in plan.layout]
    assert not group.vector and tiles == [1, 1, 1, 8, 3, 2]
    assert table.num_tiles == group.num_tiles == 16 < DECODE_MIN_TILES
    assert [table.leaf[i].tile0 for i in range(6)] == list(np.cumsum([0] + tiles[:-1]))
    assert [table.leaf[i].col_tiles for i in range(6)] == [1] * 6
    assert plan is tree_plan("decode", mlp, [torch.float32] * 6, 1, TM.FULL, "cpu")
    assert plan is not tree_plan("close", mlp, [torch.float32] * 6, 1, TM.FULL, "cpu")

    shapes, dtypes = _smollm_shapes()
    assert len(shapes) == 11 and set(dtypes) == {torch.bfloat16}
    plan = tree_plan("decode", shapes, dtypes, 1, TM.FULL, "cpu")
    (group,) = plan.groups
    table = TreeTable.from_buffer_copy(group.template)
    # bf16: V = 8 columns a thread, CLOSE_TILE_THREADS · 8 = 256 a tile
    tiles, cols = [], []
    for ll in plan.layout:
        ct = -(-ll.cols // (CLOSE_TILE_THREADS * 8))
        cols.append(ct)
        tiles.append(-(-ll.rows // CLOSE_TILE_ROWS) * ct)
    assert group.vector and sum(tiles) >= DECODE_MIN_TILES
    assert [table.leaf[i].col_tiles for i in range(11)] == cols
    assert [table.leaf[i].tile0 for i in range(11)] == list(np.cumsum([0] + tiles[:-1]))
    assert table.num_tiles == group.num_tiles == sum(tiles)

    # the rule's edge, on one float32 leaf of 8-row, 128-column tiles
    assert decode_vector([(8 * DECODE_MIN_TILES, 128, torch.float32)])
    assert not decode_vector([(8 * DECODE_MIN_TILES - 8, 128, torch.float32)])
    assert decode_vector([(8 * (DECODE_MIN_TILES // 2), 256, torch.float32)])
