"""QSGD as one tree launch (``kernels.qsgd_quant.qsgd_tree``), on the CPU.

``qsgd_tree`` quantizes every leaf of a tree for every client in one
launch of ``csrc/qsgd_quant.cu`` (the ``"qsgd"`` plan of
``kernels/tree.py``, at most 64 leaves a launch) after a norm pass, and
writes the level codes straight into the ``qsgd`` protocol's payload.  On
CPU tensors it takes ``qsgd_tree_plain``.  Held here:

* the plan: each leaf's tiles (``max(1, QSGD_TILE_ELEMS // cols)`` rows a
  tile), first tile, payload offset and first norm partial; a 70-leaf
  tree split into two launch groups; the leaf table's size and slots;
* ``qsgd_tree_plain`` against the per-leaf path it replaces (one
  ``quantize_cohort`` call per leaf, then ``torch.cat``/``torch.stack``):
  the payload and q bitwise, on the paper MLP's leaves, narrow and bf16
  leaves, and the 70-leaf tree (the same bits as one group);
* against the JAX reference: the levels bitwise equal to
  ``repro.core.qsgd.quantize_levels`` per client and leaf given the
  reference's norms; ``QSGDProtocol.encode_cohort`` against the
  reference's within the level-flip bound ‖δ‖/L (the norms may differ by
  an ulp, which can flip a level);
* a zero leaf: norm 1, zero levels;
* ``RoundSeeds`` (the protocol's (round, id)-keyed seeds, which the kernel
  derives from the client ids): its words equal ``quant_seeds``, and the
  kernel's derivation, emulated with Python ints, gives the same seeds;
* the kernel's norm, its sum order emulated in float32 with numpy, within
  ``norm_tolerance`` (h·2⁻²⁴·‖x‖, h the depth of its sum) of the float64
  norm, from one span to many.

The CUDA kernel is held against ``qsgd_tree_plain`` on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import qsgd as jq  # noqa: E402
from repro.fed import protocols as jpr  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import qsgd as tq  # noqa: E402
from repro_torch.core.projection import leaf_layout  # noqa: E402
from repro_torch.fed import protocols as tpr  # noqa: E402
from repro_torch.kernels.qsgd_quant import (  # noqa: E402
    RoundSeeds,
    norm_depth,
    norm_tolerance,
    qsgd_tree,
    qsgd_tree_plain,
)
from repro_torch.kernels.tree import (  # noqa: E402
    MAX_TREE_LEAVES,
    QSGD_NORM_UNIT_ELEMS,
    QSGD_NORM_UNITS_MAX,
    QSGD_TILE_ELEMS,
    TreeLeaf,
    TreeTable,
    qsgd_norm_units,
    qsgd_plan,
    qsgd_rows_per_tile,
)
from repro_torch.models.mlp_classifier import init_mlp  # noqa: E402
from torch_parity import Elsewhere, seeds_np  # noqa: E402

MLP = [(24,), (12,), (10,), (64, 24), (24, 12), (12, 10)]
# 1-D, ragged and 16-byte-multiple columns, a 3-D leaf, a wide leaf.
SHAPES = [(24,), (3, 8), (10,), (2, 3, 4), (5, 12), (7,), (4, 40), (3, 960)]
CASES = {"mlp": MLP, "narrow": [(4096, 2), (700, 1), (5, 3)], "mixed": SHAPES}


def _leaves(shapes, n, dtype, seed):
    rng = np.random.RandomState(seed)
    dt = getattr(torch, dtype)
    return [torch.from_numpy((rng.randn(n, *sh) * 0.02).astype(np.float32)).to(dt)
            for sh in shapes]


def _per_leaf(leaves, seeds, levels):
    """The path qsgd_tree replaces: one quantize_cohort call per leaf, then
    the payload assembled with torch.cat / torch.stack."""
    n = seeds.shape[0]
    qs, parts, norms = [], [], []
    for tag, x in enumerate(leaves):
        q, lv, nm = tq.quantize_cohort(x, seeds, levels, tag, want_q=True,
                                       want_levels=True)
        qs.append(q)
        parts.append(lv.reshape(n, -1))
        norms.append(nm)
    return qs, torch.cat(parts + [torch.stack(norms, dim=1)], dim=1)


def test_leaf_table_keeps_its_size_and_shares_two_slots():
    # a 64-bit tile count and pad before the 64 entries (csrc/tree.cuh)
    assert ctypes.sizeof(TreeLeaf) == 56 and ctypes.sizeof(TreeTable) == 16 + 64 * 56
    entry = TreeLeaf()
    # QSGD's 64-bit payload offset shares the two slots of orig_cols and
    # col_tiles; part0 has a 16-bit slot of its own
    entry.offset, entry.part0 = (7 << 32) | 1582, 40_000
    assert (entry.orig_cols, entry.col_tiles, entry.part0) == (1582, 7, 40_000)
    assert QSGD_NORM_UNITS_MAX * MAX_TREE_LEAVES <= 1 << 16


def test_qsgd_plan_past_2_31_payload_columns():
    """A leaf of 2³¹ elements and a leaf after it, at payload column 2³¹:
    the plan builds from the shapes alone (nothing is allocated), with the
    second leaf's 64-bit offset and its first norm partial after the
    first leaf's 512 spans."""
    shapes = [(65536, 32768), (8, 8)]
    plan = qsgd_plan(shapes, [torch.bfloat16] * 2, "cpu")
    table = TreeTable.from_buffer_copy(plan.groups[0].template)
    big, small = table.leaf[0], table.leaf[1]
    assert (big.offset, big.part0, big.rows, big.cols) == (0, 0, 65536, 32768)
    assert qsgd_norm_units(1 << 31)[0] == QSGD_NORM_UNITS_MAX
    assert (small.offset, small.part0) == (1 << 31, QSGD_NORM_UNITS_MAX)
    assert plan.layout[1].offset == 1 << 31
    assert small.tile0 == 65536 and table.num_tiles == 65537   # one row a tile
    assert plan.groups[0].num_parts == QSGD_NORM_UNITS_MAX + 1
    # a leaf of 2³² elements, and a view past the kernels' dimensions
    wide = qsgd_plan([(1 << 16, 1 << 16), (3,)], [torch.bfloat16] * 2, "cpu")
    assert TreeTable.from_buffer_copy(wide.groups[0].template).leaf[1].offset == 1 << 32
    with pytest.raises(ValueError, match="passes"):
        qsgd_plan([(2, 1 << 31)], [torch.float32], "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qsgd_plan_tiles_offsets_and_norm_spans(dtype):
    shapes = MLP + [(3000, 960), (262_144, 2), (5000,)]
    dt = getattr(torch, dtype)
    plan = qsgd_plan(shapes, [dt] * len(shapes), "cpu")
    assert plan is qsgd_plan(shapes, [dt] * len(shapes), "cpu")     # cached
    assert plan.kind == "qsgd" and len(plan.groups) == 1
    group = plan.groups[0]
    table = TreeTable.from_buffer_copy(group.template)
    tile0 = part0 = offset = 0
    for i, sh in enumerate(shapes):
        rows, cols = (1, sh[0]) if len(sh) == 1 else sh
        e = table.leaf[i]
        rpt = max(1, QSGD_TILE_ELEMS // cols)
        assert qsgd_rows_per_tile(cols) == rpt
        assert (e.rows, e.cols, e.tag) == (rows, cols, i)
        assert (e.tile0, e.offset, e.part0) == (tile0, offset, part0)
        assert plan.layout[i].offset == offset
        units, span = qsgd_norm_units(rows * cols)
        assert units == min(QSGD_NORM_UNITS_MAX,
                            max(1, -(-rows * cols // QSGD_NORM_UNIT_ELEMS)))
        assert span % 8 == 0 and (units - 1) * span < rows * cols <= units * span
        tile0 += -(-rows // rpt)
        part0 += units
        offset += rows * cols
    assert (table.num_leaves, table.num_tiles) == (len(shapes), tile0)
    assert (group.num_tiles, group.num_parts) == (tile0, part0)
    # the MLP's (64, 24) leaf takes 7 tiles of 10 rows and 3 norm spans; a
    # 960-wide leaf one row a tile; a large leaf the most spans
    assert [table.leaf[i].tile0 for i in range(7)] == [0, 1, 2, 3, 10, 12, 13]
    assert [table.leaf[i].part0 for i in range(7)] == [0, 1, 2, 3, 6, 7, 8]
    assert qsgd_rows_per_tile(960) == 1 and qsgd_norm_units(2_880_000)[0] == 512


def test_qsgd_plan_splits_a_70_leaf_tree():
    shapes = [SHAPES[i % len(SHAPES)] for i in range(70)]
    plan = qsgd_plan(shapes, [torch.float32] * 70, "cpu")
    assert [(g.start, g.stop) for g in plan.groups] == [(0, MAX_TREE_LEAVES), (64, 70)]
    second = TreeTable.from_buffer_copy(plan.groups[1].template)
    assert second.num_leaves == 6
    assert (second.leaf[0].tile0, second.leaf[0].part0) == (0, 0)
    assert [second.leaf[i].offset for i in range(6)] == [
        plan.layout[64 + i].offset for i in range(6)]
    assert [second.leaf[i].tag for i in range(6)] == list(range(64, 70))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tree_plain_is_the_per_leaf_path(dtype, bits, case):
    n = 9
    leaves = _leaves(CASES[case], n, dtype, bits)
    leaves[0][3] = 0.0
    seeds = torch.from_numpy(seeds_np(np.random.RandomState(bits), n).astype(np.int64))
    levels = (1 << (bits - 1)) - 1
    before = obs.totals()["qsgd.launches"]
    q, payload, norms = qsgd_tree(leaves, seeds, levels, want_q=True,
                                  want_levels=True)
    assert obs.totals()["qsgd.launches"] == before           # the CPU takes the plain path
    want_q, want_payload = _per_leaf(leaves, seeds, levels)
    assert torch.equal(payload, want_payload)
    assert torch.equal(norms, payload[:, -len(leaves):])
    for a, b, x in zip(q, want_q, leaves):
        assert a.dtype == x.dtype and a.shape == x.shape and torch.equal(a, b)
    tree = {f"l{i:02d}": x for i, x in enumerate(leaves)}
    got = tq.quantize_tree(tree, seeds, bits, batched=True)
    assert all(torch.equal(got[k], b) for k, b in zip(sorted(tree), want_q))
    q_only, none, norms_q = qsgd_tree(leaves, seeds, levels, want_q=True)
    assert none is None and torch.equal(norms_q, norms)
    assert all(torch.equal(a, b) for a, b in zip(q_only, q))


def test_70_leaf_tree_plain_is_the_per_leaf_path():
    """Two launch groups on the card; the same bits as one group."""
    n = 3
    leaves = _leaves([SHAPES[i % len(SHAPES)] for i in range(70)], n, "float32", 70)
    seeds = torch.from_numpy(seeds_np(np.random.RandomState(70), n).astype(np.int64))
    q, payload, _ = qsgd_tree(leaves, seeds, 7, want_q=True, want_levels=True)
    want_q, want_payload = _per_leaf(leaves, seeds, 7)
    assert torch.equal(payload, want_payload)
    assert all(torch.equal(a, b) for a, b in zip(q, want_q))


def _jnp(x):
    a = jnp.asarray(x.to(torch.float32).numpy())
    return a.astype(jnp.bfloat16) if x.dtype == torch.bfloat16 else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [2, 8])
def test_tree_levels_match_reference_given_its_norms(dtype, bits):
    n = 4
    shapes = MLP + [(3, 960)]
    leaves = _leaves(shapes, n, dtype, 11 + bits)
    leaves[2][1] = 0.0
    seeds = seeds_np(np.random.RandomState(bits), n)
    levels = (1 << (bits - 1)) - 1
    want_lv = np.zeros((n, sum(int(np.prod(s)) for s in shapes)), np.float32)
    ref_norms = np.zeros((n, len(shapes)), np.float32)
    for i in range(n):
        parts = []
        for tag, x in enumerate(leaves):
            lv, nm = jq.quantize_levels(_jnp(x[i]), jnp.uint32(seeds[i]), levels, tag)
            parts.append(np.asarray(lv, np.float32).reshape(-1))
            ref_norms[i, tag] = float(nm)
        want_lv[i] = np.concatenate(parts)
    _, payload, norms = qsgd_tree(leaves, torch.from_numpy(seeds.astype(np.int64)),
                                  levels, want_q=False, want_levels=True,
                                  norms=torch.from_numpy(ref_norms))
    np.testing.assert_array_equal(payload[:, :-len(shapes)].numpy(), want_lv)
    np.testing.assert_array_equal(norms.numpy(), ref_norms)
    assert ref_norms[1, 2] == 1.0


@pytest.mark.parametrize("bits", [4, 8])
def test_encode_cohort_matches_reference_within_level_flips(bits):
    """The port's protocol against the reference's (``protocols.py:330``):
    norms within 1e-6 of each other; each decoded level within ‖δ‖/L (a
    norm an ulp apart can flip a level by one)."""
    n, levels = 16, (1 << (bits - 1)) - 1
    p = init_mlp(device="cpu")
    rng = np.random.RandomState(bits)
    deltas = {k: (rng.randn(n, *v.shape) * 0.01).astype(np.float32)
              for k, v in p.items()}
    ids = np.arange(40, 40 + 3 * n, 3)
    cfg_t, cfg_j = tq.QSGDConfig(bits=bits), jq.QSGDConfig(bits=bits)
    got = tpr.make_protocol("qsgd", p, qsgd_config=cfg_t).encode_cohort(
        {k: torch.from_numpy(v) for k, v in deltas.items()}, None, 5,
        torch.from_numpy(ids)).numpy()
    pj = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    want = np.asarray(jpr.make_protocol("qsgd", pj, qsgd_config=cfg_j).encode_cohort(
        {k: jnp.asarray(v) for k, v in deltas.items()}, None, 5,
        jnp.asarray(ids, jnp.int32)))
    assert got.shape == want.shape
    d = got.shape[1] - len(p)
    np.testing.assert_allclose(got[:, d:], want[:, d:], rtol=1e-6, atol=0)
    for tag, ll in enumerate(leaf_layout(p)):
        nt, nj = got[:, d + tag, None], want[:, d + tag, None]
        a = nt * got[:, ll.offset:ll.end] / levels
        b = nj * want[:, ll.offset:ll.end] / levels
        bound = np.linalg.norm(deltas[sorted(deltas)[tag]].reshape(n, -1), axis=1)
        assert (np.abs(a - b) <= bound[:, None] / levels + 1e-9).all(), ll.shape
        # most levels agree exactly: a flip needs u within an ulp of the fraction
        assert (got[:, ll.offset:ll.end] == want[:, ll.offset:ll.end]).mean() > 0.99


def test_zero_leaf_gives_norm_one_and_zero_levels():
    leaves = [torch.zeros((5, 64, 24)), torch.ones((5, 10))]
    seeds = torch.arange(5, dtype=torch.int64)
    q, payload, norms = qsgd_tree(leaves, seeds, 127, want_q=True, want_levels=True)
    assert (norms[:, 0] == 1).all() and not payload[:, :1536].any()
    assert not q[0].any()
    torch.testing.assert_close(norms[:, 1], torch.full((5,), 10.0 ** 0.5), rtol=0,
                               atol=0)


@pytest.mark.parametrize("round_idx", [0, 7, 2**32 + 5])
def test_round_seeds_are_the_quant_seeds(round_idx):
    ids = torch.tensor([0, 5, 2**31 + 7, 2**32 - 1, 123_456_789])
    rule = tq.round_quant_seeds(round_idx, ids)
    want = tq.quant_seeds(round_idx, ids)
    assert torch.equal(rule.words(), want)
    mask = 0xFFFFFFFF

    def derived(i):          # qsgd_quant.cu's round_seed, in Python ints
        x = ((i * 0x85EBCA6B) & mask) ^ rule.round_word()
        x ^= x >> 16
        x = (x * 0x21F0AAAD) & mask
        return x ^ (x >> 15)

    assert [derived(int(i) & mask) for i in ids] == want.tolist()
    leaves = _leaves(MLP, len(ids), "float32", 4)
    a = qsgd_tree(leaves, rule, 7, want_q=True, want_levels=True)
    b = qsgd_tree(leaves, want, 7, want_q=True, want_levels=True)
    assert isinstance(rule, RoundSeeds) and torch.equal(a[1], b[1])
    assert all(torch.equal(x, y) for x, y in zip(a[0], b[0]))


def test_tree_entry_refuses_other_devices_and_empty_requests():
    with pytest.raises(ValueError, match="unsupported device"):
        qsgd_tree([torch.zeros((2, 3))], Elsewhere((2,), torch.int64), 127)
    with pytest.raises(ValueError, match="ask for"):
        qsgd_tree([torch.zeros((2, 3))], torch.zeros(2, dtype=torch.int64), 127,
                  want_q=False)


def _butterfly(s):
    """The kernel's xor butterfly over 32 lanes, float32: every lane ends
    with the same bits."""
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        s = (s + s[lanes ^ off]).astype(np.float32)
    assert (s == s[0]).all()
    return s[0]


def _kernel_norm(x, vec_width):
    """qsgd_quant.cu's norm of one (client, leaf) in float32: the norm pass
    (a warp a span; 16-byte vectors of ``vec_width`` values, or one value a
    lane with 0 for the scalar loop; two running sums a lane) and the
    quantize pass's finish (a lane's sum over the partials, the butterfly,
    the square root, zero → 1)."""
    size = x.size
    units, span = qsgd_norm_units(size)
    lanes = np.arange(32)
    parts = []
    for j in range(units):
        a, b = j * span, min((j + 1) * span, size)
        acc = [np.zeros(32, np.float32), np.zeros(32, np.float32)]
        if vec_width:
            v = vec_width
            for e0 in range(a, b, 32 * v):
                live = e0 + lanes * v < b
                for k in range(v):
                    idx = np.minimum(e0 + lanes * v + k, size - 1)
                    sq = (x[idx] * x[idx]).astype(np.float32)
                    acc[k & 1] = np.where(live, acc[k & 1] + sq, acc[k & 1]).astype(
                        np.float32)
        else:
            for e0 in range(a, b, 128):
                for u in range(4):
                    idx = e0 + lanes + 32 * u
                    live = idx < b
                    xi = x[np.minimum(idx, size - 1)]
                    sq = (xi * xi).astype(np.float32)
                    acc[u & 1] = np.where(live, acc[u & 1] + sq, acc[u & 1]).astype(
                        np.float32)
        parts.append(_butterfly((acc[0] + acc[1]).astype(np.float32)))
    s = np.zeros(32, np.float32)
    for j in range(units):
        s[j % 32] = np.float32(s[j % 32] + parts[j])
    norm = np.sqrt(_butterfly(s))
    return np.float32(1.0) if norm == 0 else norm


@pytest.mark.parametrize("size,vec", [(10, 0), (1536, 4), (1536, 8), (5000, 0),
                                      (123_456, 4), (300_000, 8)])
def test_kernel_norm_order_is_within_norm_tolerance(size, vec):
    rng = np.random.RandomState(size)
    x = (rng.randn(2, size) * np.exp(rng.randn(2, size))).astype(np.float32)
    tol = norm_tolerance(torch.from_numpy(x)).numpy()
    assert norm_depth(size) * 2.0 ** -24 * np.linalg.norm(x[0].astype(np.float64)) \
        == pytest.approx(tol[0])
    for i in range(2):
        got = float(_kernel_norm(x[i], vec))
        exact = np.linalg.norm(x[i].astype(np.float64))
        assert abs(got - exact) <= tol[i]
