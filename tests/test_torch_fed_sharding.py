"""Port parity of the mesh-sharded federation server (``sharding/fed_rules.py``).

On the CPU at small sizes, the port's sharded paths against the
reference's (``repro.sharding.fed_rules`` on the 8 host devices that
``tests/conftest.py`` forces, through the ``jax_sharding`` fixture) and
against the port's own unsharded routes, on the trees of
``tests/test_fed_sharding.py`` with the same numpy inputs:

* ``plan_tree``, ``per_shard_elements`` and ``balance`` equal for 1, 3
  and 8 shards; the view specs, the ordinal and the axis sizes;
* the sharded decode **bitwise** against the reference's ``use_kernel=
  False`` mirror for the ±1/±2 families (gaussian within 1e-6: the two
  packages' log/cos differ by ulps), and against the port's unsharded
  per-client decode for every shard count, float32 and bf16; the fused
  close bitwise against the reference's fused spec, which the reference
  holds bitwise equal to its sharded fused mirror (n = 37; BLOCK k = 3
  with hadamard), and against the port's unsharded fused close;
* the sharded encode within ``tree_encode_tolerance`` (over the shards'
  local views) of the reference's sharded encode and of the float64
  plain encode (a col-sharded 1-D leaf in BLOCK k = 2, and two leaves);
* ``server_aggregate_mesh`` with weights and block weights against
  ``server_aggregate`` within the reference's own 1e-5;
* a ``devices=[cpu] * 4`` mesh: one tree launch per device entry and the
  encode's partials summed in shard order;
* the shard plan's cache key (a local view the shape of an unsharded
  leaf gets its own offsets) and its 64-entry launch groups;
* the estimator through the sharded decode: unbiased, and the
  (d − 2 + κ) variance, 512 trials;
* ``run_federation(mesh_shape=(2, 4))`` against the reference engine's
  mesh run on one shared batch draw: the counters bitwise, params within
  1e-6, ``history["sharding"]`` equal; the digest replay holding under
  ``mesh_shape``; sync and async scheduling bitwise their mesh-less
  decode-route runs; the dense protocols refused.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.fed import costmodel as jcm  # noqa: E402
from repro.fed.runtime import engine as jengine  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import fedscalar as tfs  # noqa: E402
from repro_torch.core.directions import FAMILIES  # noqa: E402
from repro_torch.core.prng import Distribution  # noqa: E402
from repro_torch.core.projection import ProjectionMode, project_tree  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.fed import costmodel as tcm  # noqa: E402
from repro_torch.fed.runtime import engine as tengine  # noqa: E402
from repro_torch.fed.runtime import scheduler as tsched  # noqa: E402
from repro_torch.kernels import ops, tree as ktree  # noqa: E402
from repro_torch.kernels.seeded_projection import (  # noqa: E402
    project_tree_plain,
    tree_encode_tolerance,
)
from repro_torch.launch.mesh import make_fed_mesh, mesh_axes_sizes  # noqa: E402
from repro_torch.sharding import fed_rules as tfr  # noqa: E402
from torch_parity import (  # noqa: E402,F401
    STAT_KEYS,
    digits_shards,
    jax_sharding,
    mlp_params_np,
    patch_shared_draws,
)

SHAPES = ((1, 1), (1, 3), (2, 4))


def _tree_np(seed=0):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(16, 120).astype(np.float32),
            "b": rng.randn(300).astype(np.float32)}


def _uploads_np(n, k, seed=3):
    return (np.arange(n, dtype=np.uint32) + 3,
            np.random.RandomState(seed).randn(n, k).astype(np.float32))


def _t(tree_np, dtype=torch.float32):
    return {k: torch.tensor(v, dtype=dtype) for k, v in tree_np.items()}


def _seeds_t(seeds_np):
    return torch.from_numpy(seeds_np.astype(np.int64))


def _jmesh(jsh, shape):
    return jsh.mesh.make_fed_mesh(shape)


def _cpu_mesh(shape):
    return make_fed_mesh(shape, device="cpu")


def _equal_trees(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------------------
# the plan and the views
# ---------------------------------------------------------------------------

PLAN_TREES = {
    "test_tree": lambda: _tree_np(0),
    "fused_tree": lambda: {"w": np.zeros((40, 180), np.float32),
                           "b": np.zeros(100, np.float32)},
    "mlp": lambda: mlp_params_np(0),
    "narrow": lambda: {"a": np.zeros((2, 100), np.float32),
                       "s": np.zeros((), np.float32),
                       "c": np.zeros((5, 3), np.float32)},
}


@pytest.mark.parametrize("num_shards", [1, 3, 8])
@pytest.mark.parametrize("tree", list(PLAN_TREES))
def test_plan_tree_matches_reference(tree, num_shards, jax_sharding):
    p = PLAN_TREES[tree]()
    got = tfr.plan_tree(_t(p), num_shards)
    want = jax_sharding.fed_rules.plan_tree(
        {k: jnp.asarray(v) for k, v in p.items()}, num_shards)
    assert got.num_shards == want.num_shards and got.total == want.total
    assert len(got.leaves) == len(want.leaves)
    for g, w in zip(got.leaves, want.leaves):
        assert (g.axis, g.per_shard) == (w.axis, w.per_shard)
        assert (g.layout.tag, g.layout.shape, g.layout.rows, g.layout.cols,
                g.layout.offset, g.layout.size) == (
            w.layout.tag, w.layout.shape, w.layout.rows, w.layout.cols,
            w.layout.offset, w.layout.size)
    assert got.per_shard_elements() == want.per_shard_elements()
    assert got.balance() == want.balance()


def test_views_specs_and_mesh_match_reference(jax_sharding):
    jfr = jax_sharding.fed_rules
    p = _tree_np(0)
    jmesh = _jmesh(jax_sharding, (2, 4))
    mesh = _cpu_mesh((2, 4))
    plan = tfr.plan_tree(_t(p), 8)
    jplan = jfr.plan_tree({k: jnp.asarray(v) for k, v in p.items()}, 8)
    assert tfr.fed_param_specs(plan, mesh) == tuple(
        tuple(s) for s in jfr.fed_param_specs(jplan, jmesh))
    assert tfr.upload_spec() == tuple(jfr.upload_spec())
    assert tfr.num_mesh_shards(mesh) == jfr.num_mesh_shards(jmesh) == 8
    assert mesh_axes_sizes(mesh) == jax_sharding.mesh.mesh_axes_sizes(jmesh)
    assert [tfr.shard_ordinal(mesh, (i, j)) for i in range(2)
            for j in range(4)] == list(range(8))
    with pytest.raises(ValueError, match="outside"):
        tfr.shard_ordinal(mesh, (2, 0))
    views = tfr.to_sharded_2d(_t(p), plan)
    jviews = jfr.to_sharded_2d({k: jnp.asarray(v) for k, v in p.items()}, jplan)
    for v, jv in zip(views, jviews):
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    back = tfr.from_sharded_2d(tfr.shard_tree(_t(p), plan, mesh), plan, _t(p))
    assert _equal_trees(back, _t(p))
    # shard_tree's shards are fresh tensors
    t = _t(p)
    shards = tfr.shard_tree(t, plan, mesh)
    t["w"].add_(1.0)
    assert torch.equal(tfr.from_sharded_2d(shards, plan, t)["w"], _t(p)["w"])
    with pytest.raises(ValueError, match="two positive"):
        make_fed_mesh((0, 2), device="cpu")


def test_mesh_maps_shards_to_devices_in_groups():
    cpu = torch.device("cpu")
    one = _cpu_mesh((2, 4))
    assert one.devices == (cpu,)
    assert one.device_groups() == [(cpu, tuple(range(8)))]
    four = make_fed_mesh((2, 4), devices=["cpu"] * 4)
    assert [g for _, g in four.device_groups()] == [(0, 1), (2, 3), (4, 5), (6, 7)]
    many = make_fed_mesh((1, 2), devices=["cpu"] * 4)   # more devices than shards
    assert [g for _, g in many.device_groups()] == [(0,), (1,)]


# ---------------------------------------------------------------------------
# the decode and the fused close
# ---------------------------------------------------------------------------

DECODE_CASES = [   # (family, k, mode)
    ("rademacher", 1, "full"),
    ("rademacher", 2, "block"),
    ("sparse_rademacher", 2, "block"),
    ("hadamard", 3, "full"),
    ("gaussian", 2, "block"),
]


@pytest.mark.parametrize("family,k,mode", [("rademacher", 1, "full"),
                                           ("sparse_rademacher", 2, "block"),
                                           ("gaussian", 2, "block")])
def test_sharded_decode_matches_reference_mirror(family, k, mode, jax_sharding):
    """Every shard count of the port against the reference's mirror on its
    (2, 4) mesh.  The ±1/±2 cases run the mirror eagerly: under ``jax.jit``
    XLA fuses its multiply-adds, which moves bits (the reference's own
    tests allow that fusion noise); gaussian, held within 1e-6, runs
    jitted."""
    from repro.core.prng import Distribution as JDist
    from repro.core.projection import ProjectionMode as JMode

    p = _tree_np(1)
    seeds, rs = _uploads_np(6, k, seed=5)
    jmesh = _jmesh(jax_sharding, (2, 4))

    def ref(t, r, sd):
        return jax_sharding.fed_rules.sharded_server_update(
            jmesh, t, r, sd, 0.5, JDist(family), mode=JMode(mode),
            use_kernel=False)

    want = (jax.jit(ref) if family == "gaussian" else ref)(
        {k_: jnp.asarray(v) for k_, v in p.items()}, jnp.asarray(rs),
        jnp.asarray(seeds))
    for shape in SHAPES:
        got = tfr.sharded_server_update(_cpu_mesh(shape), _t(p),
                                        torch.from_numpy(rs), _seeds_t(seeds), 0.5,
                                        Distribution(family),
                                        mode=ProjectionMode(mode))
        for name in p:
            g, w = got[name].numpy(), np.asarray(want[name])
            if family == "gaussian":
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-6,
                                           err_msg=f"{name} {shape}")
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{name} {shape}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("family,k,mode", DECODE_CASES)
def test_sharded_decode_equals_unsharded_route(family, k, mode, shape, dtype):
    p = _t(_tree_np(2), dtype)
    seeds, rs = _uploads_np(9, k, seed=7)
    dist, pm = Distribution(family), ProjectionMode(mode)
    rs_t, seeds_t = torch.from_numpy(rs), _seeds_t(seeds)
    want = ops.server_update_kernel(p, rs_t, seeds_t, 0.7, dist, mode=pm)
    got = tfr.sharded_server_update(_cpu_mesh(shape), p, rs_t, seeds_t, 0.7,
                                    dist, mode=pm)
    assert _equal_trees(got, want)
    assert all(got[n].dtype == dtype for n in got)
    fused = tfr.sharded_server_update(_cpu_mesh(shape), p, rs_t, seeds_t, 0.7,
                                      dist, mode=pm, use_fused=True)
    assert _equal_trees(fused, ops.server_update_fused(p, rs_t, seeds_t, 0.7, dist,
                                                       mode=pm))


@pytest.mark.parametrize("family,k,mode", [("rademacher", 1, "full"),
                                           ("hadamard", 3, "block")])
def test_sharded_fused_matches_reference(family, k, mode, jax_sharding):
    """The cases of the reference's ``test_sharded_fused_apply_matches_
    single_device``: an awkward cohort (37, padded to 48) on a tree that is
    not tile-aligned, on a (2, 4) mesh, bitwise against the reference's
    fused spec (``server_update_fused(use_pallas=False)``), which that test
    holds bitwise equal to its sharded fused mirror.  (The mirror itself
    takes minutes eagerly on the CPU, and under ``jax.jit`` XLA fuses its
    multiply-adds.)"""
    from repro.core.prng import Distribution as JDist
    from repro.core.projection import ProjectionMode as JMode

    rng = np.random.RandomState(0)
    p = {"w": rng.randn(40, 180).astype(np.float32),
         "b": rng.randn(100).astype(np.float32)}
    n = 37
    seeds = rng.randint(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    rs = rng.randn(n, k).astype(np.float32)
    got = tfr.sharded_server_update(
        _cpu_mesh((2, 4)), _t(p), torch.from_numpy(rs), _seeds_t(seeds), 0.5,
        Distribution(family), mode=ProjectionMode(mode), use_fused=True)
    want = jax_sharding.ops.server_update_fused(
        {k_: jnp.asarray(v) for k_, v in p.items()}, jnp.asarray(rs),
        jnp.asarray(seeds), 0.5, JDist(family), mode=JMode(mode), use_pallas=False)
    for name in p:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]),
                                      err_msg=name)


def test_resident_loop_stays_sharded_and_fresh():
    """shard_tree + sharded_apply_blocks over two rounds ≡ two unsharded
    decodes; every output a new tensor on its shard's device."""
    p = _t(_tree_np(3))
    mesh = make_fed_mesh((2, 4), devices=["cpu"] * 4)
    plan = tfr.plan_tree(p, 8)
    blocks = tfr.shard_tree(p, plan, mesh)
    want = p
    for rnd in range(2):
        seeds, rs = _uploads_np(5, 1, seed=10 + rnd)
        rs_t, seeds_t = torch.from_numpy(rs), _seeds_t(seeds)
        new = tfr.sharded_apply_blocks(mesh, plan, blocks, rs_t, seeds_t, 0.5)
        assert all(a.data_ptr() != b.data_ptr()
                   for na, nb in zip(new, blocks) for a, b in zip(na, nb))
        blocks = new
        want = ops.server_update_kernel(want, rs_t, seeds_t, 0.5)
    assert _equal_trees(tfr.from_sharded_2d(blocks, plan, p), want)


def test_outputs_never_alias_the_caller_params():
    p = {"w": torch.randn(8, 16)}        # no padding at 8 shards: a view
    before = p["w"].clone()
    out = tfr.sharded_server_update(_cpu_mesh((2, 4)), p, torch.ones(2, 1),
                                    torch.tensor([1, 2]), 0.5)
    assert torch.equal(p["w"], before)
    assert out["w"].data_ptr() != p["w"].data_ptr()


def test_local_mirrors_match_reference(jax_sharding):
    """One shard's slice at global offsets: the decode mirror bitwise, the
    encode mirror within the float32 encode tolerance."""
    from repro.core.prng import block_seed as jblock_seed
    from repro.kernels.common import fold_seed as jfold
    from repro_torch.core.prng import block_seed, fold_seed

    jfr = jax_sharding.fed_rules
    rng = np.random.RandomState(4)
    x = rng.randn(6, 40).astype(np.float32)
    seeds, rs = _uploads_np(7, 2, seed=11)
    lo = np.asarray([0.0, 300.0], np.float32)
    hi = np.asarray([300.0, 800.0], np.float32)
    args = dict(row_offset=12, col_offset=0, distribution="rademacher",
                orig_cols=40, masked=True)
    got = tfr.local_reconstruct_2d(torch.from_numpy(x), _seeds_t(seeds),
                                   torch.from_numpy(rs), 0.25, 3,
                                   lo=torch.from_numpy(lo), hi=torch.from_numpy(hi),
                                   **args)
    want = jfr.local_reconstruct_2d(jnp.asarray(x), jnp.asarray(seeds),
                                    jnp.asarray(rs), 0.25, 3, lo=jnp.asarray(lo),
                                    hi=jnp.asarray(hi), **args)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    folded = torch.stack([fold_seed(block_seed(21, j), 3) for j in range(2)])
    jfolded = jnp.stack([jfold(jblock_seed(jnp.uint32(21), j), 3) for j in range(2)])
    np.testing.assert_array_equal(folded.numpy().astype(np.uint32),
                                  np.asarray(jfolded))
    gp = tfr.local_project_2d(torch.from_numpy(x), folded, lo=torch.from_numpy(lo),
                              hi=torch.from_numpy(hi), **args)
    wp = jfr.local_project_2d(jnp.asarray(x), jfolded, lo=jnp.asarray(lo),
                              hi=jnp.asarray(hi), **args)
    tol = tree_encode_tolerance([torch.from_numpy(x)[None]], "rademacher")[0]
    assert (torch.tensor(np.asarray(wp)) - gp).abs().max() <= 2 * tol


# ---------------------------------------------------------------------------
# the encode
# ---------------------------------------------------------------------------

ENCODE_TREES = {
    "col_sharded_1d": lambda: {"w": np.random.RandomState(2).randn(480)
                               .astype(np.float32)},
    "two_leaves": lambda: _tree_np(2),
}


def _shard_views(delta, plan, mesh):
    return [x[None] for ls, v in zip(plan.leaves, tfr.to_sharded_2d(delta, plan))
            for x in tfr._split(v, ls, mesh)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("tree", list(ENCODE_TREES))
def test_sharded_encode_within_tolerance(tree, shape, jax_sharding):
    from repro.core.prng import Distribution as JDist
    from repro.core.projection import ProjectionMode as JMode

    p = ENCODE_TREES[tree]()
    k, seed = 2, 21
    mesh = _cpu_mesh(shape)
    delta = _t(p)
    plan = tfr.plan_tree(delta, mesh.size)
    got = tfr.sharded_project_tree(mesh, delta, seed, Distribution.RADEMACHER, k,
                                   ProjectionMode.BLOCK)
    assert got.shape == (k,) and got.dtype == torch.float32
    tol = tree_encode_tolerance(_shard_views(delta, plan, mesh), "rademacher")[0]
    jmesh = _jmesh(jax_sharding, shape)
    want = jax.jit(lambda t: jax_sharding.fed_rules.sharded_project_tree(
        jmesh, t, seed, JDist.RADEMACHER, k, JMode.BLOCK, use_kernel=False))(
        {k_: jnp.asarray(v) for k_, v in p.items()})
    assert (got - torch.tensor(np.asarray(want))).abs().max() <= tol
    # the float64 plain encode of the unsharded tree: the exact value
    uplan = ktree.tree_plan("encode", [tuple(v.shape) for v in tree_leaves(delta)],
                            [torch.float32] * len(p), k, ProjectionMode.BLOCK, "cpu")
    exact = project_tree_plain([v[None] for v in tree_leaves(delta)],
                               torch.tensor([seed]), uplan, "rademacher",
                               dtype=torch.float64)[0]
    assert (got.double() - exact).abs().max() <= tol
    again = tfr.sharded_project_tree(mesh, delta, seed, Distribution.RADEMACHER, k,
                                     ProjectionMode.BLOCK)
    assert torch.equal(got, again)


def test_per_device_entries_and_ordered_partial_sum():
    """devices=[cpu] * 4: each device entry decodes its two shards in one
    plan of 2 · L entries; the encode sums the four partials in order."""
    p = _t(_tree_np(5))
    mesh = make_fed_mesh((2, 4), devices=["cpu"] * 4)
    seeds, rs = _uploads_np(5, 2, seed=13)
    rs_t, seeds_t = torch.from_numpy(rs), _seeds_t(seeds)
    got = tfr.sharded_server_update(mesh, p, rs_t, seeds_t, 0.5,
                                    mode=ProjectionMode.BLOCK)
    assert _equal_trees(got, ops.server_update_kernel(
        p, rs_t, seeds_t, 0.5, mode=ProjectionMode.BLOCK))
    plan = tfr.plan_tree(p, 8)
    views = [[x[None] for x in tfr._split(v, ls, mesh)]
             for ls, v in zip(plan.leaves, tfr.to_sharded_2d(p, plan))]
    groups = list(tfr._device_entries(mesh, plan, views, "encode", 2,
                                      ProjectionMode.BLOCK))
    assert [len(e) for _, _, e, _ in groups] == [2 * len(plan.leaves)] * 4
    partials = [project_tree_plain(e, torch.tensor([33]), tp)[0]
                for _, _, e, tp in groups]
    want = partials[0]
    for r in partials[1:]:
        want = want + r
    got_r = tfr.sharded_project_tree(mesh, p, 33, num_blocks=2,
                                     mode=ProjectionMode.BLOCK)
    assert torch.equal(got_r, want)


def test_server_aggregate_mesh_folds_weights():
    """The reference's ``test_sharded_weight_folding_matches_fori``: HT
    weights and block shrinkage fold as ``server_aggregate`` folds them."""
    p = _t(_tree_np(4))
    n, k = 7, 2
    seeds, rs = _uploads_np(n, k, seed=8)
    w = torch.from_numpy((np.random.RandomState(9).rand(n) / n).astype(np.float32))
    bw = torch.from_numpy(np.linspace(0.6, 1.0, k).astype(np.float32))
    cfg = tfs.FedScalarConfig(server_lr=0.7, num_projections=k,
                              mode=ProjectionMode.BLOCK)
    rs_t, seeds_t = torch.from_numpy(rs), _seeds_t(seeds)
    want = tfs.server_aggregate(p, rs_t, seeds_t, cfg, weights=w, block_weights=bw)
    got = tfs.server_aggregate_mesh(p, rs_t, seeds_t, cfg, _cpu_mesh((2, 4)),
                                    weights=w, block_weights=bw)
    for name in p:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the shard plan of the tree launches
# ---------------------------------------------------------------------------

def smollm_360m_shapes():
    """SmolLM-360M's 11 leaves in sorted-key order (its config's widths)."""
    from repro_torch.configs.registry import get_config

    c = get_config("smollm-360m")
    n, d, f, v = c.num_layers, c.d_model, c.d_ff, c.vocab_size
    kv = c.num_kv_heads * (d // c.num_heads)
    shapes = [(v, d), (d,), (n, d, kv), (n, d, d), (n, d, d), (n, d, kv),
              (n, f, d), (n, d, f), (n, d, f), (n, d), (n, d)]
    assert sum(int(np.prod(s)) for s in shapes) == 361_821_120
    return shapes


def test_shard_plan_key_offsets_and_groups():
    # a local view (2, 120) has the shape of an unsharded (2, 120) leaf
    flat = ktree.tree_plan("decode", [(2, 120)], [torch.float32], 1,
                           ProjectionMode.FULL, "cpu")
    sp = ktree.shard_plan("decode", [(16, 120)], [torch.float32], 8, [(0, 2)],
                          range(8), 1, ProjectionMode.FULL, "cpu")
    assert flat.coords == ((0, 0, 120),)
    assert sp.coords == tuple((2 * s, 0, 120) for s in range(8))
    assert [ll.rows for ll in sp.layout] == [2] * 8
    col = ktree.shard_plan("encode", [(480,)], [torch.float32], 8, [(1, 60)],
                           (3,), 2, ProjectionMode.BLOCK, "cpu")
    assert col.coords == ((0, 180, 480),) and col.layout[0].cols == 60
    assert col.lo.tolist() == [[0.0, 240.0]] and col.hi.tolist() == [[240.0, 480.0]]
    with pytest.raises(ValueError, match="QSGD"):
        ktree.shard_plan("qsgd", [(4, 4)], [torch.float32], 2, [(0, 2)], (0,), 1,
                         ProjectionMode.FULL, "cpu")
    # SmolLM-360M's 11 leaves over 8 shards: 88 entries, two launches
    shapes = smollm_360m_shapes()
    plan = tfr.plan_tree([torch.empty(s, device="meta") for s in shapes], 8)
    sp = ktree.shard_plan("decode", shapes, [torch.bfloat16] * 11, 8,
                          [(ls.axis, ls.per_shard) for ls in plan.leaves], range(8),
                          1, ProjectionMode.FULL, "cpu")
    assert [(g.start, g.stop) for g in sp.groups] == [(0, 64), (64, 88)]
    assert all(g.vector for g in sp.groups)


# ---------------------------------------------------------------------------
# the estimator through the sharded decode
# ---------------------------------------------------------------------------

_D, _TRIALS = 48, 512


@pytest.fixture(scope="module")
def estimates():
    """δ̂ for 512 seeds per family, each decoded on a (2, 4) mesh."""
    v = np.random.RandomState(0).randn(_D).astype(np.float32)
    v /= np.linalg.norm(v)
    delta = {"w": torch.from_numpy(v)}
    zeros = {"w": torch.zeros(_D)}
    mesh = _cpu_mesh((2, 4))
    plan = tfr.plan_tree(zeros, 8)
    out = {}
    for family in ("rademacher", "gaussian"):
        dist = FAMILIES[family].distribution
        seeds = torch.arange(_TRIALS, dtype=torch.int64) * 977 + 13
        est = []
        for t in range(_TRIALS):
            r = project_tree(delta, seeds[t], dist)
            est.append(tfr.sharded_server_update(
                mesh, zeros, r.reshape(1, 1), seeds[t:t + 1], 1.0, dist,
                plan=plan)["w"].numpy())
        out[family] = np.stack(est)
    return v, out


@pytest.mark.parametrize("family", ["rademacher", "gaussian"])
def test_sharded_estimator_unbiased(estimates, family):
    delta, est = estimates[0], estimates[1][family]
    err2 = float(np.sum((est.mean(axis=0) - delta) ** 2))
    expected = (_D - 2 + FAMILIES[family].kurtosis) / _TRIALS
    assert err2 < 4.0 * expected, (err2, expected)


@pytest.mark.parametrize("family", ["rademacher", "gaussian"])
def test_sharded_variance_matches_family_model(estimates, family):
    delta, est = estimates[0], estimates[1][family]
    measured = float(np.mean(np.sum((est - delta) ** 2, axis=1)))
    predicted = FAMILIES[family].predicted_variance(_D, 1, total_sqnorm=1.0)
    assert abs(measured / predicted - 1.0) < 0.25, (measured, predicted)


# ---------------------------------------------------------------------------
# the engine under mesh_shape
# ---------------------------------------------------------------------------

ROUNDS, POP, PART, SHARDS, S, B = 3, 48, 0.25, 8, 5, 32
BASE = dict(rounds=ROUNDS, population=POP, participation=PART, client_chunk=16)


@pytest.fixture(scope="module")
def digits8():
    return digits_shards(SHARDS)


def _run_port(cfg, digits8, p_np):
    clients, xte, yte = digits8
    return tengine.run_federation(cfg, params_from_jax(p_np, "cpu"), clients,
                                  xte, yte, device="cpu")


@pytest.mark.parametrize("channel", [dict(drop_prob=0.15), dict()])
def test_mesh_run_matches_reference(channel, digits8, jax_sharding, monkeypatch):
    clients, xte, yte = digits8
    patch_shared_draws(monkeypatch, clients, 79, ROUNDS, POP, S, B)
    p = mlp_params_np(5)
    ht = _run_port(tengine.RuntimeConfig(channel=tcm.ChannelConfig(**channel),
                                         mesh_shape=(2, 4), **BASE), digits8, p)
    hj = jengine.run_federation(
        jengine.RuntimeConfig(channel=jcm.ChannelConfig(**channel),
                              mesh_shape=(2, 4), **BASE),
        {k: jnp.asarray(v) for k, v in p.items()}, clients, xte, yte)
    assert not ht["fused_path"] and not hj["fused_path"]
    assert ht["sharding"] == hj["sharding"]
    assert ht["sharding"]["devices"] == 8
    for key in STAT_KEYS:
        np.testing.assert_array_equal(ht[key], hj[key], err_msg=key)
    np.testing.assert_allclose(ht["loss"], hj["loss"], rtol=1e-5)
    for k in p:
        np.testing.assert_allclose(ht["final_params"][k].numpy(),
                                   np.asarray(hj["final_params"][k]), rtol=0,
                                   atol=1e-6, err_msg=k)


MESH_CASES = {   # name -> (RuntimeConfig fields, SchedulerConfig fields or None)
    "legacy_digest_replay": (dict(downlink_mode="digest", verify_replay=True,
                                  channel=dict(drop_prob=0.1)), None),
    "sync": (dict(channel=dict(drop_prob=0.15)), dict(mode="sync")),
    "sync_digest_replay": (dict(downlink_mode="digest", verify_replay=True),
                           dict(mode="sync")),
    "async": (dict(eval_every=10**6, channel=dict(base_latency_s=0.05,
                                                  lognormal_sigma=0.5)),
              dict(mode="async", period_s=0.004, max_rounds_in_flight=4,
                   quorum_frac=0.5, staleness_window=2)),
    "async_block2": (dict(num_projections=2, projection_mode="block",
                          eval_every=10**6,
                          channel=dict(base_latency_s=0.05, lognormal_sigma=0.5)),
                     dict(mode="async", period_s=0.004, max_rounds_in_flight=4,
                          quorum_frac=0.5, staleness_window=2)),
}


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_mesh_run_bitwise_its_decode_route_run(case, digits8):
    """Under ``mesh_shape`` the run is the mesh-less run on the per-client
    decode route, bit for bit (the shadow replay, pinned to the decode
    kernel, holds); the scheduler carries the route unchanged."""
    kw, sched = MESH_CASES[case]
    kw = dict(kw)
    ch = tcm.ChannelConfig(**kw.pop("channel", {}))
    base = dict(BASE, rounds=4, seed=2, channel=ch,
                scheduler=tsched.SchedulerConfig(**sched) if sched else None, **kw)
    p = mlp_params_np(3)
    h_mesh = _run_port(tengine.RuntimeConfig(mesh_shape=(2, 4), **base), digits8, p)
    h_rec = _run_port(tengine.RuntimeConfig(kernel_cohort_threshold=1, **base),
                      digits8, p)
    assert h_mesh["sharding"]["devices"] == 8 and h_rec["sharding"] is None
    assert (h_mesh["applied"] > 0).any()
    for k in p:
        assert torch.equal(h_mesh["final_params"][k], h_rec["final_params"][k]), k
    for key in STAT_KEYS:
        np.testing.assert_array_equal(h_mesh[key], h_rec[key], err_msg=key)
    if sched is not None:
        assert h_mesh["scheduler"]["mode"] == sched["mode"]


@pytest.mark.parametrize("protocol", ["fedavg", "qsgd"])
def test_dense_protocols_refuse_mesh_shape(protocol, digits8):
    clients, xte, yte = digits8
    cfg = dict(rounds=1, population=16, participation=0.5, mesh_shape=(2, 4),
               protocol_name=protocol)
    with pytest.raises(ValueError, match="cannot use mesh_shape"):
        _run_port(tengine.RuntimeConfig(**cfg), digits8, mlp_params_np(0))
    with pytest.raises(ValueError, match="cannot use mesh_shape"):
        jengine.run_federation(jengine.RuntimeConfig(**cfg),
                               {k: jnp.asarray(v)
                                for k, v in mlp_params_np(0).items()},
                               clients, xte, yte)
