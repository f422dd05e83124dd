"""Port parity: leaf layout, ``project_tree`` and ``reconstruct_tree``.

Same numpy inputs through ``repro.core`` and ``repro_torch.core``.
``project_tree`` leaves its sum order open, so |Δr| ≤ 1e-6·Σ|δ|.
``reconstruct_tree`` is elementwise with a fixed order: bitwise for the
±1/±2 families, gaussian within rtol/atol 1e-6 (``log``/``cos`` ulps).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import directions as jd  # noqa: E402
from repro.core import projection as jproj  # noqa: E402
from repro.core.prng import Distribution as JD  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import directions as td  # noqa: E402
from repro_torch.core import projection as tproj  # noqa: E402
from repro_torch.core.prng import Distribution as TD  # noqa: E402
from torch_parity import mlp_params_np  # noqa: E402

FAMILIES = ["rademacher", "gaussian", "sparse_rademacher", "hadamard"]
MODES = [(1, "full"), (8, "full"), (8, "block")]


def _trees(seed=0):
    p = mlp_params_np(seed)
    return p, {k: jnp.asarray(v) for k, v in p.items()}, params_from_jax(p, "cpu")


def test_leaf_layout_matches_reference():
    p, pj, pt = _trees()
    want = jproj.leaf_layout(pj)
    got = tproj.leaf_layout(pt)
    assert [(l.tag, l.shape, l.rows, l.cols, l.offset, l.size) for l in got] \
        == [(l.tag, l.shape, l.rows, l.cols, l.offset, l.size) for l in want]
    # sorted keys: b0, b1, b2, w0, w1, w2
    assert [l.shape for l in got] == [(24,), (12,), (10,), (64, 24), (24, 12),
                                      (12, 10)]
    assert tproj.tree_size(pt) == jproj.tree_size(pj) == 1990


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("k,mode", MODES)
def test_project_tree_parity(family, k, mode):
    p, pj, pt = _trees(1)
    l1 = sum(np.abs(v).sum() for v in p.values())
    for seed in (3, 0xFFFFFFFF):
        want = np.asarray(jproj.project_tree(pj, seed, JD(family), k,
                                             jproj.ProjectionMode(mode)))
        got = tproj.project_tree(pt, seed, TD(family), k,
                                 tproj.ProjectionMode(mode)).numpy()
        assert got.shape == (k,) and got.dtype == np.float32
        assert np.abs(got - want).max() <= 1e-6 * l1


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("k,mode", MODES)
def test_reconstruct_tree_parity(family, k, mode):
    p, pj, pt = _trees(2)
    r = np.random.RandomState(5).randn(k).astype(np.float32)
    bw = np.linspace(0.5, 1.0, k).astype(np.float32)
    for block_weights in (None, bw):
        want = jproj.reconstruct_tree(
            pj, 11, jnp.asarray(r), JD(family), k, jproj.ProjectionMode(mode),
            scale=0.3, block_weights=None if block_weights is None
            else jnp.asarray(block_weights))
        got = tproj.reconstruct_tree(
            pt, 11, torch.from_numpy(r), TD(family), k,
            tproj.ProjectionMode(mode), scale=0.3,
            block_weights=None if block_weights is None
            else torch.from_numpy(block_weights))
        assert set(got) == set(want)
        for key in p:
            a, b = np.asarray(want[key]), got[key].numpy()
            assert a.shape == b.shape and a.dtype == b.dtype
            if family == "gaussian":
                np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)
            else:
                np.testing.assert_array_equal(b, a)


def test_block_geometry_and_weights_match_reference():
    for total, k in ((1990, 8), (17, 3), (5, 8)):
        assert td.block_dims(total, k) == jd.block_dims(total, k)
    fam_t, fam_j = td.get_family("sparse_rademacher"), jd.get_family("sparse_rademacher")
    assert fam_t.predicted_variance(1990, 8) == fam_j.predicted_variance(1990, 8)
    assert fam_t.bits_per_upload(8) == fam_j.bits_per_upload(8)
    args = ("gaussian", 1990, 4, [1.0, 2.0, 0.5, 0.0], [3.0, 1.0, 2.0, 0.0], 20)
    np.testing.assert_array_equal(td.optimal_block_weights(*args),
                                  jd.optimal_block_weights(*args))
    p, pj, pt = _trees(3)
    np.testing.assert_allclose(td.tree_block_sqnorms(pt, 8),
                               jd.tree_block_sqnorms(pj, 8), rtol=1e-12)
    with pytest.raises(ValueError):
        td.check_block_mask_domain((1 << 24) + 1)
