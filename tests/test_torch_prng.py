"""Port parity: the SplitMix32 direction chain of ``repro_torch.core.prng``.

Same inputs (numpy, seeded) through ``repro.core.prng`` and the port.
Bitwise for the chain, the seed derivations and the three ±1/±2
families; gaussian within rtol 1e-6 / atol 1e-6, because ``log`` and
``cos`` may differ by an ulp between XLA and torch.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import fedscalar as jfs  # noqa: E402
from repro.core import prng as jp  # noqa: E402
from repro.kernels import common as jc  # noqa: E402
from repro_torch.core import fedscalar as tfs  # noqa: E402
from repro_torch.core import prng as tp  # noqa: E402
from repro_torch.kernels import common as tc  # noqa: E402

FAMILIES = ["rademacher", "gaussian", "sparse_rademacher", "hadamard"]
SEEDS = [0, 1, 12345, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]


def _words(n, seed=0):
    w = np.random.RandomState(seed).randint(0, 2**32, size=n, dtype=np.uint64)
    return np.concatenate([w.astype(np.uint32),
                           np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF],
                                    np.uint32)])


def _np(t):
    return t.numpy().astype(np.uint32)


def _assert_values(a, b, family):
    a, b = np.asarray(a), b.numpy()
    assert a.shape == b.shape and a.dtype == b.dtype
    if family == "gaussian":
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(b, a)


def test_splitmix_hash_parity_bitwise():
    x = _words(4096)
    np.testing.assert_array_equal(
        _np(tp.splitmix32(tp.u32(x))), np.asarray(jp.splitmix32(jnp.asarray(x))))
    np.testing.assert_array_equal(
        _np(tp.parity32(tp.u32(x))), np.asarray(jp.parity32(jnp.asarray(x))))
    hi, lo = _words(64, 1), _words(64, 2)
    for tag in (0, 0x9E3779B9, 0xFFFFFFFF):
        want = np.asarray(jp.hash_u32(jnp.asarray(x[:69]), jnp.asarray(hi),
                                      jnp.asarray(lo), tag))
        got = _np(tp.hash_u32(tp.u32(x[:69]), tp.u32(hi), tp.u32(lo), tag))
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tp.uniform01(tp.u32(x)).numpy(), np.asarray(jp.uniform01(jnp.asarray(x))))


def test_mul32_low_bits_exact():
    x = _words(2048, 3)
    for c in (0x9E3779B9, 0x85EBCA6B, 0xFFFFFFFF, 3):
        want = (x.astype(np.uint64) * np.uint64(c)) & np.uint64(0xFFFFFFFF)
        np.testing.assert_array_equal(_np(tp.mul32(tp.u32(x), c)),
                                      want.astype(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_block_and_fold_seed_bitwise(seed):
    for j in (0, 1, 7, 0xFFFFFFFF):
        assert int(tp.block_seed(seed, j)) == int(jp.block_seed(seed, j))
    for tag in (0, 1, 5, 1 << 20):
        assert int(tp.fold_seed(seed, tag)) == int(jp.fold_seed(seed, tag))


@pytest.mark.parametrize("round_idx", [0, 1, 999, 0x7FFFFFFF, 0xFFFFFFFF])
def test_round_seeds_for_bitwise(round_idx):
    ids = _words(300, round_idx & 0xFFFF)
    for salt in (0x5EED, 0, 0xFFFFFFFF):
        want = np.asarray(jfs.round_seeds_for(round_idx, jnp.asarray(ids), salt))
        got = _np(tfs.round_seeds_for(round_idx, ids, salt))
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        _np(tfs.round_seeds(round_idx, 20)),
        np.asarray(jfs.round_seeds(round_idx, 20)))


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("shape", [(), (37,), (5, 9), (3, 4, 6)])
def test_random_for_shape_parity(family, shape):
    for seed in (0, 12345, 0xFFFFFFFF):
        for tag in (0, 3):
            want = jp.random_for_shape(shape, seed, tag, jp.Distribution(family))
            got = tp.random_for_shape(shape, seed, tag, tp.Distribution(family))
            _assert_values(want, got, family)


@pytest.mark.parametrize("family", FAMILIES)
def test_random_flat_parity_across_index_carry(family):
    # base near a 2**16 and a 2**32 boundary exercises the (hi, lo) carry.
    for base in (0, (1 << 16) - 7, (1 << 32) - 11, (1 << 40) + 3):
        want = jp.random_flat(77, base, 300, jp.Distribution(family))
        got = tp.random_flat(77, base, 300, tp.Distribution(family))
        _assert_values(want, got, family)


@pytest.mark.parametrize("family", FAMILIES)
def test_factored_chain_equals_random_for_shape(family):
    """row_state/tile_from_state re-bracket the chain: identical values."""
    rows, cols, tag = 11, 37, 2
    for seed in (0, 99, 0xFFFFFFFF):
        s = tp.fold_seed(tp.block_seed(seed, 3), tag)
        row = torch.arange(rows)[:, None]
        col = torch.arange(cols)[None, :]
        got = tc.gen_tile(s, row, col, family)
        want = tp.random_for_shape((rows, cols), tp.block_seed(seed, 3), tag,
                                   tp.Distribution(family))
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        ref = jc.gen_tile(jc.fold_seed(jp.block_seed(seed, 3), tag),
                          np.arange(rows, dtype=np.uint32)[:, None],
                          np.arange(cols, dtype=np.uint32)[None, :], family)
        _assert_values(ref, got, family)


def test_moments_and_bit_balance():
    n = 200_000
    v = tp.random_flat(42, 0, n, tp.Distribution.RADEMACHER).numpy()
    assert set(np.unique(v)) == {-1.0, 1.0}
    assert abs(v.mean()) < 0.01 and abs(v.var() - 1.0) < 0.01
    g = tp.random_flat(42, 0, n, tp.Distribution.GAUSSIAN).numpy()
    assert np.isfinite(g).all()
    assert abs(g.mean()) < 0.01 and abs(g.var() - 1.0) < 0.02
    assert abs((g ** 4).mean() - 3.0) < 0.1
    s = tp.random_flat(42, 0, n, tp.Distribution.SPARSE_RADEMACHER).numpy()
    assert abs(s.var() - 1.0) < 0.03 and abs((s != 0).mean() - 0.25) < 0.01
    bits = _np(tp.hash_u32(tp.u32(7), torch.arange(4096), tp.u32(0), 1))
    for b in range(32):
        assert 0.45 < ((bits >> b) & 1).mean() < 0.55, f"bit {b} unbalanced"
