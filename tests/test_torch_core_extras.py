"""Port parity of the reference's remaining core surface, and its estimator laws.

* ``family_of`` and ``predicted_estimator_variance`` equal the
  reference's for every family and mode (the paper's Prop. 2.1
  variance model); ``rademacher_flat`` and ``random_like`` for the
  ±1/±2 families are **bitwise**; ``gaussian_flat`` (and ``random_like``
  of the gaussian family) within rtol 1e-6 / atol 1e-6, because ``log``
  and ``cos`` may differ by an ulp between XLA and torch;
  ``project_reconstruct_mean`` within atol 1e-6; the paper MLP's
  ``ModelConfig`` field for field.
* The estimator statistics, port side only: the reference's
  ``tests/test_statistical.py`` fails to import under jax 0.9
  (``repro.kernels``), so these are its fast-tier checks run on the
  port alone: the QSGD quantizer unbiased and within the Alistarh et
  al. second-moment bound, and the fused close's estimator unbiased with
  (d − 2 + κ)‖g‖² variance for every family.
* ``tests/test_prop21_identity.py``'s per-coordinate identity
  Var_gauss − Var_rad = 2·diag(δ²), on the port's encode (the
  reference's own test still runs beside it).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import paper_mlp as j_paper_mlp  # noqa: E402
from repro.core import fedscalar as jfs  # noqa: E402
from repro.core import prng as jp  # noqa: E402
from repro.core import projection as jproj  # noqa: E402
from repro_torch.configs import paper_mlp as t_paper_mlp  # noqa: E402
from repro_torch.core import fedscalar as tfs  # noqa: E402
from repro_torch.core import prng as tp  # noqa: E402
from repro_torch.core import projection as tproj  # noqa: E402
from repro_torch.core import qsgd as tq  # noqa: E402
from repro_torch.core.directions import FAMILIES  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from torch_parity import mlp_params_np  # noqa: E402

SEEDS = [0, 1, 12345, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]
# flat bases across the 16-bit lo/hi split of the index
BASES = [(0, 1), (0, 257), (65530, 40), (65536, 3), (3 * 65536 + 17, 1000)]
MODES = {"full_k1": (1, "full"), "full_k4": (4, "full"), "block_k4": (4, "block")}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_and_predicted_variance_match_reference(family, mode):
    k, m = MODES[mode]
    tcfg = tfs.FedScalarConfig(distribution=FAMILIES[family].distribution,
                               num_projections=k, mode=tproj.ProjectionMode(m))
    jcfg = jfs.FedScalarConfig(distribution=jp.Distribution(family),
                               num_projections=k, mode=jproj.ProjectionMode(m))
    tfam, jfam = tfs.family_of(tcfg), jfs.family_of(jcfg)
    assert (tfam.name, tfam.kurtosis) == (jfam.name, jfam.kurtosis)
    p = mlp_params_np(0)
    tparams = {n: torch.from_numpy(v) for n, v in p.items()}
    jparams = {n: jnp.asarray(v) for n, v in p.items()}
    for sq in (1.0, 0.37):
        assert (tfs.predicted_estimator_variance(tcfg, tparams, sq)
                == jfs.predicted_estimator_variance(jcfg, jparams, sq))


@pytest.mark.parametrize("seed", SEEDS)
def test_rademacher_and_gaussian_flat_match_reference(seed):
    for base, n in BASES:
        want = np.asarray(jp.rademacher_flat(jnp.uint32(seed), base, n))
        got = tp.rademacher_flat(seed, base, n, device="cpu")
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
        want = np.asarray(jp.gaussian_flat(jnp.uint32(seed), base, n))
        got = tp.gaussian_flat(seed, base, n, device="cpu").numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the sign is bit 8 of the U1-tagged hash
    bits = tp.hash_u32(tp.u32(seed), torch.zeros(64, dtype=torch.int64),
                       torch.arange(64), 0x9E3779B9)
    np.testing.assert_array_equal(
        tp.rademacher_flat(seed, 0, 64).numpy(),
        np.where(((bits.numpy() >> 8) & 1) == 1, 1.0, -1.0))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_random_like_matches_reference(family):
    dist = FAMILIES[family].distribution
    leaf = torch.zeros(7, 9, 5)
    for seed in SEEDS[:4]:
        for base in (0, 65531):
            got = tp.random_like(leaf, seed, base, dist)
            want = np.asarray(jp.random_like(jnp.zeros((7, 9, 5)), jnp.uint32(seed),
                                             base, jp.Distribution(family)))
            assert tuple(got.shape) == want.shape and got.device == leaf.device
            if family == "gaussian":
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
            else:
                np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("family", ["rademacher", "gaussian"])
def test_project_reconstruct_mean_matches_reference(family, mode):
    k, m = MODES[mode]
    rng = np.random.RandomState(4)
    shapes = {"w": (12, 10), "b": (10,), "v": (3, 4, 5)}
    deltas = [{n: (0.1 * rng.randn(*s)).astype(np.float32)
               for n, s in shapes.items()} for _ in range(5)]
    seeds = [int(s) for s in rng.randint(0, 2**32, size=5, dtype=np.uint64)]
    got = tproj.project_reconstruct_mean(
        [{n: torch.from_numpy(v) for n, v in d.items()} for d in deltas],
        seeds, FAMILIES[family].distribution, k, tproj.ProjectionMode(m))
    want = jproj.project_reconstruct_mean(
        [{n: jnp.asarray(v) for n, v in d.items()} for d in deltas],
        [jnp.uint32(s) for s in seeds], jp.Distribution(family), k,
        jproj.ProjectionMode(m))
    for n in shapes:
        assert got[n].dtype == torch.float32
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                   rtol=0, atol=1e-6, err_msg=n)
    with pytest.raises(ValueError, match="seeds"):
        tproj.project_reconstruct_mean([deltas[0]], seeds[:2])


def test_paper_mlp_config_matches_reference():
    t, j = t_paper_mlp.CONFIG, j_paper_mlp.CONFIG
    td = dataclasses.asdict(t)
    assert td.pop("partial_rotary_factor") == 1.0     # the port's own field
    assert td == dataclasses.asdict(j)
    assert t.arch_type == "mlp" and t.torch_dtype == torch.float32
    from repro_torch.configs import registry

    assert t.name not in registry.CONFIGS          # unregistered, as in the reference
    with pytest.raises(KeyError, match="not registered"):
        registry.get_config(t.name)


# ---------------------------------------------------------------------------
# estimator statistics (tests/test_statistical.py's fast tier, port side)
# ---------------------------------------------------------------------------

def _mc_mean_and_mse(x: torch.Tensor, levels: int, n_seeds: int):
    """Monte Carlo E[Q(x)] and E‖Q(x) − x‖² over the hash-seed ensemble."""
    xs = x.unsqueeze(0).expand(n_seeds, -1).contiguous()
    qs, _, _ = tq.quantize_cohort(xs, torch.arange(n_seeds), levels)
    qs = qs.double()
    mean = qs.mean(dim=0)
    mse = float(((qs - x.double()[None, :]) ** 2).sum(dim=1).mean())
    return mean.numpy(), mse


_DIST_SEEDS = {"gaussian": 11, "uniform": 22, "heavy": 33}


@pytest.mark.parametrize("dist", sorted(_DIST_SEEDS))
def test_qsgd_quantizer_unbiased(dist):
    """E[Q(x)] = x for light- and heavy-tailed leaves (300 seeds)."""
    rng = np.random.RandomState(_DIST_SEEDS[dist])
    d = 512
    if dist == "gaussian":
        xv = rng.randn(d)
    elif dist == "uniform":
        xv = rng.uniform(-3, 3, d)
    else:                              # a few dominant coordinates
        xv = rng.standard_t(1.5, d)
    x = torch.as_tensor(xv, dtype=torch.float32)
    mean, _ = _mc_mean_and_mse(x, levels=127, n_seeds=300)
    # per-coordinate MC std ≤ ‖x‖/(s·√n); compare against the ∞-norm
    tol = 5.0 * float(torch.linalg.vector_norm(x)) / (127 * np.sqrt(300))
    err = np.max(np.abs(mean - x.double().numpy()))
    assert err < tol, (dist, err, tol)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("d", [33, 512])
def test_qsgd_variance_bound(bits, d):
    """E‖Q(x) − x‖² ≤ min(d/s², √d/s)·‖x‖²  (QSGD Lemma 3.1)."""
    s = (1 << (bits - 1)) - 1
    x = torch.as_tensor(np.random.RandomState(d + bits).randn(d), dtype=torch.float32)
    _, mse = _mc_mean_and_mse(x, levels=s, n_seeds=400)
    bound = min(d / s**2, np.sqrt(d) / s) * float(torch.sum(x.double() ** 2))
    # 400-seed MC noise on the MSE is ≪ the bound's slack; 5% headroom
    assert mse <= 1.05 * bound, (mse, bound)


_FUSED_STAT_ROWS, _FUSED_STAT_COLS = 4, 32
_FUSED_STAT_D = _FUSED_STAT_ROWS * _FUSED_STAT_COLS


@functools.lru_cache(maxsize=None)
def _fused_estimates(family: str, trials: int):
    """(T, d) fused-close estimates of a fixed unit-norm target, and the target."""
    dist = FAMILIES[family].distribution
    rng = np.random.RandomState(0)
    g = rng.randn(_FUSED_STAT_ROWS, _FUSED_STAT_COLS)
    g /= np.linalg.norm(g)
    delta = torch.as_tensor(g, dtype=torch.float32)
    zeros = {"w": torch.zeros(_FUSED_STAT_ROWS, _FUSED_STAT_COLS)}
    seeds = torch.arange(trials, dtype=torch.int64) + 7
    rs = ops.project_tree_kernel(
        {"w": delta.unsqueeze(0).expand(trials, -1, -1).contiguous()}, seeds, dist)
    est = np.stack([
        ops.server_update_fused(zeros, rs[t].reshape(1, 1), seeds[t].reshape(1),
                                1.0, dist)["w"].numpy()
        for t in range(trials)])
    return est.reshape(trials, -1).astype(np.float64), g.ravel()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_fused_estimator_unbiased(family):
    """E[rv] = g through the fused close (1024 fixed seeds, every family)."""
    est, g = _fused_estimates(family, 1024)
    err2 = float(np.sum((est.mean(axis=0) - g) ** 2))
    # E‖mean − g‖² = (d − 2 + κ)/T for unit ‖g‖; allow 4× MC headroom
    expected = FAMILIES[family].predicted_variance(
        _FUSED_STAT_D, 1, total_sqnorm=1.0) / 1024
    assert err2 < 4.0 * expected, (family, err2, expected)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_fused_estimator_variance_matches_family_model_fast(family):
    """E‖rv − g‖² tracks (d − 2 + κ)‖g‖² within 15% at T=1024 (fast tier)."""
    est, g = _fused_estimates(family, 1024)
    measured = float(np.mean(np.sum((est - g) ** 2, axis=1)))
    predicted = FAMILIES[family].predicted_variance(
        _FUSED_STAT_D, 1, total_sqnorm=1.0)
    assert abs(measured / predicted - 1.0) < 0.15, (family, measured, predicted)


# ---------------------------------------------------------------------------
# Prop. 2.1, per coordinate (tests/test_prop21_identity.py on the port)
# ---------------------------------------------------------------------------

PROP_D, PROP_TRIALS = 12, 150_000


def _coordinate_variance(dw: np.ndarray, dist) -> np.ndarray:
    """Per-coordinate variance of r·v over PROP_TRIALS seeds: r from the
    port's batched encode of δ, v from the same encode of the unit basis
    (⟨e_m, v⟩ = v_m)."""
    seeds = torch.arange(PROP_TRIALS, dtype=torch.int64)

    def encode(vec):
        x = torch.as_tensor(vec, dtype=torch.float32)
        return ops.project_tree_kernel(
            {"w": x.unsqueeze(0).expand(PROP_TRIALS, -1).contiguous()},
            seeds, dist)[:, 0].double()

    r = encode(dw)
    v = torch.stack([encode(np.eye(PROP_D)[m]) for m in range(PROP_D)], dim=1)
    return torch.var(r[:, None] * v, dim=0, unbiased=False).numpy()


def test_prop21_corrected_identity_per_coordinate():
    rng = np.random.RandomState(3)
    dw = rng.randn(PROP_D).astype(np.float32)
    vg = _coordinate_variance(dw, tp.Distribution.GAUSSIAN)
    vr = _coordinate_variance(dw, tp.Distribution.RADEMACHER)
    diff = vg - vr
    want = 2.0 * dw.astype(np.float64) ** 2        # corrected: 2·diag(δ²)
    tol = 0.15 * float(np.sum(dw.astype(np.float64) ** 2))
    np.testing.assert_allclose(diff, want, atol=tol)
    # …and the paper's constant (2‖δ‖² on every coordinate) does not fit
    paper = 2.0 * float(np.sum(dw.astype(np.float64) ** 2)) * np.ones(PROP_D)
    assert np.abs(diff - paper).max() > 5 * tol
    assert abs(diff.sum() - 2.0 * float(np.sum(dw.astype(np.float64) ** 2))) \
        < PROP_D * tol / 2
    # the model behind predicted_estimator_variance: the trace gap is κ_g − κ_r
    cfg_g = tfs.FedScalarConfig(distribution=tp.Distribution.GAUSSIAN)
    cfg_r = tfs.FedScalarConfig(distribution=tp.Distribution.RADEMACHER)
    w = {"w": torch.zeros(PROP_D)}
    assert (tfs.predicted_estimator_variance(cfg_g, w)
            - tfs.predicted_estimator_variance(cfg_r, w)) == 2.0
