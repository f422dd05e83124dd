"""Port parity: the MLP, one FedScalar round, and the simulation loop.

Tolerances, with their reasons:

* ``mlp_loss`` / ``mlp_grad`` against ``jax.grad``: rtol 1e-5 (float32
  matmul and log-softmax, summed in other orders).
* One ``fedscalar_round`` on identical numpy batches: the uploaded
  scalars within |Δr| ≤ 1e-6·Σ|δ| (the projection's open sum order;
  the deltas themselves agree to a few float32 ulps), the new params
  within atol 1e-6 of both the reference's fori round and the
  reference's composition with ``ops.server_update_fused``, and with
  error feedback the new residuals within atol 1e-6.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import fedscalar as jfs  # noqa: E402
from repro.core import projection as jproj  # noqa: E402
from repro.data import load_digits as j_load_digits  # noqa: E402
from repro.data import make_client_datasets as j_make_clients  # noqa: E402
from repro.data import train_test_split_arrays as j_split  # noqa: E402
from repro.fed import simulation as jsim  # noqa: E402
from repro.fed.costmodel import CostModel as JCostModel  # noqa: E402
from repro.models import mlp_classifier as jmlp  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.core import fedscalar as tfs  # noqa: E402
from repro_torch.data import load_digits, make_client_datasets  # noqa: E402
from repro_torch.data import train_test_split_arrays  # noqa: E402
from repro_torch.fed import simulation as tsim  # noqa: E402
from repro_torch.fed.costmodel import ChannelConfig, CostModel  # noqa: E402
from repro_torch.models import mlp_classifier as tmlp  # noqa: E402
from torch_parity import jax_kernels, mlp_params_np  # noqa: E402,F401

METHODS = ["fedscalar_rademacher", "fedscalar_gaussian", "fedscalar_block8",
           "fedscalar_m8", "fedscalar_ef"]


def _batch(seed, lead=(), b=32):
    rng = np.random.RandomState(seed)
    x = (rng.rand(*lead, b, 64) * 16).astype(np.float32)
    y = rng.randint(0, 10, size=(*lead, b)).astype(np.int32)
    return x, y


def test_data_copies_match_reference():
    xa, ya = j_load_digits(300, seed=4)
    xb, yb = load_digits(300, seed=4)
    np.testing.assert_array_equal(xa, xb)
    np.testing.assert_array_equal(ya, yb)
    for scheme in ("iid", "dirichlet"):
        a = j_make_clients(xa, ya, 5, scheme=scheme)
        b = make_client_datasets(xb, yb, 5, scheme=scheme)
        for (x1, y1), (x2, y2) in zip(a, b):
            np.testing.assert_array_equal(x1, x2)
            np.testing.assert_array_equal(y1, y2)


def test_init_mlp_equal_weights():
    want = {k: np.asarray(v) for k, v in jmlp.init_mlp(seed=3).items()}
    got = params_to_numpy(tmlp.init_mlp(seed=3, device="cpu"))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_mlp_loss_grad_accuracy_match_jax():
    p = mlp_params_np(5)
    x, y = _batch(0)
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = params_from_jax(p, "cpu")
    bt = (torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(
        float(tmlp.mlp_loss(pt, bt)), float(jmlp.mlp_loss(pj, (x, y))), rtol=1e-5)
    gj = jmlp.mlp_grad(pj, (jnp.asarray(x), jnp.asarray(y)))
    gt = tmlp.mlp_grad(pt, bt)
    for k in p:
        np.testing.assert_allclose(gt[k].numpy(), np.asarray(gj[k]), rtol=1e-5,
                                   atol=1e-7)
    np.testing.assert_allclose(float(tmlp.mlp_accuracy(pt, *bt)),
                               float(jmlp.mlp_accuracy(pj, x, y)))


def test_batched_grad_equals_per_client_grads():
    p = params_from_jax(mlp_params_np(6), "cpu")
    x, y = _batch(1, lead=(3,))
    pb = {k: v.unsqueeze(0).expand(3, *v.shape) for k, v in p.items()}
    g = tmlp.mlp_grad(pb, (torch.from_numpy(x), torch.from_numpy(y)))
    for n in range(3):
        gn = tmlp.mlp_grad(p, (torch.from_numpy(x[n]), torch.from_numpy(y[n])))
        for k in p:
            torch.testing.assert_close(g[k][n], gn[k], rtol=1e-6, atol=1e-9)


def _jax_cfg(tcfg):
    return jfs.FedScalarConfig(
        local_steps=tcfg.local_steps, local_lr=tcfg.local_lr,
        server_lr=tcfg.server_lr,
        distribution=jfs.Distribution(tcfg.distribution.value),
        num_projections=tcfg.num_projections,
        mode=jproj.ProjectionMode(tcfg.mode.value),
        error_feedback=tcfg.error_feedback)


@pytest.mark.parametrize("method", METHODS)
def test_fedscalar_round_matches_reference(jax_kernels, method):
    n = 6
    tcfg = tsim.protocol_config(tsim.SimulationConfig(method=method))
    jcfg = _jax_cfg(tcfg)
    p = mlp_params_np(7)
    x, y = _batch(2, lead=(n, tcfg.local_steps))
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = params_from_jax(p, "cpu")
    ef_np = None
    if tcfg.error_feedback:
        rng = np.random.RandomState(9)
        ef_np = {k: (1e-3 * rng.randn(n, *v.shape)).astype(np.float32)
                 for k, v in p.items()}
    round_idx = 17

    got, (aux, ef_t) = tfs.fedscalar_round(
        pt, (torch.from_numpy(x), torch.from_numpy(y)), round_idx, tmlp.mlp_grad,
        tcfg, None if ef_np is None else params_from_jax(ef_np, "cpu"))
    want, (jaux, ef_j) = jfs.fedscalar_round(
        pj, (jnp.asarray(x), jnp.asarray(y)), round_idx, jmlp.mlp_grad, jcfg,
        None if ef_np is None else {k: jnp.asarray(v) for k, v in ef_np.items()})
    np.testing.assert_array_equal(aux["seeds"].numpy().astype(np.uint32),
                                  np.asarray(jaux["seeds"]))

    # reference composition on the fused serving path
    local = jfs.make_local_sgd(jmlp.mlp_grad, jcfg.local_lr, jcfg.local_steps)
    deltas = jax.vmap(local, in_axes=(None, 0))(pj, (jnp.asarray(x),
                                                     jnp.asarray(y)))
    l1 = np.asarray(sum(jnp.abs(v).sum(axis=tuple(range(1, v.ndim)))
                        for v in deltas.values()))
    r = aux["r"].numpy()
    assert r.shape == (n, tcfg.num_projections)
    assert (np.abs(r - np.asarray(jaux["r"])).max(axis=1) <= 1e-6 * l1).all()
    fused = jax_kernels.ops.server_update_fused(
        pj, jaux["r"], jaux["seeds"], jcfg.server_lr, jcfg.distribution,
        mode=jcfg.mode, use_pallas=False)
    for k in p:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0,
                                   atol=1e-6, err_msg=f"fori {k}")
        np.testing.assert_allclose(got[k].numpy(), np.asarray(fused[k]), rtol=0,
                                   atol=1e-6, err_msg=f"fused {k}")
        if ef_np is not None:
            np.testing.assert_allclose(ef_t[k].numpy(), np.asarray(ef_j[k]),
                                       rtol=0, atol=1e-6, err_msg=f"ef {k}")


@pytest.mark.parametrize("method", ["fedscalar_rademacher", "fedscalar_block8",
                                    "fedscalar_ef"])
def test_client_stage_matches_reference(method):
    """One client's encode (the one-client form of the cohort encode)."""
    tcfg = tsim.protocol_config(tsim.SimulationConfig(method=method))
    rng = np.random.RandomState(3)
    delta = {k: (1e-2 * rng.randn(*v.shape)).astype(np.float32)
             for k, v in mlp_params_np(1).items()}
    ef = ({k: (1e-3 * rng.randn(*v.shape)).astype(np.float32)
           for k, v in delta.items()} if tcfg.error_feedback else None)
    seed = 0xDEADBEEF
    r, ef_t = tfs.client_stage(params_from_jax(delta, "cpu"), seed, tcfg,
                               None if ef is None else params_from_jax(ef, "cpu"))
    jr, ef_j = jfs.client_stage({k: jnp.asarray(v) for k, v in delta.items()},
                                jnp.uint32(seed), _jax_cfg(tcfg),
                                None if ef is None else
                                {k: jnp.asarray(v) for k, v in ef.items()})
    x = delta if ef is None else {k: delta[k] + ef[k] for k in delta}
    l1 = sum(np.abs(v).sum() for v in x.values())
    if tcfg.error_feedback:
        l1 /= sum(v.size for v in x.values())
    assert r.shape == (tcfg.num_projections,)
    assert np.abs(r.numpy() - np.asarray(jr)).max() <= 1e-6 * l1
    if ef is None:
        assert ef_t is None
    else:
        for k in ef:
            np.testing.assert_allclose(ef_t[k].numpy(), np.asarray(ef_j[k]),
                                       rtol=0, atol=1e-6, err_msg=k)


def test_run_simulation_history_matches_reference_keys():
    x, y = load_digits(400)
    xtr, ytr, xte, yte = train_test_split_arrays(x, y)
    clients = make_client_datasets(xtr, ytr, 4)
    cfg = tsim.SimulationConfig(rounds=4, num_clients=4, batch_size=8,
                                capture_uploads=True)
    h = tsim.run_simulation(cfg, tmlp.init_mlp(device="cpu"), clients, xte, yte,
                            device="cpu")
    jx, jy = j_load_digits(400)
    jxtr, jytr, jxte, jyte = j_split(jx, jy)
    jcfg = jsim.SimulationConfig(rounds=2, num_clients=4, batch_size=8,
                                 capture_uploads=True)
    jh = jsim.run_simulation(jcfg, jmlp.init_mlp(), j_make_clients(jxtr, jytr, 4),
                             jxte, jyte)
    assert set(h) == set(jh)
    assert h["loss"].shape == (4,) and np.isfinite(h["loss"]).all()
    assert h["r_history"].shape == (4, 4, 1)
    # the cost model is numpy on both sides: identical figures
    np.testing.assert_array_equal(h["cum_bits"][:2], jh["cum_bits"])
    np.testing.assert_array_equal(h["cum_wall_s"][:2], jh["cum_wall_s"])
    np.testing.assert_array_equal(h["cum_energy_j"][:2], jh["cum_energy_j"])
    assert h["bits_per_client_per_round"] == jh["bits_per_client_per_round"]


@pytest.mark.parametrize("method", ["fedscalar_rademacher", "fedscalar_block8"])
def test_run_simulation_loss_falls_on_cpu(method):
    x, y = load_digits()
    xtr, ytr, xte, yte = train_test_split_arrays(x, y)
    clients = make_client_datasets(xtr, ytr, 20)
    h = tsim.run_simulation(tsim.SimulationConfig(method=method, rounds=12),
                            tmlp.init_mlp(device="cpu"), clients, xte, yte,
                            device="cpu")
    assert np.isfinite(h["loss"]).all()
    assert h["loss"][-1] < h["loss"][0]


def test_baselines_wait_for_their_slice():
    """The baselines slice has landed: fedavg/qsgd map to their configs."""
    from repro_torch.core import fedavg as tfa
    from repro_torch.core import qsgd as tq

    assert tsim.protocol_config(tsim.SimulationConfig(method="fedavg")) == \
        tfa.FedAvgConfig()
    assert tsim.protocol_config(tsim.SimulationConfig(method="qsgd")) == \
        tq.QSGDConfig()
    with pytest.raises(ValueError, match="capture_uploads"):
        tsim.run_simulation(tsim.SimulationConfig(method="qsgd", rounds=1,
                                                  capture_uploads=True),
                            tmlp.init_mlp(device="cpu"), [], None, None,
                            device="cpu")


def test_cost_model_copy_matches_reference():
    ch = ChannelConfig(access="tdma", num_clients=7)
    from repro.fed.costmodel import ChannelConfig as JChannel

    a = CostModel(ch, 63680, rng_seed=5)
    b = JCostModel(JChannel(access="tdma", num_clients=7), 63680, rng_seed=5)
    for bits in (64, 288, 63680):
        assert a.round_cost(bits) == b.round_cost(bits)
    cfg = dataclasses.replace(tfs.FedScalarConfig(), num_projections=8,
                              scalar_bits=16)
    assert tfs.upload_bits_per_client(None, cfg) == jfs.upload_bits_per_client(
        None, jfs.FedScalarConfig(num_projections=8, scalar_bits=16))


def test_entry_points_need_a_card_unless_told_cpu():
    """No silent CPU fallback: without a card the default device raises."""
    if torch.cuda.is_available():
        assert tmlp.init_mlp()["w0"].is_cuda
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmlp.init_mlp()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(mlp_params_np(0))
    x, y = load_digits(200)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsim.run_simulation(tsim.SimulationConfig(rounds=1, num_clients=2),
                            tmlp.init_mlp(device="cpu"),
                            make_client_datasets(x, y, 2), x, y)
