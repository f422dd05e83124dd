"""The client-parallel train step on a mesh
(``launch/train.py::make_train_step_client_parallel(..., mesh=)``) on the
CPU, on meshes of repeated CPU entries: the clients on the mesh's data
rows, each replica resident over its row's entries (the reference's
``tp`` layout, ``sharding/resident.py::place_rows``), x the ``zero3``
``ResidentTree`` of the mesh train step.

Against the one-device client-parallel step (reduced configs at half
width, d_model 128, d_ff 256, one CPU thread; the per-row replicas run
the one-device step's vmap over gathered copies of the same weights):

* (1, M): each δ bitwise the one-device step's;
* (2, 2): each row's δ bitwise the one-device step run on that row's
  clients alone (their rows of the batch);
* each r within ``tree_encode_tolerance`` (over the row's shards) of the
  float64 encode of its δ;
* given the one-device step's r, the new parameters bitwise its.

Against the reference (reduced SmolLM-360M, float32, N = 4, S = 2, on
(2, 2)): the round within ``tests/test_torch_client_parallel.py::_check``'s
float32 limits of the reference's jitted ``make_train_step_client_parallel``
(loss 1e-5, each r 1e-5·(1 + |r|), every new param within the mean |Δr|
plus 1e-6).  ``param_spec_tp`` is checked against the mesh.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.launch.train as j_train  # noqa: E402
from repro.configs import registry as j_registry  # noqa: E402
from repro.models.api import Arch as JArch  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.projection import ProjectionMode  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.seeded_projection import (  # noqa: E402
    project_tree_plain,
    tree_encode_tolerance,
)
from repro_torch.kernels.tree import tree_plan  # noqa: E402
from repro_torch.launch.mesh import make_fed_mesh  # noqa: E402
from repro_torch.launch.train import FLRunConfig, make_train_step_client_parallel  # noqa: E402
from repro_torch.models.api import Arch  # noqa: E402
from repro_torch.sharding import fed_rules  # noqa: E402
from repro_torch.sharding.resident import ResidentTree, shard_resident  # noqa: E402
from repro_torch.sharding.rules import param_specs  # noqa: E402

NARROW = dict(d_model=128, d_ff=256)
N, S, LR, SEQ = 4, 2, 0.05, 8


def _mesh(shape):
    return make_fed_mesh(shape, device="cpu", devices=["cpu"] * (shape[0] * shape[1]))


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread: small tensors, and one sum order for the bitwise checks."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(name, dtype):
    cfg = dataclasses.replace(get_config(name).reduced(**NARROW), dtype=dtype)
    arch = Arch(cfg)
    params = arch.init(seed=2, device="cpu")
    rng = np.random.RandomState(4)
    toks = rng.randint(0, cfg.vocab_size, (N * S, SEQ + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}
    n = {"vision": cfg.num_frontend_tokens, "audio": cfg.encoder_seq}.get(cfg.frontend)
    if n:
        e = (rng.randn(N * S, n, cfg.d_model) * 0.02).astype(np.float32)
        batch["embeds"] = torch.from_numpy(e).to(cfg.torch_dtype)
    return arch, params, batch


def _one_device(monkeypatch, arch, params, batch, n):
    """The one-device client-parallel round of ``n`` clients → (new params,
    metrics, each client's δ leaves)."""
    deltas = []
    encode = ops.project_tree_kernel

    def spy(d, seeds, *a):
        deltas.extend([x[c].clone() for x in tree_leaves(d)] for c in range(n))
        return encode(d, seeds, *a)

    monkeypatch.setattr(ops, "project_tree_kernel", spy)
    fl = FLRunConfig(num_virtual_clients=n, local_steps=S, local_lr=LR)
    new, m = make_train_step_client_parallel(arch, fl)(params, batch, 3)
    monkeypatch.undo()
    return new, m, deltas


@pytest.mark.parametrize("name,dtype,shape", [
    ("smollm-360m", "float32", (1, 3)), ("smollm-360m", "bfloat16", (1, 3)),
    ("smollm-360m", "float32", (2, 2)), ("whisper-tiny", "float32", (1, 2)),
    ("qwen3-moe-30b-a3b", "float32", (2, 2))],
    ids=["smollm-f32-1x3", "smollm-bf16-1x3", "smollm-f32-2x2", "whisper-1x2",
         "qwen3-moe-2x2"])
def test_deltas_encodes_and_close(name, dtype, shape, monkeypatch):
    arch, params, batch = _setup(name, dtype)
    u_new, u_m, u_deltas = _one_device(monkeypatch, arch, params, batch, N)
    d = shape[0]
    per = N // d
    rows = u_deltas if d == 1 else []   # each row's clients alone, on their rows
    for r in range(d if d > 1 else 0):
        sl = slice(r * per * S, (r + 1) * per * S)
        rows += _one_device(monkeypatch, arch, params,
                            {k: v[sl] for k, v in batch.items()}, per)[2]

    got = []
    sharded = fed_rules.sharded_project_tree

    def spy(mesh, delta, seed, *a):
        r = sharded(mesh, delta, seed, *a)
        got.append((mesh, delta, seed, r))
        return u_m["r"][len(got) - 1]          # the close takes the one-device r

    monkeypatch.setattr(fed_rules, "sharded_project_tree", spy)
    mesh = _mesh(shape)
    x = shard_resident(params, mesh)
    fl = FLRunConfig(num_virtual_clients=N, local_steps=S, local_lr=LR)
    new, m = make_train_step_client_parallel(arch, fl, mesh=mesh)(x, batch, 3)
    monkeypatch.undo()

    assert isinstance(new, ResidentTree) and new.mesh is mesh and len(got) == N
    assert torch.equal(m["seeds"], u_m["seeds"])
    if d == 1:
        assert torch.equal(m["loss"], u_m["loss"])
    shapes = [tuple(w.shape) for w in tree_leaves(params)]
    plan = tree_plan("encode", shapes, [w.dtype for w in tree_leaves(params)], 1,
                     ProjectionMode.FULL, "cpu")
    for c, (row_mesh, delta, seed, r) in enumerate(got):
        assert row_mesh.shape == (1, shape[1]) and row_mesh == mesh.row_mesh(c // per)
        leaves = tree_leaves(delta.unshard("cpu"))
        for a, b in zip(leaves, rows[c]):
            assert a.dtype == b.dtype and torch.equal(a, b)
        exact = project_tree_plain([w[None] for w in leaves], seed.reshape(1), plan,
                                   dtype=torch.float64)
        tol = tree_encode_tolerance([s[None] for s in delta.flat_shards()], "rademacher")
        assert abs(float(r[0]) - float(exact[0, 0])) <= float(tol[0, 0])
    for a, b in zip(tree_leaves(new.unshard("cpu")), tree_leaves(u_new)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(tree_leaves(x.unshard("cpu")), tree_leaves(params)):
        assert torch.equal(a, b)                 # x left as it was


def test_mesh_client_parallel_matches_reference(monkeypatch):
    jc = dataclasses.replace(j_registry.get_config("smollm-360m").reduced(),
                             dtype="float32")
    jp = jax.jit(JArch(jc).init)(jax.random.PRNGKey(0))
    toks = np.random.RandomState(0).randint(0, jc.vocab_size, (N * S, SEQ + 1))
    jb = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
          "labels": jnp.asarray(toks[:, 1:], jnp.int32)}
    seen = {}
    aggregate = j_train.server_aggregate

    def spy(p, rs, seeds, pcfg):
        jax.debug.callback(lambda r: seen.__setitem__("rs", np.asarray(r)), rs)
        return aggregate(p, rs, seeds, pcfg)

    monkeypatch.setattr(j_train, "server_aggregate", spy)
    j_fl = j_train.FLRunConfig(num_virtual_clients=N, local_steps=S, local_lr=LR)
    j_new, j_m = jax.jit(j_train.make_train_step_client_parallel(JArch(jc), j_fl, jp))(
        jp, jb, jnp.int32(3))
    jax.effects_barrier()
    monkeypatch.undo()

    arch = Arch(dataclasses.replace(get_config("smollm-360m").reduced(), dtype="float32"))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    mesh = _mesh((2, 2))
    fl = FLRunConfig(num_virtual_clients=N, local_steps=S, local_lr=LR)
    spec = param_specs(params, mesh, layout="tp")
    new, m = make_train_step_client_parallel(arch, fl, spec, mesh=mesh)(
        shard_resident(params, mesh), {"tokens": torch.from_numpy(toks[:, :-1]),
                                       "labels": torch.from_numpy(toks[:, 1:])}, 3)
    assert abs(float(m["loss"]) - float(j_m["loss"])) <= 1e-5
    want_r = seen["rs"].reshape(N, 1)
    r = m["r"].numpy()
    assert (np.abs(r - want_r) <= 1e-5 * (1 + np.abs(want_r))).all()
    assert m["uploaded_scalars"] == int(j_m["uploaded_scalars"])
    dr = float(np.abs(r - want_r).sum()) / N
    for a, b in zip(tree_leaves(new.unshard("cpu")), jax.tree_util.tree_leaves(j_new)):
        assert float(np.abs(a.numpy() - np.asarray(b, np.float32)).max()) <= dr + 1e-6


def test_param_spec_tp_is_checked():
    arch, params, batch = _setup("smollm-360m", "float32")
    mesh = _mesh((2, 2))
    fl = FLRunConfig(num_virtual_clients=N, local_steps=S, local_lr=LR)
    tp = param_specs(params, mesh, layout="tp")
    assert make_train_step_client_parallel(arch, fl, tp, mesh=mesh)
    with pytest.raises(ValueError, match="tp layout"):     # zero3 names data
        make_train_step_client_parallel(arch, fl, param_specs(params, mesh), mesh=mesh)
    with pytest.raises(ValueError, match="tp layout"):     # an axis off the mesh
        make_train_step_client_parallel(arch, fl, [("expert",)], mesh=mesh)
    step = make_train_step_client_parallel(arch, fl, tp[:-1] if isinstance(tp, list)
                                           else {k: v for k, v in list(tp.items())[1:]},
                                           mesh=mesh)
    with pytest.raises(ValueError, match="specs for"):     # not one a leaf
        step(shard_resident(params, mesh), batch, 0)
    with pytest.raises(ValueError, match="data rows"):     # N not a multiple of D
        make_train_step_client_parallel(arch, dataclasses.replace(fl, num_virtual_clients=3),
                                        mesh=mesh)(shard_resident(params, mesh), batch, 0)
    with pytest.raises(TypeError, match="ResidentTree"):
        make_train_step_client_parallel(arch, fl, mesh=mesh)(params, batch, 0)
