"""The mesh train step (``launch/train.py::make_train_step(..., mesh=)``)
on the CPU: parameters resident in shards (``sharding/resident.py``) on
meshes of repeated CPU entries, against the reference's single-device
round and the port's unsharded round.

Tolerances, with their reasons:

* Against the reference's e2e inputs (``tests/test_sharding_e2e.py``:
  reduced SmolLM-360M, float32, N = 2, S = 2, lr 0.05, 8 × 32 tokens) on
  a (2, 4) mesh: ``tests/test_torch_train.py::
  test_train_step_matches_reference``'s float32 limits against the
  reference's ``make_train_step`` (loss 1e-5, each r 1e-5·(1 + |r|), the
  new params Σₙ|Δrₙ|/N + 1e-6), and the same limits against the port's
  unsharded step: two data groups sum the loss and the gradient in another
  order, the shards the encode.  Both are far inside the reference's own
  e2e limits (params 2e-2, loss 1e-3).
* One data group ((1, M) meshes): the loss and every client's δ bitwise
  the unsharded step's (every test here runs on one CPU thread, and the
  embedding backward's sum order follows the thread count); each r within ``tree_encode_tolerance`` of
  the float64 encode of that δ (the shards' partial sums run in another
  order); given the unsharded step's r, the new params bitwise.
* The families: Falcon-Mamba, Jamba, PaliGemma and Whisper on (2, 2)
  within the float32 limits above of the port's unsharded step, and
  Qwen3-MoE on (1, 2) with its loss bitwise.  Qwen3-MoE on (2, 2), at a
  capacity factor that drops tokens, within the same limits of the
  reference's single-device ``make_train_step`` and of the port's
  unsharded step (the MoE layers dispatch each data group as the whole
  batch: ``moe.BatchDispatch``, bitwise the whole batch's call).
* Every config but the reference e2e test's is ``reduced()`` at half its
  width (d_model 128, d_ff 256): a round's time on the CPU goes mostly
  to drawing v, in proportion to d.
* Placement: ``shard_resident`` → ``unshard``, every ``gather``,
  ``Arch.init(mesh=)`` and a checkpoint restored onto another mesh, all
  bitwise.
* ``dp_axes=("data", "model")`` (the reference's ``dp256`` variant) on
  (1, 4) and (2, 2): each step's batch split over every mesh entry, the
  round within the float32 limits above of the unsharded round.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.launch.train as j_train  # noqa: E402
from repro.configs import registry as j_registry  # noqa: E402
from repro.configs.registry import get_arch as j_get_arch  # noqa: E402
from repro.models.api import Arch as JArch  # noqa: E402
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.projection import ProjectionMode  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.seeded_projection import (  # noqa: E402
    project_tree_plain,
    tree_encode_tolerance,
)
from repro_torch.kernels.tree import tree_plan  # noqa: E402
from repro_torch.launch.mesh import make_fed_mesh  # noqa: E402
from repro_torch.launch.train import FLRunConfig, make_train_step  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.api import Arch  # noqa: E402
from repro_torch.models.moe import BatchDispatch, init_moe, moe_ffn  # noqa: E402
from repro_torch.sharding import fed_rules  # noqa: E402
from repro_torch.sharding.resident import ResidentTree, shard_resident  # noqa: E402


def _mesh(shape):
    n = shape[0] * shape[1]
    return make_fed_mesh(shape, device="cpu", devices=["cpu"] * n)


NARROW = dict(d_model=128, d_ff=256)


def _cfg(name, dtype="float32", registry=None, **over):
    """``reduced()`` at :data:`NARROW` width (the port's config, or with
    ``registry`` the reference's)."""
    reg = get_config if registry is None else registry.get_config
    return dataclasses.replace(reg(name).reduced(**NARROW), dtype=dtype, **over)


def _batch(cfg, gb, seq, seed):
    """Tokens and labels (and a frontend's seeded embeddings) from numpy."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (gb, seq + 1))
    b = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}
    n = {"vision": cfg.num_frontend_tokens, "audio": cfg.encoder_seq}.get(cfg.frontend)
    if n:
        e = (rng.randn(gb, n, cfg.d_model) * 0.02).astype(np.float32)
        b["embeds"] = torch.from_numpy(e).to(cfg.torch_dtype)
    return b


def _close_enough(got, want, got_m, want_m, loss_tol=1e-5):
    """test_train_step_matches_reference's float32 limits: loss, r, and the
    new params within Σₙ|Δrₙ|/N + 1e-6."""
    assert abs(float(got_m["loss"]) - float(want_m["loss"])) <= loss_tol
    rg, rw = got_m["r"].numpy(), want_m["r"].numpy()
    assert rg.shape == rw.shape and (np.abs(rg - rw) <= 1e-5 * (1 + np.abs(rw))).all()
    assert torch.equal(got_m["seeds"], want_m["seeds"])
    assert got_m["uploaded_scalars"] == want_m["uploaded_scalars"]
    dr = float(np.abs(rg - rw).sum()) / rg.shape[0]
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert float((a.double() - b.double()).abs().max()) <= dr + 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread: the tensors here are small, and several threads per
    worker of a parallel run only contend; with one, the embedding
    backward also sums in one order, which the bitwise checks need."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# (a) the reference's e2e round
# ---------------------------------------------------------------------------

def _reference_round(monkeypatch, jarch, jp, batch, fl, round_idx):
    """The reference's jitted single-device ``make_train_step`` on the numpy
    ``batch`` → (new params as a torch tree, metrics with its rs captured
    at the close)."""
    seen = {}
    aggregate = j_train.server_aggregate

    def spy(p, rs, seeds, pcfg):
        jax.debug.callback(lambda r: seen.update(rs=np.asarray(r)), rs)
        return aggregate(p, rs, seeds, pcfg)

    monkeypatch.setattr(j_train, "server_aggregate", spy)
    j_new, j_m = jax.jit(j_train.make_train_step(jarch, j_train.FLRunConfig(**fl)))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.int32(round_idx))
    monkeypatch.undo()
    n = fl["num_virtual_clients"]
    return (params_from_jax(jax.tree_util.tree_map(np.asarray, j_new), device="cpu"),
            {"loss": j_m["loss"], "r": torch.from_numpy(seen["rs"].reshape(n, 1).copy()),
             "uploaded_scalars": int(j_m["uploaded_scalars"])})


def test_mesh_round_matches_reference_e2e(monkeypatch):
    jarch = j_get_arch("smollm-360m", reduced=True)
    jp = jarch.init(jax.random.PRNGKey(0))
    fl = dict(num_virtual_clients=2, local_steps=2, local_lr=0.05)
    tokens = np.random.RandomState(0).randint(0, 64, size=(8, 32)).astype(np.int32)
    j_new, want_m = _reference_round(monkeypatch, jarch, jp,
                                     {"tokens": tokens, "labels": tokens}, fl, 0)

    arch = Arch(dataclasses.replace(get_config("smollm-360m").reduced(), dtype="float32"))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    tt = torch.from_numpy(tokens)
    batch = {"tokens": tt, "labels": tt}
    mesh = _mesh((2, 4))
    rp = shard_resident(params, mesh)
    new, m = make_train_step(arch, FLRunConfig(**fl), mesh=mesh)(rp, batch, 0)
    assert isinstance(new, ResidentTree) and new.mesh is mesh
    got = new.unshard("cpu")
    want_m["seeds"] = m["seeds"]
    _close_enough(got, j_new, m, want_m)
    # the port's unsharded round, and x left as it was
    u_new, u_m = make_train_step(arch, FLRunConfig(**fl))(params, batch, 0)
    _close_enough(got, u_new, m, u_m)
    for a, b in zip(tree_leaves(rp.unshard("cpu")), tree_leaves(params)):
        assert torch.equal(a, b)
    with pytest.raises(TypeError, match="ResidentTree"):     # not placed on it
        make_train_step(arch, FLRunConfig(**fl), mesh=mesh)(params, batch, 0)


# ---------------------------------------------------------------------------
# (b) one data group: bitwise the unsharded round
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 4), (1, 3)], ids=["1x4", "1x3"])
def test_one_data_group_is_bitwise(shape, dtype, monkeypatch):
    cfg = _cfg("smollm-360m", dtype)
    arch = Arch(cfg)
    params = arch.init(seed=2, device="cpu")
    batch = _batch(cfg, 8, 12, 3)
    fl = FLRunConfig(num_virtual_clients=2, local_steps=2, local_lr=0.05)
    mesh = _mesh(shape)
    if shape == (1, 3):          # some leaves leave padding in the last shard
        assert any((ls.layout.rows if ls.axis == 0 else ls.layout.cols) % 3
                   for ls in fed_rules.plan_tree(params, 3).leaves)

    u_deltas, u_rs = [], []
    project = ops.project_tree_kernel

    def spy_u(delta, seeds, *a):
        u_deltas.append(tree_map(lambda d: d[0].clone(), delta))
        r = project(delta, seeds, *a)
        u_rs.append(r[0])
        return r

    monkeypatch.setattr(ops, "project_tree_kernel", spy_u)
    u_new, u_m = make_train_step(arch, fl)(params, batch, 5)
    monkeypatch.undo()

    m_deltas, m_rs = [], []
    sharded = fed_rules.sharded_project_tree

    def spy_m(mesh_, delta, seed, *a):
        m_deltas.append(delta)
        m_rs.append(sharded(mesh_, delta, seed, *a))
        return u_rs[len(m_rs) - 1]          # the close takes the unsharded r

    monkeypatch.setattr(fed_rules, "sharded_project_tree", spy_m)
    new, m = make_train_step(arch, fl, mesh=mesh)(shard_resident(params, mesh), batch, 5)

    assert torch.equal(m["loss"], u_m["loss"])
    seeds = u_m["seeds"]
    shapes = [tuple(w.shape) for w in tree_leaves(params)]
    plan = tree_plan("encode", shapes, [w.dtype for w in tree_leaves(params)], 1,
                     ProjectionMode.FULL, "cpu")
    for i, (ud, md, r) in enumerate(zip(u_deltas, m_deltas, m_rs)):
        for a, b in zip(tree_leaves(ud), tree_leaves(md.unshard("cpu"))):
            assert a.dtype == b.dtype and torch.equal(a, b)
        exact = project_tree_plain([w[None] for w in tree_leaves(ud)], seeds[i:i + 1],
                                   plan, dtype=torch.float64)
        tol = tree_encode_tolerance([x[None] for x in md.flat_shards()], "rademacher")
        assert abs(float(r[0]) - float(exact[0, 0])) <= float(tol[0, 0])
    for a, b in zip(tree_leaves(new.unshard("cpu")), tree_leaves(u_new)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for sh, ls in zip(new.shards, new.plan.leaves):   # the padding stays zero
        extent = ls.layout.rows if ls.axis == 0 else ls.layout.cols
        x = sh[-1][extent - (len(sh) - 1) * ls.per_shard:] if ls.axis == 0 \
            else sh[-1][:, extent - (len(sh) - 1) * ls.per_shard:]
        assert not bool(x.any())


# ---------------------------------------------------------------------------
# (c) the families
# ---------------------------------------------------------------------------

FAMILIES = [("falcon-mamba-7b", (2, 2), 1e-5), ("paligemma-3b", (2, 2), 1e-5),
            ("whisper-tiny", (2, 2), 1e-5), ("jamba-v0.1-52b", (2, 2), 1e-5),
            ("qwen3-moe-30b-a3b", (1, 2), 0.0)]


@pytest.mark.parametrize("name,shape,loss_tol", FAMILIES,
                         ids=[f"{f[0]}-{f[1][0]}x{f[1][1]}" for f in FAMILIES])
def test_family_round_on_a_mesh(name, shape, loss_tol):
    cfg = _cfg(name)
    arch = Arch(cfg)
    params = arch.init(seed=4, device="cpu")
    batch = _batch(cfg, 4, 8, 6)
    fl = FLRunConfig(num_virtual_clients=1, local_steps=1, local_lr=0.05)
    want, want_m = make_train_step(arch, fl)(params, batch, 1)
    mesh = _mesh(shape)
    new, m = make_train_step(arch, fl, mesh=mesh)(shard_resident(params, mesh), batch, 1)
    _close_enough(new.unshard("cpu"), want, m, want_m, loss_tol)
    if loss_tol == 0.0:
        assert torch.equal(m["loss"], want_m["loss"])


def test_moe_mesh_round_matches_reference(monkeypatch):
    """Qwen3-MoE on (2, 2), N = 1, S = 1, at a capacity factor that drops
    pairs (the whole batch's capacity runs out inside the second data
    group): the two groups dispatch as the whole per-step batch, which the
    reference's jitted single-device step sees."""
    over = dict(capacity_factor=0.75)
    jc = _cfg("qwen3-moe-30b-a3b", registry=j_registry, **over)
    jp = JArch(jc).init(jax.random.PRNGKey(0))
    fl = dict(num_virtual_clients=1, local_steps=1, local_lr=0.05)
    toks = np.random.RandomState(6).randint(0, jc.vocab_size, (4, 9)).astype(np.int32)
    nb = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    j_new, want_m = _reference_round(monkeypatch, JArch(jc), jp, nb, fl, 1)

    arch = Arch(_cfg("qwen3-moe-30b-a3b", **over))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    dropped = []
    moe = lm.moe_ffn

    def spy(*a, **kw):
        y, aux = moe(*a, **kw)
        dropped.append(float(aux["moe_dropped_frac"]))
        return y, aux

    monkeypatch.setattr(lm, "moe_ffn", spy)
    mesh = _mesh((2, 2))
    new, m = make_train_step(arch, FLRunConfig(**fl), mesh=mesh)(
        shard_resident(params, mesh), batch, 1)
    monkeypatch.undo()
    assert max(dropped) > 0
    got = new.unshard("cpu")
    want_m["seeds"] = m["seeds"]
    _close_enough(got, j_new, m, want_m)
    u_new, u_m = make_train_step(arch, FLRunConfig(**fl))(params, batch, 1)
    _close_enough(got, u_new, m, u_m)


@pytest.mark.parametrize("k", [1, 2])
def test_moe_groups_dispatch_as_the_whole_batch(k):
    """Two groups run in order through ``BatchDispatch`` keep and drop the
    whole batch's pairs (a capacity factor that drops), bitwise."""
    cfg = dataclasses.replace(_cfg("qwen3-moe-30b-a3b"), experts_per_token=k,
                              capacity_factor=0.5)
    p = init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.randn((4, 6, cfg.d_model), generator=torch.Generator().manual_seed(1))
    want, aux = moe_ffn(p, x, cfg)
    assert float(aux["moe_dropped_frac"]) > 0
    batch = BatchDispatch(2)
    got = [moe_ffn(p, x[2 * g:2 * g + 2], cfg, dispatch=(batch, g, "l"))
           for g in range(2)]
    assert torch.equal(torch.cat([y for y, _ in got]), want)
    dropped = sum(float(a["moe_dropped_frac"]) for _, a in got) / 2
    assert abs(dropped - float(aux["moe_dropped_frac"])) < 1e-6
    with pytest.raises(RuntimeError, match="ahead"):      # out of order
        moe_ffn(p, x[2:], cfg, dispatch=(BatchDispatch(2), 1, "l"))


# ---------------------------------------------------------------------------
# (d) placement and gathers; (e) checkpoints across meshes; (f) no card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 4), (1, 3)], ids=["2x4", "1x3"])
def test_resident_round_trip_and_gathers(shape):
    cfg = _cfg("jamba-v0.1-52b")          # stacked 1-D, 2-D and 3-D leaves
    params = Arch(cfg).init(seed=7, device="cpu")
    mesh = _mesh(shape)
    rt = shard_resident(params, mesh)
    leaves = tree_leaves(params)
    for a, b in zip(tree_leaves(rt.unshard("cpu")), leaves):
        assert a.dtype == b.dtype and torch.equal(a, b)
    per_shard = rt.plan.per_shard_elements()
    assert rt.resident_bytes() == [per_shard * 4] * mesh.size      # float32 tree
    stacked = rt.stacked_leaves(Arch(cfg).stacked_keys)
    for j, w in enumerate(leaves):
        assert torch.equal(rt.gather(j, "cpu"), w)
        if stacked[j]:
            for i in range(w.shape[0]):
                assert torch.equal(rt.gather(j, "cpu", i), w[i])
    # the pieces never reach into the padding
    for j, w in enumerate(leaves):
        assert sum(p.numel() for p in rt.pieces(j)) == w.numel()


@pytest.mark.parametrize("name", ["smollm-360m", "jamba-v0.1-52b", "whisper-tiny"])
def test_arch_init_on_a_mesh_is_bitwise(name):
    arch = Arch(_cfg(name, "bfloat16"))
    mesh = _mesh((2, 2))
    got = arch.init(seed=9, device="cpu", mesh=mesh)
    want = arch.init(seed=9, device="cpu")
    assert isinstance(got, ResidentTree)
    for a, b in zip(tree_leaves(got.unshard("cpu")), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_restores_onto_another_mesh(dtype, tmp_path):
    arch = Arch(_cfg("smollm-360m", dtype))
    params = arch.init(seed=11, device="cpu")
    rt = shard_resident(params, _mesh((2, 4)))
    save_checkpoint(str(tmp_path), rt, step=3, metadata={"a": 1})
    other = _mesh((4, 2))
    got, step, meta = restore_checkpoint(str(tmp_path), rt, mesh=other)
    assert isinstance(got, ResidentTree) and got.mesh is other
    assert (step, meta) == (3, {"a": 1})
    flat, _, _ = restore_checkpoint(str(tmp_path), params, device="cpu")
    for a, b, c in zip(tree_leaves(got.unshard("cpu")), tree_leaves(flat),
                       tree_leaves(params)):
        assert a.dtype == c.dtype and torch.equal(a, c) and torch.equal(b, c)
    assert torch.equal(torch.cat([x.flatten() for x in got.flat_shards()]).float(),
                       torch.cat([x.flatten() for x in shard_resident(
                           params, other).flat_shards()]).float())


def test_a_mesh_naming_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_fed_mesh((1, 4), devices=["cuda"] * 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_fed_mesh((2, 2), device="cuda")


# ---------------------------------------------------------------------------
# (g) dp_axes with "model": the batch over every entry (the dp256 variant)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
def test_dp256_splits_the_batch_over_every_entry(shape, monkeypatch):
    """Each local step's batch over the mesh's D·M entries, a row of it each
    (``FedMesh.entry_groups``): the round within the float32 limits above
    of the unsharded round."""
    arch = Arch(_cfg("smollm-360m"))
    params = arch.init(seed=2, device="cpu")
    batch = _batch(arch.cfg, 8, 12, 3)
    fl = FLRunConfig(num_virtual_clients=2, local_steps=1, local_lr=0.05)
    want, want_m = make_train_step(arch, fl)(params, batch, 5)
    mesh = _mesh(shape)
    rows = []
    loss = arch.loss
    monkeypatch.setattr(arch, "loss", lambda p, b, **kw: rows.append(
        b["tokens"].shape[0]) or loss(p, b, **kw))
    new, m = make_train_step(arch, fl, mesh=mesh, dp_axes=("data", "model"))(
        shard_resident(params, mesh), batch, 5)
    assert rows == [1] * 8               # 4 entries × 2 clients × 1 step
    assert len(mesh.entry_groups()) == 4
    _close_enough(new.unshard("cpu"), want, m, want_m)
    with pytest.raises(ValueError, match="dp_axes"):
        make_train_step(arch, fl, mesh=mesh, dp_axes=("model",))
