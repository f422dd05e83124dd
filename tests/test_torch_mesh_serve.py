"""Serving from parameters resident on a mesh (``models/api.py``: ``Arch.prefill``
and ``Arch.decode`` on a ``ResidentTree`` or on ``sharding/resident.py::
place_rows``' ``RowTrees``) on the CPU, on meshes of repeated CPU entries,
against the port's unsharded serve and the reference's serve steps.

The two layouts are the reference's serve layouts: ``zero3`` (one
resident tree over the whole mesh) and ``tp`` (one resident tree a data
row, over the row's entries).  A prefill and four greedy decode steps,
over the six families (reduced, at
half width: d_model 128, d_ff 256, float32, one CPU thread):

* (1, M) meshes, both layouts: the logits, every cache tensor and the
  greedy tokens bitwise the unsharded serve (one data group computes
  what the unsharded serve computes, from gathered copies of the same
  weights);
* (2, 2), both layouts: each data group's logits and caches bitwise the
  unsharded serve of that group's own rows (reduced Jamba, whose MoE
  layers drop pairs, at a capacity that drops none: a group dispatches
  as the whole batch, its own rows' serve as two rows); the whole batch within
  1e-5·(1 + |logit|) of the unsharded serve of the whole batch, with
  equal tokens (two groups of two rows run other matrix shapes than one
  of four);
* reduced Qwen3-MoE with two experts a token at a capacity factor that
  drops pairs, on (2, 2): the prefill within the same limit of the
  unsharded whole-batch prefill, and each MoE layer's dropped pairs equal
  (each group dispatches as the whole batch, ``moe.BatchDispatch``);
* against the reference: reduced SmolLM-360M in float32 on a (1, 2) mesh
  against the reference's ``make_prefill_step`` and ``make_decode_step``,
  within ``tests/test_torch_lm.py``'s float32 serve limits (logits and
  caches atol 5e-5 + rtol 1e-5).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as j_registry  # noqa: E402
from repro.launch.serve import make_decode_step as j_make_decode  # noqa: E402
from repro.launch.serve import make_prefill_step as j_make_prefill  # noqa: E402
from repro.models.api import Arch as JArch  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.launch.mesh import make_fed_mesh  # noqa: E402
from repro_torch.launch.serve import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.api import Arch, MeshCaches  # noqa: E402
from repro_torch.sharding.resident import (  # noqa: E402
    ResidentTree,
    RowTrees,
    place_rows,
    shard_resident,
)

FAMILIES = ["smollm-360m", "qwen3-moe-30b-a3b", "falcon-mamba-7b", "jamba-v0.1-52b",
            "paligemma-3b", "whisper-tiny"]
LAYOUTS = {"zero3": shard_resident, "tp": place_rows}
NARROW = dict(d_model=128, d_ff=256)
B, PROMPT, STEPS, CAPACITY = 4, 10, 4, 16
WHOLE_RTOL = 1e-5
NO_DROP = {"jamba-v0.1-52b": dict(capacity_factor=2.0)}


def _mesh(shape):
    return make_fed_mesh(shape, device="cpu", devices=["cpu"] * (shape[0] * shape[1]))


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread: small tensors, and one sum order for the bitwise checks."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _setup(name, **over):
    cfg = dataclasses.replace(get_config(name).reduced(**NARROW), dtype="float32", **over)
    arch = Arch(cfg)
    params = arch.init(seed=3, device="cpu")
    rng = np.random.RandomState(5)
    batch = {"tokens": torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, PROMPT)))}
    n = {"vision": cfg.num_frontend_tokens, "audio": cfg.encoder_seq}.get(cfg.frontend)
    if n:
        batch["embeds"] = torch.from_numpy(
            (rng.randn(B, n, cfg.d_model) * 0.02).astype(np.float32))
    start = PROMPT + (n if cfg.frontend == "vision" else 0)
    return arch, params, batch, start


def _serve(arch, params, batch, start):
    """A prefill and STEPS greedy decode steps, each next token the argmax
    of the last logits (``launch/serve.py``'s steps, which
    :func:`test_mesh_serve_matches_reference` drives) → (each step's
    logits, the tokens, the caches)."""
    with torch.no_grad():
        logits, caches = arch.prefill(params, batch, capacity=CAPACITY)
        out, toks = [logits], []
        for i in range(STEPS):
            tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True).to(torch.int32)
            toks.append(tok[:, 0])
            logits, caches = arch.decode(params, tok, caches, start + i)
            out.append(logits)
    return out, torch.stack(toks, dim=1), caches


@functools.lru_cache(maxsize=None)
def _unsharded(name, rows=None, **over):
    arch, params, batch, start = _setup(name, **over)
    if rows is not None:
        batch = {k: v[rows[0]:rows[1]] for k, v in batch.items()}
    return _serve(arch, params, batch, start)


def _cache_tensors(caches):
    """Every tensor of a LayerCaches or DecCaches, in order."""
    return tree_leaves(tuple(caches))


def _bitwise(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", FAMILIES)
def test_one_data_row_is_bitwise(name, layout):
    arch, params, batch, start = _setup(name)
    mesh = _mesh((1, 3))
    placed = LAYOUTS[layout](params, mesh)
    logits, toks, caches = _serve(arch, placed, batch, start)
    u_logits, u_toks, u_caches = _unsharded(name)
    assert isinstance(caches, MeshCaches) and len(caches.groups) == 1
    _bitwise(logits, u_logits)
    assert torch.equal(toks, u_toks)
    _bitwise(_cache_tensors(caches.groups[0]), _cache_tensors(u_caches))


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", FAMILIES)
def test_two_data_rows(name, layout):
    mesh = _mesh((2, 2))
    half = B // 2
    # A group's MoE layers dispatch as the whole batch, so its own rows'
    # serve keeps the same pairs only where nothing drops: reduced Jamba
    # (k = 2 of 4 experts) is held there at capacity factor E/k.
    over = NO_DROP.get(name, {})
    arch, params, batch, start = _setup(name, **over)
    logits, toks, caches = _serve(arch, LAYOUTS[layout](params, mesh), batch, start)
    assert len(caches.groups) == 2
    for g in range(2):           # each group bitwise its own rows' serve
        g_logits, g_toks, g_caches = _unsharded(name, (g * half, (g + 1) * half), **over)
        _bitwise([x[g * half:(g + 1) * half] for x in logits], g_logits)
        assert torch.equal(toks[g * half:(g + 1) * half], g_toks)
        _bitwise(_cache_tensors(caches.groups[g]), _cache_tensors(g_caches))
    if over:                     # the whole batch at the config's own capacity
        arch, params, batch, start = _setup(name)
        logits, toks, _ = _serve(arch, LAYOUTS[layout](params, mesh), batch, start)
    u_logits, u_toks, _ = _unsharded(name)
    for a, b in zip(logits, u_logits):       # the whole batch
        assert bool(((a - b).abs() <= WHOLE_RTOL * (1 + b.abs())).all())
    assert torch.equal(toks, u_toks)


def test_moe_groups_drop_the_whole_batch_pairs(monkeypatch):
    over = dict(experts_per_token=2, capacity_factor=0.5)
    arch, params, batch, _ = _setup("qwen3-moe-30b-a3b", **over)
    dropped = []
    moe = lm.moe_ffn

    def spy(p, x, cfg, dropless=False, dispatch=None):
        y, aux = moe(p, x, cfg, dropless=dropless, dispatch=dispatch)
        t = x.shape[0] * x.shape[1] * cfg.experts_per_token
        dropped.append(round(float(aux["moe_dropped_frac"]) * t))
        return y, aux

    monkeypatch.setattr(lm, "moe_ffn", spy)
    with torch.no_grad():
        want, _ = arch.prefill(params, batch, capacity=CAPACITY)
        whole = list(dropped)
        dropped.clear()
        got, caches = arch.prefill(place_rows(params, _mesh((2, 2))), batch,
                                   capacity=CAPACITY)
    layers = len(whole)
    assert sum(whole) > 0 and len(dropped) == 2 * layers
    assert [a + b for a, b in zip(dropped[:layers], dropped[layers:])] == whole
    assert bool(((got - want).abs() <= WHOLE_RTOL * (1 + want.abs())).all())


def test_mesh_serve_matches_reference():
    """The reference's serve steps and ``Arch.prefill``/``decode``, jitted
    (one compile each, not one per eager op)."""
    jc = dataclasses.replace(j_registry.get_config("smollm-360m").reduced(),
                             dtype="float32")
    ja = JArch(jc)
    jp = jax.jit(ja.init)(jax.random.PRNGKey(0))
    arch = Arch(dataclasses.replace(get_config("smollm-360m").reduced(), dtype="float32"))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    placed = shard_resident(params, _mesh((1, 2)))
    tok = np.random.RandomState(8).randint(0, jc.vocab_size, (2, PROMPT)).astype(np.int32)
    j_prefill = jax.jit(j_make_prefill(ja, capacity=CAPACITY))
    j_decode = jax.jit(j_make_decode(ja))
    j_logits = jax.jit(lambda p, b: ja.prefill(p, b, capacity=CAPACITY)[0])
    j_dec_logits = jax.jit(lambda p, t, c, i: ja.decode(p, t, c, i)[0])
    jn, jcache = j_prefill(jp, {"tokens": jnp.asarray(tok)})
    jlog = j_logits(jp, {"tokens": jnp.asarray(tok)})
    with torch.no_grad():
        tn, caches = make_prefill_step(arch, capacity=CAPACITY)(
            placed, {"tokens": torch.from_numpy(tok)})
        logits, _ = arch.prefill(placed, {"tokens": torch.from_numpy(tok)},
                                 capacity=CAPACITY)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), rtol=1e-5, atol=5e-5)
        _decided_equal(tn.numpy(), np.asarray(jn), logits.numpy()[:, -1])
        decode = make_decode_step(arch)
        feed = np.array(jn).reshape(2, 1)
        for i in range(STEPS):
            pos = PROMPT + i
            jlog = j_dec_logits(jp, jnp.asarray(feed), jcache, jnp.int32(pos))
            logits, _ = arch.decode(placed, torch.from_numpy(feed),
                                    MeshCaches(tuple(_clone(c) for c in caches.groups)), pos)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlog),
                                       rtol=1e-5, atol=5e-5)
            jn, jcache = j_decode(jp, jnp.asarray(feed), jcache, jnp.int32(pos))
            tn, caches = decode(placed, torch.from_numpy(feed), caches, pos)
            _decided_equal(tn.numpy(), np.asarray(jn), logits.numpy()[:, -1:])
            feed = np.array(jn).reshape(2, 1)
    for t_st, j_st in zip(caches.groups[0].caches, jcache.caches):
        for field, t, j in zip(t_st._fields, t_st, j_st):
            if field in ("pos", "idx"):
                np.testing.assert_array_equal(t.numpy(), np.asarray(j))
            else:
                np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=5e-5)


def _clone(caches):
    return type(caches)(tuple(type(c)(*(t.clone() for t in c)) for c in caches.caches))


def _decided_equal(t_next, j_next, logits, tol=5e-5):
    """Tokens equal wherever the top-two margin clears twice the tolerance
    (``tests/test_torch_lm.py``'s rule: an argmax can flip on a near tie)."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * tol
    assert decided.any()
    np.testing.assert_array_equal(t_next[decided], j_next[decided])


def test_placement_and_refusals():
    arch, params, batch, start = _setup("jamba-v0.1-52b")
    mesh = _mesh((2, 3))
    rows = place_rows(params, mesh)
    from_resident = place_rows(shard_resident(params, mesh), mesh)
    assert isinstance(rows, RowTrees) and len(rows.rows) == 2
    for placed in (rows, from_resident):
        for r, row in enumerate(placed.rows):
            assert isinstance(row, ResidentTree) and row.mesh.shape == (1, 3)
            assert row.mesh == mesh.row_mesh(r)
            for a, b in zip(tree_leaves(row.unshard("cpu")), tree_leaves(params)):
                assert a.dtype == b.dtype and torch.equal(a, b)
    per_row = rows.rows[0].resident_bytes()
    assert rows.resident_bytes() == per_row * 2 and len(per_row) == 3
    with torch.no_grad():
        _, caches = arch.prefill(params, batch, capacity=CAPACITY)
        with pytest.raises(TypeError, match="MeshCaches"):
            arch.decode(rows, batch["tokens"][:, :1], caches, start)
        with pytest.raises(ValueError, match="split"):
            arch.prefill(rows, {k: v[:3] for k, v in batch.items()}, capacity=CAPACITY)
