"""The port's dense LLM serving path against the reference, on the CPU.

Same parameters on both sides: the reference initialises with
``jax.random`` and ``repro_torch.convert.params_from_jax`` carries the
tree across (bf16 leaves bit for bit).  Inputs come from numpy with a
seed.  Configs: the four reduced dense configs (all MHA after
``reduced()``) and a GQA variant of reduced SmolLM (d_model 384, 6
heads, 2 kv heads, head_dim 64), in float32 and bfloat16; and the
reduced MoE, SSM and hybrid configs (Qwen3-MoE with k = E = 4, so it
never drops, and its ``experts_per_token=2`` variant ``-k2``, which
drops; Falcon-Mamba; Jamba, 8 layers: one attention, seven Mamba, MoE
every second layer).  The Mamba caches (h, conv) are held to the same
tolerances as the KV caches.

Tolerances, with their reasons:

* float32: logits and caches within atol 5e-5 (+ rtol 1e-5).  Observed
  ≤ 4.1e-6 on logits of magnitude ≈ 3: sum order only.
* bfloat16: logits within atol 8e-2, caches within atol 5e-2 + rtol
  2e-2.  Observed ≤ 3.5e-2 on logits of magnitude ≈ 3 (two bf16 ulps):
  the frameworks round matmul outputs and residuals to bf16 at
  different points, and the blocked path keeps p float32 where the
  reference rounds it to bf16.
* Greedy tokens are compared only where the top-two logit margin is
  above twice the logit tolerance (an argmax can flip on a near tie).
* Reduced Jamba in bfloat16 is held sublayer by sublayer in
  ``tests/test_torch_lm_families.py`` (which says why).

The blocked path (``_sdpa_blocked``: the port's flash attention, plain
on the CPU; the reference's pure-JAX online softmax) is reached by
setting ``BLOCKED_SDPA_THRESHOLD`` small in both packages with
``monkeypatch``; ``tests/test_torch_flash.py`` drives it once at the
shipped threshold.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.attention as j_attention  # noqa: E402
import repro_torch.models.attention as t_attention  # noqa: E402
from repro.configs import registry as j_registry  # noqa: E402
from repro.launch.serve import make_decode_step as j_make_decode  # noqa: E402
from repro.launch.serve import make_prefill_step as j_make_prefill  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import mlp as jm  # noqa: E402
from repro.models.api import Arch as JArch  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.launch.serve import make_decode_step as t_make_decode  # noqa: E402
from repro_torch.launch.serve import make_prefill_step as t_make_prefill  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import mlp as tm  # noqa: E402
from repro_torch.models.api import Arch as TArch  # noqa: E402

DENSE = ["smollm-360m", "granite-8b", "qwen1.5-4b", "minitron-8b"]
FAMILIES = ["qwen3-moe-30b-a3b", "qwen3-moe-235b-a22b", "falcon-mamba-7b",
            "jamba-v0.1-52b"]
GQA = dict(d_model=384, num_heads=6, num_kv_heads=2, head_dim=64)
# PaliGemma's head_dim at reduced width: 2 heads over 1 kv head of 256.
HD256 = dict(d_model=512, num_heads=2, num_kv_heads=1, head_dim=256)
# A case is (name, dtype, variant): False = the reduced config, True = its
# GQA variant, "k2" = two experts a token (the MoE configs drop tokens),
# "hd256" = the head_dim-256 variant.
VARIANTS = {False: {}, True: GQA, "k2": dict(experts_per_token=2), "hd256": HD256}
SUFFIX = {False: "", True: "-gqa3", "k2": "-k2", "hd256": "-hd256"}
LOGIT_TOL = {"float32": dict(rtol=1e-5, atol=5e-5), "bfloat16": dict(rtol=0, atol=8e-2)}
CACHE_TOL = {"float32": dict(rtol=1e-5, atol=5e-5), "bfloat16": dict(rtol=2e-2, atol=5e-2)}
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
J_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

CASES = [(name, dt, False) for name in DENSE for dt in ("float32", "bfloat16")]
CASES += [("smollm-360m", dt, True) for dt in ("float32", "bfloat16")]
# Jamba in bf16 is held sublayer by sublayer (tests/test_torch_lm_families.py).
FAMILY_CASES = [(name, dt, variant) for name, variant in
                (("qwen3-moe-30b-a3b", False), ("qwen3-moe-30b-a3b", "k2"),
                 ("falcon-mamba-7b", False), ("jamba-v0.1-52b", False))
                for dt in ("float32", "bfloat16")
                if (name, dt) != ("jamba-v0.1-52b", "bfloat16")]


def _ids(case):
    name, dt, gqa = case
    return f"{name}-{dt}{SUFFIX[gqa]}"


def _cfgs(name, dtype, gqa=False, **more):
    over = dict(dtype=dtype, **VARIANTS[gqa], **more)
    return (dataclasses.replace(j_registry.get_config(name).reduced(), **over),
            dataclasses.replace(t_registry.get_config(name).reduced(), **over))


def _carry(jtree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jtree), device="cpu")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _assert_close(got, want, tol):
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


def _assert_caches(tc, jc, dtype):
    assert len(tc.caches) == len(jc.caches)
    for t_st, j_st in zip(tc.caches, jc.caches):
        assert type(t_st).__name__ == type(j_st).__name__
        assert t_st._fields == j_st._fields
        for field, t, j in zip(t_st._fields, t_st, j_st):
            assert tuple(t.shape) == j.shape
            if field in ("pos", "idx"):      # KV ring positions and count
                np.testing.assert_array_equal(t.numpy(), np.asarray(j))
            else:                            # k, v; Mamba h and conv
                _assert_close(t, j, CACHE_TOL[dtype])


@pytest.fixture
def blocked(monkeypatch):
    """Route prompts and caches longer than 8 through ``_sdpa_blocked``."""
    monkeypatch.setattr(j_attention, "BLOCKED_SDPA_THRESHOLD", 8)
    monkeypatch.setattr(t_attention, "BLOCKED_SDPA_THRESHOLD", 8)


# ---------------------------------------------------------------------------
# configs, registry, parameter tree
# ---------------------------------------------------------------------------

def _reference_fields(cfg) -> dict:
    """The port's config as a dict of the reference's fields: its own field,
    ``partial_rotary_factor``, must hold the reference's whole-head rotary."""
    d = dataclasses.asdict(cfg)
    assert d.pop("partial_rotary_factor") == 1.0
    return d


@pytest.mark.parametrize("name", DENSE + FAMILIES + ["paligemma-3b", "whisper-tiny"])
def test_config_is_the_references(name):
    j, t = j_registry.get_config(name), t_registry.get_config(name)
    jd, td = dataclasses.asdict(j), _reference_fields(t)
    if name == "smollm-360m":
        # the figures are the 360M model's; the reference cites the 135M card
        assert td.pop("source") == "hf:HuggingFaceTB/SmolLM-360M"
        jd.pop("source")
    if name == "qwen3-moe-235b-a22b":
        # the figures are the 235B model's; the reference cites the 30B card
        assert td.pop("source") == "hf:Qwen/Qwen3-235B-A22B"
        assert jd.pop("source") == "hf:Qwen/Qwen3-30B-A3B"
    assert td == jd
    assert _reference_fields(t.reduced()) == dataclasses.asdict(
        dataclasses.replace(j.reduced(), source=t.source))
    assert t.torch_dtype == torch.bfloat16 and t.reduced().torch_dtype == torch.float32


def test_registry_names_the_unported_families():
    """None is left: the port registers the reference's ten ids, in its
    order, each config field for field the reference's."""
    assert t_registry.NOT_PORTED == ()
    assert t_registry.ARCH_IDS == j_registry.ARCH_IDS and len(t_registry.ARCH_IDS) == 10
    for name in t_registry.ARCH_IDS:
        jd = dataclasses.asdict(j_registry.get_config(name))
        td = _reference_fields(t_registry.get_config(name))
        jd.pop("source"), td.pop("source")
        assert td == jd, name
    with pytest.raises(KeyError, match="unknown arch"):
        t_registry.get_config("no-such-arch")
    assert t_registry.get_arch("granite-8b", reduced=True).cfg.num_layers == 2


@pytest.mark.parametrize("case", [(n, "float32", False) for n in DENSE + FAMILIES]
                         + [("smollm-360m", "bfloat16", True),
                            ("paligemma-3b", "bfloat16", "hd256"),
                            ("whisper-tiny", "bfloat16", False)], ids=_ids)
def test_init_keeps_the_reference_tree(case):
    """Same paths, shapes and dtypes, in ``jax.tree_util`` leaf order."""
    jc, tc = _cfgs(*case)
    j_paths = jax.tree_util.tree_flatten_with_path(JArch(jc).init(jax.random.PRNGKey(0)))[0]
    t_params = TArch(tc).init(seed=0, device="cpu")

    def paths(tree, prefix=()):
        if isinstance(tree, dict):
            return [p for k in sorted(tree) for p in paths(tree[k], prefix + (k,))]
        if isinstance(tree, list):
            return [p for i, s in enumerate(tree) for p in paths(s, prefix + (i,))]
        return [(prefix, tree)]

    t_paths = paths(t_params)
    assert len(t_paths) == len(j_paths)
    for (tp, tleaf), (jp, jleaf) in zip(t_paths, j_paths):
        key = tuple(getattr(e, "key", getattr(e, "idx", None)) for e in jp)
        assert tp == key
        assert tuple(tleaf.shape) == jleaf.shape
        assert str(tleaf.dtype).removeprefix("torch.") == str(jleaf.dtype)
    assert [t.shape for t in tree_leaves(t_params)] == [tuple(x.shape) for _, x in t_paths]


def test_bf16_tree_crosses_bit_for_bit():
    jc, _ = _cfgs("smollm-360m", "bfloat16", gqa=True)
    jp = JArch(jc).init(jax.random.PRNGKey(3))
    tp = _carry(jp)
    j_leaves = jax.tree_util.tree_leaves(jp)
    t_leaves = tree_leaves(tp)
    assert len(j_leaves) == len(t_leaves)
    for j, t in zip(j_leaves, t_leaves):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == j.shape
        bits = np.asarray(j).view(np.uint16)
        np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16), bits)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_and_rope(dtype):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 3, 64).astype(np.float32) * 3
    jx, tx = jnp.asarray(x, J_DT[dtype]), torch.from_numpy(x).to(T_DT[dtype])
    scale = (1 + 0.1 * rng.randn(64)).astype(np.float32)
    bias = (0.1 * rng.randn(64)).astype(np.float32)
    jp = {"scale": jnp.asarray(scale, J_DT[dtype]), "bias": jnp.asarray(bias, J_DT[dtype])}
    tp = {"scale": torch.from_numpy(scale).to(T_DT[dtype]),
          "bias": torch.from_numpy(bias).to(T_DT[dtype])}
    # float32 inside, one rounding to the storage dtype at the end
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=8e-3, atol=1e-2)
    for fn in ("rmsnorm", "layernorm"):
        got, want = getattr(tl, fn)(tp, tx), getattr(jl, fn)(jp, jx)
        assert got.dtype == T_DT[dtype]
        _assert_close(got, want, tol)
    pos = np.array([0, 1, 7, 100, 4095], np.int32)
    for theta in (10000.0, 1e6):
        jcos, jsin = jl.rope_freqs(jnp.asarray(pos), 64, theta)
        tcos, tsin = tl.rope_freqs(torch.from_numpy(pos), 64, theta)
        _assert_close(tcos, jcos, dict(rtol=0, atol=2e-6))
        _assert_close(tsin, jsin, dict(rtol=0, atol=2e-6))
        _assert_close(tl.apply_rope(tx, tcos, tsin), jl.apply_rope(jx, jcos, jsin), tol)


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu", "relu2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ffn(activation, dtype):
    jc, tc = _cfgs("granite-8b", dtype, activation=activation)
    jp = jm.init_ffn(jax.random.PRNGKey(1), jc)
    if activation == "gelu":   # nonzero biases, so the test sees them
        jp = {k: {**v, "b": v["b"] + 0.1} for k, v in jp.items()}
    tp = _carry(jp)
    x = np.random.RandomState(2).randn(2, 7, jc.d_model).astype(np.float32)
    got = tm.ffn(tp, torch.from_numpy(x).to(T_DT[dtype]), tc)
    want = jm.ffn(jp, jnp.asarray(x, J_DT[dtype]), jc)
    assert got.dtype == T_DT[dtype]
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    _assert_close(got, want, tol)


# ---------------------------------------------------------------------------
# attention: prefill + decode through a wrapping ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["plain", "blocked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_ring_wrap(path, dtype, request):
    """A prompt longer than the ring, then decode steps that wrap it, with a
    sliding window equal to the capacity; the caches hold the last 10."""
    if path == "blocked":
        request.getfixturevalue("blocked")
    jc, tc = _cfgs("smollm-360m", dtype, gqa=True)
    jp = j_attention.init_attention(jax.random.PRNGKey(4), jc)
    tp = _carry(jp)
    cap, s, b = 10, 13, 2
    rng = np.random.RandomState(5)
    x = rng.randn(b, s + 6, jc.d_model).astype(np.float32)
    jcache = j_attention.init_cache(jc, b, cap)
    tcache = t_attention.init_cache(tc, b, cap, device="cpu")
    tol = LOGIT_TOL[dtype] if dtype == "float32" else dict(rtol=2e-2, atol=3e-2)
    for lo, hi in [(0, s)] + [(i, i + 1) for i in range(s, s + 6)]:
        pos = np.arange(lo, hi, dtype=np.int32)
        jy, jcache = j_attention.attention(
            jp, jnp.asarray(x[:, lo:hi], J_DT[dtype]), jc, positions=jnp.asarray(pos),
            window=cap, cache=jcache, update_cache=True)
        ty, tcache = t_attention.attention(
            tp, torch.from_numpy(x[:, lo:hi]).to(T_DT[dtype]), tc,
            positions=torch.from_numpy(pos), window=cap, cache=tcache,
            update_cache=True)
        _assert_close(ty, jy, tol)
        _assert_close(tcache.k, jcache.k, CACHE_TOL[dtype])
        _assert_close(tcache.v, jcache.v, CACHE_TOL[dtype])
        np.testing.assert_array_equal(tcache.pos.numpy(), np.asarray(jcache.pos))
        assert int(tcache.idx) == int(jcache.idx) == hi
    assert sorted(tcache.pos.tolist()) == list(range(s + 6 - cap, s + 6))


# ---------------------------------------------------------------------------
# the serving path
# ---------------------------------------------------------------------------

def _serve(case, steps=3, b=2, s=12, capacity=20):
    name, dtype, gqa = case
    jc, tc = _cfgs(name, dtype, gqa)
    ja, ta = JArch(jc), TArch(tc)
    jp = ja.init(jax.random.PRNGKey(0))
    tp = _carry(jp)
    rng = np.random.RandomState(6)
    tok = rng.randint(0, jc.vocab_size, (b, s)).astype(np.int32)
    jlog, jcache = ja.prefill(jp, {"tokens": jnp.asarray(tok)}, capacity=capacity)
    tlog, tcache = ta.prefill(tp, {"tokens": torch.from_numpy(tok)}, capacity=capacity)
    assert tlog.dtype == torch.float32 and tuple(tlog.shape) == (b, 1, jc.vocab_size)
    _assert_close(tlog, jlog, LOGIT_TOL[dtype])
    _assert_caches(tcache, jcache, dtype)
    for i in range(steps):
        t = rng.randint(0, jc.vocab_size, (b, 1)).astype(np.int32)
        jlog, jcache = ja.decode(jp, jnp.asarray(t), jcache, jnp.int32(s + i))
        tlog, tcache = ta.decode(tp, torch.from_numpy(t), tcache, s + i)
        _assert_close(tlog, jlog, LOGIT_TOL[dtype])
        _assert_caches(tcache, jcache, dtype)


@pytest.mark.parametrize("case", [("smollm-360m", "float32", True),
                                  ("qwen1.5-4b", "bfloat16", False),
                                  ("minitron-8b", "float32", False)]
                         + [c for c in FAMILY_CASES if c[1] == "float32"]
                         + [("falcon-mamba-7b", "bfloat16", False)], ids=_ids)
def test_forward(case):
    """lm_forward: logits at every position, no caches."""
    from repro.models.lm import lm_forward as j_forward
    from repro_torch.models.lm import lm_forward as t_forward

    name, dtype, gqa = case
    jc, tc = _cfgs(name, dtype, gqa)
    jp = JArch(jc).init(jax.random.PRNGKey(11))
    tok = np.random.RandomState(12).randint(0, jc.vocab_size, (2, 9)).astype(np.int32)
    got = t_forward(_carry(jp), tc, tokens=torch.from_numpy(tok))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 9, jc.vocab_size)
    _assert_close(got, j_forward(jp, jc, tokens=jnp.asarray(tok)), LOGIT_TOL[dtype])


@pytest.mark.parametrize("case", CASES + FAMILY_CASES, ids=_ids)
def test_prefill_decode(case):
    _serve(case)


@pytest.mark.parametrize("case", [c for c in CASES if c[2] is True] +
                         [("qwen1.5-4b", "float32", False),
                          ("qwen3-moe-30b-a3b", "float32", "k2"),
                          ("jamba-v0.1-52b", "float32", False)], ids=_ids)
def test_prefill_decode_blocked(case, blocked):
    _serve(case)


def _greedy_agrees(t_next, j_next, logits, tol):
    """Tokens equal wherever the top-two margin clears twice the tolerance."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * tol
    assert decided.any()
    np.testing.assert_array_equal(t_next[decided], j_next[decided])


def _clone(caches):
    return type(caches)(tuple(type(c)(*(t.clone() for t in c)) for c in caches.caches))


@pytest.mark.parametrize("case", [("smollm-360m", "float32", True),
                                  ("smollm-360m", "bfloat16", True),
                                  ("minitron-8b", "float32", False)], ids=_ids)
def test_serve_steps(case, blocked):
    """make_prefill_step / make_decode_step: greedy generation, fed back.

    The margins come from the port's logits (computed on a copy of its
    caches): within the tolerance of the reference's, so a margin above
    twice the tolerance decides both argmaxes alike.
    """
    name, dtype, gqa = case
    jc, tc = _cfgs(name, dtype, gqa)
    ja, ta = JArch(jc), TArch(tc)
    jp = ja.init(jax.random.PRNGKey(7))
    tp = _carry(jp)
    b, s, gen = 3, 10, 3
    tol = LOGIT_TOL[dtype]["atol"]
    tok = np.random.RandomState(8).randint(0, jc.vocab_size, (b, s)).astype(np.int32)
    jn, jcache = j_make_prefill(ja, capacity=s + gen + 2)(jp, {"tokens": jnp.asarray(tok)})
    tn, tcache = t_make_prefill(ta, capacity=s + gen + 2)(tp, {"tokens": torch.from_numpy(tok)})
    assert tn.dtype == torch.int32 and tuple(tn.shape) == (b,)
    tlog, _ = ta.prefill(tp, {"tokens": torch.from_numpy(tok)}, capacity=s + gen + 2)
    _greedy_agrees(tn.numpy(), np.asarray(jn), _f32(tlog)[:, -1], tol)
    j_dec, t_dec = j_make_decode(ja), t_make_decode(ta)
    # feed the reference's tokens to both, so one flipped tie cannot cascade
    feed = np.array(jn).reshape(b, 1)
    for i in range(gen):
        tlog, _ = ta.decode(tp, torch.from_numpy(feed), _clone(tcache), s + i)
        jn, jcache = j_dec(jp, jnp.asarray(feed), jcache, jnp.int32(s + i))
        tn, tcache = t_dec(tp, torch.from_numpy(feed), tcache, s + i)
        assert tn.dtype == torch.int32 and tuple(tn.shape) == (b, 1)
        _greedy_agrees(tn.numpy(), np.asarray(jn), _f32(tlog)[:, -1:], tol)
        feed = np.array(jn).reshape(b, 1)
    _assert_caches(tcache, jcache, dtype)

