"""The port's MoE FFN (``repro_torch/models/moe.py``) against the reference.

Same parameters on both sides: the reference initialises with
``jax.random`` and ``repro_torch.convert.params_from_jax`` carries them
across (bf16 leaves bit for bit, the router in float32); inputs come
from numpy with a seed.  E = 4 experts, k = 2, d_model 32, d_ff 16 unless
a case says otherwise.

Tolerances, with their reasons:

* float32: y within atol 5e-5 + rtol 1e-5 (``tests/test_torch_lm.py``'s
  ``LOGIT_TOL``; observed ≤ 1e-6: matmul sum order); the aux loss within
  1e-6 (a mean of softmaxes); the dropped fraction and the routes equal.
* bfloat16: y within atol 2e-2 + rtol 2e-2 (``test_torch_lm.py``'s FFN
  tolerance: the frameworks round the expert products' outputs to bf16
  at other points); routes and the dropped fraction equal (the router is
  float32 on both sides).
* Gradients (float32): each leaf within 2e-5 of its largest |gradient|,
  as ``tests/test_torch_train.py``'s ``GRAD_TOL``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro_torch.models.moe as t_moe  # noqa: E402
from repro.models import mlp as j_mlp  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.models import mlp as t_mlp  # noqa: E402
from repro_torch.models.config import ModelConfig as TConfig  # noqa: E402

T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
J_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
Y_TOL = {"float32": dict(rtol=1e-5, atol=5e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
BASE = dict(name="moe", arch_type="moe", num_layers=1, d_model=32, num_heads=2,
            num_kv_heads=1, d_ff=16, vocab_size=16, num_experts=4,
            experts_per_token=2, dtype="float32")


def _cfgs(**over):
    kw = {**BASE, **over}
    return JConfig(**kw), TConfig(**kw)


def _carry(jtree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jtree), device="cpu")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _both(jc, tc, x, dropless=False, params=None, seed=0):
    jp = params if params is not None else j_moe.init_moe(jax.random.PRNGKey(seed), jc)
    jy, jaux = j_moe.moe_ffn(jp, jnp.asarray(x, J_DT[jc.dtype]), jc, dropless=dropless)
    ty, taux = t_moe.moe_ffn(_carry(jp), torch.from_numpy(x).to(T_DT[tc.dtype]), tc,
                             dropless=dropless)
    return (jy, jaux), (ty, taux)


def _assert_moe(j, t, dtype):
    (jy, jaux), (ty, taux) = j, t
    assert ty.dtype == T_DT[dtype] and tuple(ty.shape) == jy.shape
    np.testing.assert_allclose(_f32(ty), _f32(jy), **Y_TOL[dtype])
    assert taux["moe_aux_loss"].dtype == torch.float32
    np.testing.assert_allclose(float(taux["moe_aux_loss"]), float(jaux["moe_aux_loss"]),
                               rtol=0, atol=1e-6)
    assert float(taux["moe_dropped_frac"]) == float(jaux["moe_dropped_frac"])


# capacity factor, dropless, (batch, seq)
CASES = {
    "cf2": (2.0, False, (4, 32)),
    "cf1": (1.0, False, (4, 32)),
    "cf0.5": (0.5, False, (4, 32)),
    "dropless": (1.25, True, (2, 16)),
    "decode": (1.25, True, (3, 1)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_matches_reference(case, dtype):
    cf, dropless, (b, s) = CASES[case]
    jc, tc = _cfgs(capacity_factor=cf, dtype=dtype)
    x = np.random.RandomState(1).randn(b, s, 32).astype(np.float32)
    j, t = _both(jc, tc, x, dropless)
    _assert_moe(j, t, dtype)
    dropped = float(t[1]["moe_dropped_frac"])
    if dropless:
        assert dropped == 0.0
    elif cf <= 1.0:
        assert dropped > 0.0         # the case exercises the overflow drop


def _router_params(jc, w_router):
    jp = j_moe.init_moe(jax.random.PRNGKey(2), jc)
    return {**jp, "router": {"w": jnp.asarray(w_router, jnp.float32)}}


@pytest.mark.parametrize("s,capacity", [(5, 2), (7, 4), (3, 2)])
def test_capacity_rounds_half_to_even(s, capacity):
    """T·k/E·cf = s/2 at cf 1: Python's round takes 2.5 → 2, 3.5 → 4 and
    1.5 → 2 (a ceiling would give 3, 4 and 2).  Every token is routed to
    experts 0 and 1, so each keeps exactly ``capacity`` of its s tokens."""
    jc, tc = _cfgs(capacity_factor=1.0)
    w = np.zeros((32, 4), np.float32)
    w[:, 0], w[:, 1] = 1.0, 0.5
    x = np.abs(np.random.RandomState(3).randn(1, s, 32)).astype(np.float32) + 0.1
    j, t = _both(jc, tc, x, params=_router_params(jc, w))
    _assert_moe(j, t, "float32")
    assert float(t[1]["moe_dropped_frac"]) == pytest.approx(1 - capacity / s)


def test_route_breaks_ties_to_the_lower_index():
    logits = np.array([[0.0, 1.0, 1.0, 1.0], [2.0, 2.0, 2.0, 2.0],
                       [3.0, -1.0, 3.0, 0.5], [0.5, 0.5, 0.25, 0.5]], np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(logits), k)
        tv, ti = t_moe._route(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_moe_ffn_with_tied_router_logits():
    """Experts 1, 2 and 3 share one router column (equal logits, larger
    than expert 0's): top-2 must be experts 1 and 2 on both sides."""
    jc, tc = _cfgs(capacity_factor=2.0)
    w = np.random.RandomState(4).randn(32, 4).astype(np.float32) * 0.1
    w[:, 2] = w[:, 3] = w[:, 1]
    x = np.random.RandomState(5).randn(2, 8, 32).astype(np.float32)
    x = np.where((x @ w[:, 1] > x @ w[:, 0])[..., None], x, -x).astype(np.float32)
    seen = []

    def spy(logits, k):
        out = route(logits, k)
        seen.append(out[1])
        return out

    route = t_moe._route
    mp = pytest.MonkeyPatch()
    mp.setattr(t_moe, "_route", spy)
    try:
        j, t = _both(jc, tc, x, params=_router_params(jc, w))
    finally:
        mp.undo()
    _assert_moe(j, t, "float32")
    (ti,) = seen
    assert (ti.numpy() == np.array([1, 2])).all()


def test_moe_grads_match_reference():
    """Gradients of Σ y·c with drops (cf 0.5) reach the router, the three
    expert stacks and x as in the reference."""
    jc, tc = _cfgs(capacity_factor=0.5)
    rng = np.random.RandomState(6)
    x = rng.randn(2, 16, 32).astype(np.float32)
    c = rng.randn(2, 16, 32).astype(np.float32)
    jp = j_moe.init_moe(jax.random.PRNGKey(7), jc)

    def jloss(p, xx):
        return jnp.sum(j_moe.moe_ffn(p, xx, jc)[0] * c)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: {kk: vv.requires_grad_(True) for kk, vv in v.items()}
          if isinstance(v, dict) else v.requires_grad_(True) for k, v in _carry(jp).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    loss = torch.sum(t_moe.moe_ffn(tp, tx, tc)[0] * torch.from_numpy(c))
    grads = torch.autograd.grad(loss, tree_leaves(tp) + [tx])
    want = jax.tree_util.tree_leaves(jg) + [jgx]
    assert len(grads) == len(want) == 5
    for tg, jgl in zip(grads, want):
        a, b = _f32(jgl), _f32(tg)
        assert np.abs(a).max() > 0
        assert np.abs(a - b).max() <= 2e-5 * np.abs(a).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_moe_keeps_the_reference_tree(dtype):
    jc, tc = _cfgs(dtype=dtype)
    jp = j_moe.init_moe(jax.random.PRNGKey(0), jc)
    tp = t_moe.init_moe(torch.Generator().manual_seed(0), tc)
    j_leaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    t_leaves = tree_leaves(tp)
    assert len(t_leaves) == len(j_leaves) == 4
    for t, (_, j) in zip(t_leaves, j_leaves):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
    assert tp["router"]["w"].dtype == torch.float32


# ---------------------------------------------------------------------------
# mirrors of tests/test_attention_mamba_moe.py's MoE oracles, on the port
# ---------------------------------------------------------------------------

def test_port_moe_single_expert_equals_dense_ffn():
    """E=1, k=1, dropless → MoE ≡ plain SwiGLU FFN with expert-0 weights."""
    _, cfg = _cfgs(name="m1", d_ff=64, num_experts=1, experts_per_token=1)
    p = t_moe.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((2, 8, 32), generator=torch.Generator().manual_seed(7))
    y_moe, aux = t_moe.moe_ffn(p, x, cfg, dropless=True)
    dense_p = {"w_gate": {"w": p["w_gate"][0]}, "w_up": {"w": p["w_up"][0]},
               "w_down": {"w": p["w_down"][0]}}
    y_dense = t_mlp.ffn(dense_p, x, cfg)
    torch.testing.assert_close(y_moe, y_dense, rtol=1e-5, atol=1e-5)
    assert float(aux["moe_dropped_frac"]) == 0.0
    # and the reference's ffn on the same weights agrees
    jd = {k: {"w": jnp.asarray(v["w"].numpy())} for k, v in dense_p.items()}
    np.testing.assert_allclose(_f32(y_moe), np.asarray(j_mlp.ffn(jd, jnp.asarray(x.numpy()),
                                                                 _cfgs()[0])),
                               rtol=1e-5, atol=1e-5)


def test_port_moe_dropless_no_drops_and_topk_weighting():
    _, cfg = _cfgs(name="m4")
    p = t_moe.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((2, 16, 32), generator=torch.Generator().manual_seed(8))
    y, aux = t_moe.moe_ffn(p, x, cfg, dropless=True)
    assert float(aux["moe_dropped_frac"]) == 0.0
    assert y.shape == x.shape
    assert bool(torch.isfinite(y).all())
    assert float(aux["moe_aux_loss"]) > 0
    # the top-k weighting: y is Σ_k softmax(top-k logits)_k · expert_k(x)
    logits = x.reshape(-1, 32) @ p["router"]["w"]
    topv, topi = t_moe._route(logits, 2)
    probs = torch.softmax(topv, dim=-1)
    want = torch.zeros((32, 32))
    for t_ in range(32):
        for j in range(2):
            e = int(topi[t_, j])
            ep = {"w_gate": {"w": p["w_gate"][e]}, "w_up": {"w": p["w_up"][e]},
                  "w_down": {"w": p["w_down"][e]}}
            want[t_] += probs[t_, j] * t_mlp.ffn(ep, x.reshape(-1, 32)[t_:t_ + 1], cfg)[0]
    torch.testing.assert_close(y.reshape(-1, 32), want, rtol=1e-5, atol=1e-5)


def test_port_moe_capacity_drops_monotone():
    """Lower capacity factor ⇒ more dropped tokens (never negative)."""
    _, base = _cfgs(name="mc", capacity_factor=2.0)
    x = torch.randn((4, 32, 32), generator=torch.Generator().manual_seed(9))
    drops = []
    for cf in (2.0, 1.0, 0.5):
        cfg = dataclasses.replace(base, capacity_factor=cf)
        p = t_moe.init_moe(torch.Generator().manual_seed(0), cfg)
        _, aux = t_moe.moe_ffn(p, x, cfg)
        drops.append(float(aux["moe_dropped_frac"]))
    assert drops[0] <= drops[1] <= drops[2]
    assert all(0.0 <= d <= 1.0 for d in drops)
    assert drops[2] > 0.0


@pytest.mark.parametrize("shift,fails", [(0.0, False), (5e-5, False), (1e-2, True)],
                         ids=["same", "near-tie", "fault"])
def test_route_replay_passes_near_ties_and_fails_faults(shift, fails):
    """``torch_parity.MoERoutes`` (the card-against-CPU replay of
    ``tests/test_torch_cuda.py`` and ``chip_smoke.py``): the recording
    run's router logits differ from the replaying run's by ``shift`` on
    expert 1 of token 0, where experts 1 and 2 tie; the flip is counted,
    and ``check`` fails only when the recorded choice is further than a
    near tie below the replaying run's k-th logit."""
    from torch_parity import MoERoutes

    rng = np.random.RandomState(3)
    logits = torch.from_numpy(rng.randn(16, 4).astype(np.float32))
    logits[0] = torch.tensor([3.0, 1.0, 1.0, -1.0])
    card = logits.clone()
    card[0, 1] += shift
    cpu = logits.clone()
    cpu[0, 2] += shift                      # the CPU prefers expert 2
    routes = MoERoutes()
    with routes.use("record"):
        t_moe._route(card, 2)
    with routes.use("replay"):
        vals, idx = t_moe._route(cpu, 2)
    assert t_moe._route is routes.route
    assert idx.tolist()[0] == [0, 1]           # the card's choice, replayed
    torch.testing.assert_close(vals, cpu.gather(-1, idx))
    assert routes.tokens == 16 and routes.differ == (1 if shift else 0)
    assert routes.margin == pytest.approx(shift, abs=1e-7)
    if fails:
        with pytest.raises(AssertionError, match="near tie"):
            routes.check("rr")
    else:
        routes.check("rr")
