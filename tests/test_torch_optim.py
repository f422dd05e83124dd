"""The port's optimizers and schedules against the reference's, on the CPU.

Each optimizer runs 20 steps from the same params with the same
gradients (numpy, seeded; one float32 and one bf16 leaf in the tree) on
both sides.  Tolerances: float32 leaves within rtol 1e-5 / atol 1e-7
(``pow``, ``sqrt`` and ``cos`` may differ by an ulp between XLA and
PyTorch, and the bias corrections carry that into every step); bf16
leaves within one bf16 ulp (rtol 2⁻⁷), where such an ulp can flip a
rounding; the float32 moments and momenta within rtol 1e-5; Adam's step
counter exactly.  Schedules within rtol 1e-6 at every step from 0 to
past the end.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.optim as j_optim  # noqa: E402
import repro_torch.optim as t_optim  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402

STEPS = 20
OPTIMIZERS = {
    "sgd": lambda m: m.sgd(0.1),
    "sgd_momentum": lambda m: m.sgd_momentum(0.05),
    "sgd_nesterov": lambda m: m.sgd_momentum(0.05, beta=0.8, nesterov=True),
    "adam": lambda m: m.adam(3e-3),
    "adamw": lambda m: m.adamw(3e-3, weight_decay=0.1),
}


def _tree(rng):
    return {"w": (rng.randn(12, 7) * 0.5).astype(np.float32),
            "b": (rng.randn(7) * 0.5).astype(np.float32),
            "h": jnp.asarray(rng.randn(5, 3), jnp.bfloat16)}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(t, j):
    a, b = _f32(t), _f32(j)
    if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16:
        assert (np.abs(a - b) <= 2.0 ** -7 * np.abs(b) + 1e-30).all()
    else:
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_reference(name):
    rng = np.random.RandomState(len(name))
    jp = {k: jnp.asarray(v) for k, v in _tree(rng).items()}
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    j_init, j_update = OPTIMIZERS[name](j_optim)
    t_init, t_update = OPTIMIZERS[name](t_optim)
    js, ts = j_init(jp), t_init(tp)
    for _ in range(STEPS):
        g = {k: (rng.randn(*v.shape) * 0.3).astype(np.float32) for k, v in jp.items()}
        jg = {k: jnp.asarray(v, jp[k].dtype) for k, v in g.items()}
        tg = params_from_jax(jax.tree_util.tree_map(np.asarray, jg), device="cpu")
        jp, js = j_update(jg, js, jp)
        tp, ts = t_update(tg, ts, tp)
    for k in jp:
        assert str(tp[k].dtype).removeprefix("torch.") == str(jp[k].dtype)
        _close(tp[k], jp[k])
    j_state, t_state = jax.tree_util.tree_leaves(js), tree_leaves(ts)
    assert len(j_state) == len(t_state)
    for a, b in zip(t_state, j_state):
        if a.dtype == torch.int32:
            assert int(a) == int(b) == STEPS
        else:
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)


SCHEDULES = {
    "constant": lambda m: m.constant(3e-3),
    "cosine_decay": lambda m: m.cosine_decay(3e-3, 17),
    "cosine_decay_final": lambda m: m.cosine_decay(1.0, 13, final_frac=0.0),
    "warmup_cosine": lambda m: m.warmup_cosine(3e-3, 5, 20),
    "warmup_cosine_no_warmup": lambda m: m.warmup_cosine(0.1, 0, 9, 0.3),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_reference(name):
    j, t = SCHEDULES[name](j_optim), SCHEDULES[name](t_optim)
    for step in range(25):
        got = t(step)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(j(step)), rtol=1e-6, atol=0)
