"""The port's Mamba-1 layer (``repro_torch/models/mamba.py``) against the reference.

Same parameters on both sides (``params_from_jax``; ``a_log`` and
``d_skip`` float32 in either dtype); inputs from numpy with a seed.
d_model 32 (d_inner 64), N = 8, conv 4, dt rank 2 unless a case says
otherwise.

Tolerances, with their reasons:

* float32: outputs and caches within atol 5e-5 + rtol 1e-5
  (``tests/test_torch_lm.py``'s ``LOGIT_TOL``).  The scan's association
  order is open: the reference runs ``lax.associative_scan``, the port a
  doubling scan, so h differs by float32 rounding (observed ≤ 1e-6).
* bfloat16: outputs within atol 2e-2 + rtol 2e-2 (the projections round
  to bf16 at other points), h within the same (it is float32 on both
  sides, fed by bf16 projections), conv windows bit for bit where they
  are the inputs' own bf16 values.
* The reference's own oracles (chunked scan against the step recurrence,
  state carried across calls) keep their rtol/atol 2e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro_torch.models.mamba as t_mamba  # noqa: E402
from repro.models import mamba as j_mamba  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.models.config import ModelConfig as TConfig  # noqa: E402

T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
J_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TOL = {"float32": dict(rtol=1e-5, atol=5e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
BASE = dict(name="m", arch_type="ssm", num_layers=1, d_model=32, vocab_size=16,
            ssm_state=8, ssm_dt_rank=2)


def _cfgs(dtype="float32", **over):
    kw = {**BASE, "dtype": dtype, **over}
    return JConfig(**kw), TConfig(**kw)


def _carry(jtree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jtree), device="cpu")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype):
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


def _x(b, s, seed, scale=0.3):
    return (np.random.RandomState(seed).randn(b, s, 32) * scale).astype(np.float32)


def _params(jc, seed=0):
    jp = j_mamba.init_mamba(jax.random.PRNGKey(seed), jc)
    # nonzero conv and dt biases, so the test sees them
    jp = {**jp, "conv_b": jp["conv_b"] + 0.05,
          "dt_proj": {**jp["dt_proj"], "b": jp["dt_proj"]["b"] - 0.5}}
    return jp, _carry(jp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [77, 64, 5, 130])
def test_mamba_block_matches_reference(s, dtype):
    """Ragged S (77: one chunk and 13 padded steps; 130), a whole chunk,
    and a prompt shorter than a chunk."""
    jc, tc = _cfgs(dtype)
    jp, tp = _params(jc)
    x = _x(2, s, 1)
    jy, jcache = j_mamba.mamba_block(jp, jnp.asarray(x, J_DT[dtype]), jc)
    ty, tcache = t_mamba.mamba_block(tp, torch.from_numpy(x).to(T_DT[dtype]), tc)
    assert ty.dtype == T_DT[dtype] and tuple(ty.shape) == jy.shape
    assert tcache.h.dtype == torch.float32 and tcache.conv.dtype == T_DT[dtype]
    _close(ty, jy, dtype)
    _close(tcache.h, jcache.h, dtype)
    np.testing.assert_array_equal(_f32(tcache.conv), _f32(jcache.conv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_state_carried_across_two_calls_matches_reference(dtype):
    """block(x₁) then block(x₂ | h, conv) on both sides, x₁ ragged (50)."""
    jc, tc = _cfgs(dtype)
    jp, tp = _params(jc, 1)
    x = _x(2, 111, 2)
    jx, tx = jnp.asarray(x, J_DT[dtype]), torch.from_numpy(x).to(T_DT[dtype])
    _, jc1 = j_mamba.mamba_block(jp, jx[:, :50], jc)
    jy2, jc2 = j_mamba.mamba_block(jp, jx[:, 50:], jc, h0=jc1.h, conv_hist=jc1.conv)
    _, tc1 = t_mamba.mamba_block(tp, tx[:, :50], tc)
    ty2, tc2 = t_mamba.mamba_block(tp, tx[:, 50:], tc, h0=tc1.h, conv_hist=tc1.conv)
    _close(ty2, jy2, dtype)
    _close(tc2.h, jc2.h, dtype)
    np.testing.assert_array_equal(_f32(tc2.conv), _f32(jc2.conv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_step_matches_reference(dtype):
    """Six single-token steps from a prefilled state, on both sides."""
    jc, tc = _cfgs(dtype)
    jp, tp = _params(jc, 2)
    x = _x(3, 20, 3)
    jx, tx = jnp.asarray(x, J_DT[dtype]), torch.from_numpy(x).to(T_DT[dtype])
    _, jcache = j_mamba.mamba_block(jp, jx[:, :14], jc)
    _, tcache = t_mamba.mamba_block(tp, tx[:, :14], tc)
    for i in range(14, 20):
        jy, jcache = j_mamba.mamba_decode_step(jp, jx[:, i:i + 1], jc, jcache)
        ty, tcache = t_mamba.mamba_decode_step(tp, tx[:, i:i + 1], tc, tcache)
        assert tuple(ty.shape) == jy.shape == (3, 1, 32)
        _close(ty, jy, dtype)
        _close(tcache.h, jcache.h, dtype)
        np.testing.assert_array_equal(_f32(tcache.conv), _f32(jcache.conv))


def test_mamba_block_grads_match_reference():
    """Gradients of Σ y·c (S = 77) reach every leaf and x as in the reference."""
    jc, tc = _cfgs()
    jp, tp = _params(jc, 3)
    x = _x(2, 77, 4)
    c = np.random.RandomState(5).randn(2, 77, 32).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(j_mamba.mamba_block(p, xx, jc)[0] * c)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = tree_leaves(tp)
    for w in leaves:
        w.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    loss = torch.sum(t_mamba.mamba_block(tp, tx, tc)[0] * torch.from_numpy(c))
    grads = torch.autograd.grad(loss, leaves + [tx])
    want = jax.tree_util.tree_leaves(jg) + [jgx]
    assert len(grads) == len(want)
    for tg, jgl in zip(grads, want):
        a, b = _f32(jgl), _f32(tg)
        assert np.abs(a).max() > 0
        assert np.abs(a - b).max() <= 2e-5 * np.abs(a).max()


def test_chunk_scan_is_the_recurrence():
    """The doubling scan equals the step-by-step recurrence h_t = a_t h_{t−1}
    + b_t (h_{−1} = 0) at chunk lengths 1, 2, 37 and 64."""
    g = torch.Generator().manual_seed(0)
    for c in (1, 2, 37, 64):
        a = torch.rand((2, c, 3, 4), generator=g)
        b = torch.randn((2, c, 3, 4), generator=g)
        h = torch.zeros((2, 3, 4))
        want = []
        for t in range(c):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        torch.testing.assert_close(t_mamba._chunk_scan(a, b), torch.stack(want, 1),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_mamba_keeps_the_reference_tree(dtype):
    jc, tc = _cfgs(dtype)
    jp = j_mamba.init_mamba(jax.random.PRNGKey(0), jc)
    tp = t_mamba.init_mamba(torch.Generator().manual_seed(0), tc)
    j_paths = jax.tree_util.tree_flatten_with_path(jp)[0]
    t_leaves = tree_leaves(tp)
    assert len(t_leaves) == len(j_paths)
    for t, (_, j) in zip(t_leaves, j_paths):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
    # the deterministic leaves are the reference's: a_log = log(j + 1)
    # within one float32 ulp (torch's log and XLA's round apart), the
    # rest bit for bit
    np.testing.assert_allclose(_f32(tp["a_log"]), _f32(jp["a_log"]), rtol=1.2e-7, atol=0)
    for key in ("d_skip", "conv_b"):
        np.testing.assert_array_equal(_f32(tp[key]), _f32(jp[key]))
    np.testing.assert_array_equal(_f32(tp["dt_proj"]["b"]), _f32(jp["dt_proj"]["b"]))
    cache = t_mamba.init_mamba_cache(tc, 3, device="cpu")
    jcache = j_mamba.init_mamba_cache(jc, 3)
    assert tuple(cache.h.shape) == jcache.h.shape and cache.h.dtype == torch.float32
    assert tuple(cache.conv.shape) == jcache.conv.shape
    assert cache.conv.dtype == T_DT[dtype]


# ---------------------------------------------------------------------------
# mirrors of tests/test_attention_mamba_moe.py's Mamba oracles, on the port
# ---------------------------------------------------------------------------

def test_port_mamba_chunked_scan_vs_stepwise():
    """Full-sequence chunked scan == token-by-token recurrence."""
    _, cfg = _cfgs(ssm_dt_rank=0)
    p = t_mamba.init_mamba(torch.Generator().manual_seed(0), cfg)
    S = 77   # ragged vs chunk 64
    x = torch.randn((2, S, 32), generator=torch.Generator().manual_seed(5)) * 0.3
    y_full, cache_full = t_mamba.mamba_block(p, x, cfg)
    cache = t_mamba.init_mamba_cache(cfg, 2, device="cpu")
    outs = []
    for i in range(S):
        y, cache = t_mamba.mamba_decode_step(p, x[:, i:i + 1], cfg, cache)
        outs.append(y)
    y_step = torch.cat(outs, dim=1)
    torch.testing.assert_close(y_step, y_full, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(cache.h, cache_full.h, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(cache.conv, cache_full.conv, rtol=0, atol=0)


def test_port_mamba_state_carry_across_calls():
    """block(x₁∥x₂) == block(x₁) then block(x₂ | state)."""
    _, cfg = _cfgs(ssm_dt_rank=0)
    p = t_mamba.init_mamba(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((1, 128, 32), generator=torch.Generator().manual_seed(6)) * 0.3
    y_all, _ = t_mamba.mamba_block(p, x, cfg)
    y1, c1 = t_mamba.mamba_block(p, x[:, :64], cfg)
    y2, _ = t_mamba.mamba_block(p, x[:, 64:], cfg, h0=c1.h, conv_hist=c1.conv)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y_all, rtol=2e-4, atol=2e-4)
