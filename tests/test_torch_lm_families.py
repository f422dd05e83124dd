"""The MoE, SSM and hybrid families of the port's LM stack: the checks that
need more than one case of ``tests/test_torch_lm.py`` or
``tests/test_torch_train.py`` (whose parametrised tests carry the
families' forward, prefill/decode, loss, gradient and train-step cases).

* The registry serves the four configs reduced on the CPU.
* Reduced Jamba (8 layers: one attention, seven Mamba, MoE every second
  layer) in bfloat16, sublayer by sublayer on the reference's own input,
  within the FFN test's atol/rtol 2e-2.  Whole, its 16 sublayers carry
  the reference's FFN roundings (one bf16 ulp in 30–50% of a dense FFN's
  outputs, where XLA keeps excess precision between the FFN's
  elementwise ops) to 0.10 on logits of magnitude ≈ 3 (measured), beyond
  the 2-layer bf16 tolerance of ``test_torch_lm.py``, and a near tie of
  the router's logits can then flip a route.
* Reduced Jamba in float32: ``lm_loss`` and its gradients, and one train
  step, against the reference.  The rounding noise grows with the depth:
  the reference's own jitted and eager gradients differ by up to 7.0e-6
  of a leaf's largest |gradient| (1.0e-6 on 2-layer Falcon-Mamba), the
  port's from the jitted ones by up to 2.2e-5 (observed; a dense 8-layer
  model 2.3e-6, Falcon-Mamba at 8 layers 6.2e-6, so the Mamba layers
  carry it).  Gradients within 1e-4 of the leaf's largest, each client's
  r within 1e-4·(1 + |r|) (observed 2.7e-5 at |r| ≈ 4.4); a wrong
  sublayer or cache moves them by far more.
* The serving invariant on the port (prefill + decode ≡ the training
  forward), mirroring ``tests/test_models.py::test_decode_matches_forward``.
* ``init_lm`` fills each stacked leaf in place, period by period: bitwise
  the per-layer draw-then-stack it replaced.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as j_registry  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.models.api import Arch as JArch  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from test_torch_lm import FAMILIES, _assert_close, _carry, _cfgs, _ids  # noqa: E402
from test_torch_train import _check_loss_and_grads, _check_train_step  # noqa: E402

HYBRID = ("jamba-v0.1-52b", "float32", False)
HYBRID_GRAD_TOL, HYBRID_R_RTOL = 1e-4, 1e-4


def test_registry_serves_the_moe_ssm_and_hybrid_families():
    assert t_registry.NOT_PORTED == ()
    for name in FAMILIES:
        arch = t_registry.get_arch(name, reduced=True)
        assert arch.cfg == t_registry.get_config(name).reduced()
        j_kinds = j_lm.period_structure(j_registry.get_config(name).reduced())
        assert t_lm.period_structure(arch.cfg) == j_kinds


def test_hybrid_sublayers_bf16():
    """Each of reduced Jamba's 8 sublayers (Mamba or attention, then a
    dense or MoE FFN) in bf16 on the reference's own input, prompt 9."""
    jc, tc = _cfgs("jamba-v0.1-52b", "bfloat16")
    jp = JArch(jc).init(jax.random.PRNGKey(11))
    tp = _carry(jp)
    tok = np.random.RandomState(12).randint(0, jc.vocab_size, (2, 9)).astype(np.int32)
    x = j_lm._embed_inputs(jp, jc, jnp.asarray(tok), None)
    _, nper, kinds = j_lm.period_structure(jc)
    assert nper == 1 and [k for k, _ in kinds].count("attn") == 1
    assert [f for _, f in kinds].count("moe") == 4
    jpos, tpos = jnp.arange(9, dtype=jnp.int32), torch.arange(9, dtype=torch.int32)
    for i, (kind, ffn_kind) in enumerate(kinds):
        jsub = jax.tree_util.tree_map(lambda w: w[0], jp["period"][i])
        jy, _ = j_lm._sublayer_fwd(jsub, x, jc, kind, ffn_kind, jpos, 0, 0)
        ty, _ = t_lm._sublayer_fwd(t_lm.stack_slice(tp["period"], 0)[i],
                                   _carry(x), tc, kind, ffn_kind, tpos, 0, 0)
        assert ty.dtype == torch.bfloat16
        _assert_close(ty, jy, dict(rtol=2e-2, atol=2e-2))
        x = jy


def test_hybrid_lm_loss_and_grads_match_reference():
    _check_loss_and_grads(HYBRID, HYBRID_GRAD_TOL)


def test_hybrid_train_step_matches_reference(monkeypatch):
    _check_train_step(HYBRID, monkeypatch, HYBRID_R_RTOL)


def _consistency_cfg(kind):
    """``tests/test_models.py``'s configs of ``test_decode_matches_forward``."""
    common = dict(num_layers=2, d_model=64, vocab_size=128, dtype="float32")
    if kind == "dense":
        return ModelConfig(name="t", arch_type="dense", num_heads=4,
                           num_kv_heads=2, d_ff=128, **common)
    if kind == "window":
        return ModelConfig(name="t", arch_type="dense", num_heads=4,
                           num_kv_heads=2, d_ff=128, window=16, **common)
    if kind == "ssm":
        return ModelConfig(name="t", arch_type="ssm", ssm_state=8, **common)
    return ModelConfig(name="t", arch_type="hybrid", num_heads=4,
                       num_kv_heads=2, d_ff=128, num_experts=4,
                       experts_per_token=2, attn_period=8, attn_offset=4,
                       moe_period=2, ssm_state=8, capacity_factor=8.0,
                       num_layers=8, d_model=64, vocab_size=128,
                       dtype="float32")


@pytest.mark.parametrize("kind", ["dense", "window", "ssm", "hybrid"])
def test_port_decode_matches_forward(kind):
    """Prefill + decode logits equal the training forward's, with the
    reference test's tolerances."""
    cfg = _consistency_cfg(kind)
    p = t_lm.init_lm(cfg, torch.Generator().manual_seed(0))
    S = 48
    tokens = torch.from_numpy(np.random.RandomState(2).randint(0, cfg.vocab_size,
                                                               (2, S + 3)))
    full = t_lm.lm_forward(p, cfg, tokens=tokens)
    cap = cfg.window if cfg.window else S + 4
    lp, caches = t_lm.lm_prefill(p, cfg, tokens=tokens[:, :S], capacity=cap)
    torch.testing.assert_close(lp[:, 0], full[:, S - 1], rtol=1e-4, atol=1e-4)
    for i in range(3):
        lg, caches = t_lm.lm_decode(p, cfg, tokens[:, S + i:S + i + 1], caches, S + i)
        torch.testing.assert_close(lg[:, 0], full[:, S + i], rtol=1e-4, atol=2e-4)


def _draw_then_stack(cfg, gen):
    """The init that ``init_lm`` replaced: every period's sublayer drawn
    whole, then the list stacked (twice the period params at its peak)."""
    from repro_torch.models.layers import init_embedding, init_linear, init_norm

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    _, nper, kinds = t_lm.period_structure(cfg)
    dt = cfg.torch_dtype
    period = [stack([t_lm._init_sublayer(gen, cfg, kind, ffn_kind) for _ in range(nper)])
              for kind, ffn_kind in kinds]
    params = {"embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dt),
              "period": period,
              "final_norm": init_norm(cfg.d_model, cfg.norm, dt, gen.device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear(gen, cfg.d_model, cfg.vocab_size, False, dt)
    return params


@pytest.mark.parametrize("case", [("granite-8b", "bfloat16", False),
                                  ("smollm-360m", "float32", True),
                                  ("jamba-v0.1-52b", "bfloat16", False)], ids=_ids)
def test_init_fills_stacks_bit_for_bit_as_draw_then_stack(case):
    """Every bit, so the generator's draws and their order, as before (3
    periods of the dense configs, untied and tied; 2 of Jamba's)."""
    _, tc = _cfgs(*case)
    tc = dataclasses.replace(tc, num_layers=(2 * tc.attn_period) if tc.attn_period else 3)
    got = t_lm.init_lm(tc, torch.Generator().manual_seed(5))
    want = _draw_then_stack(tc, torch.Generator().manual_seed(5))
    g, w = tree_leaves(got), tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
