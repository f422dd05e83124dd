"""The client-parallel train step against the reference's and the port's own.

``repro_torch.launch.train.make_train_step_client_parallel`` (the N
replicas stacked, the clients' local SGD as one batched computation, one
encode over the N stacked δ) is held, on reduced configs of all six
families in float32 with the reference's weights carried across by
``convert.py``:

* against the reference's meshless ``make_train_step_client_parallel``
  (``jax.vmap`` of ``value_and_grad``; the hybrid at one period of
  attention and Mamba), within ``tests/test_torch_train.py``'s
  limits: loss within 1e-5, each r within 1e-5·(1 + |r|), every new param
  within the mean |Δr| plus 1e-6;
* against the port's sequential ``make_train_step`` on the same inputs,
  within the same limits, with one encode launch group for the N clients
  (the sequential step encodes them one by one).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.launch.train as j_train  # noqa: E402
from repro.models.api import Arch as JArch  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.train import (  # noqa: E402
    FLRunConfig,
    make_train_step,
    make_train_step_client_parallel,
)
from repro_torch.models.api import Arch as TArch  # noqa: E402
from test_torch_lm import _cfgs  # noqa: E402
from test_torch_train import _carry, _f32, _tokens, _with_frontend  # noqa: E402

FAMILIES = ["smollm-360m", "qwen3-moe-30b-a3b", "falcon-mamba-7b", "jamba-v0.1-52b",
            "paligemma-3b", "whisper-tiny"]
N, S, LR = 4, 2, 0.05


def _check(t_m, t_new, want_loss, want_r, want_new, tp):
    assert abs(float(t_m["loss"]) - float(want_loss)) <= 1e-5
    t_r = t_m["r"].numpy()
    assert t_r.shape == (N, 1)
    assert (np.abs(t_r - want_r) <= 1e-5 * (1 + np.abs(want_r))).all()
    dr = float(np.abs(t_r - want_r).sum()) / N
    for w, a, b in zip(tree_leaves(tp), want_new, tree_leaves(t_new)):
        assert b.dtype == w.dtype and tuple(b.shape) == tuple(w.shape)
        assert (np.abs(_f32(a) - _f32(b)) <= dr + 1e-6).all()


@pytest.mark.parametrize("name", FAMILIES)
def test_client_parallel_matches_reference_and_sequential(name, monkeypatch):
    # the hybrid at one period of (attention, Mamba), its MoE every second
    # layer: the family's three kinds of sublayer at a quarter of the depth
    more = (dict(num_layers=2, attn_period=2, attn_offset=0, moe_period=2)
            if name == "jamba-v0.1-52b" else {})
    jc, tc = _cfgs(name, "float32", **more)
    jp = JArch(jc).init(jax.random.PRNGKey(0))
    tp = _carry(jp)
    jb, tb = _with_frontend(jc, *_tokens(jc.vocab_size, N * S, 8, 0), 5)
    seen = {}
    aggregate = j_train.server_aggregate

    def spy(p, rs, seeds, pcfg):
        jax.debug.callback(lambda r: seen.__setitem__("rs", np.asarray(r)), rs)
        return aggregate(p, rs, seeds, pcfg)

    monkeypatch.setattr(j_train, "server_aggregate", spy)
    j_fl = j_train.FLRunConfig(num_virtual_clients=N, local_steps=S, local_lr=LR)
    # jitted: one compile instead of one per scanned op
    j_new, j_m = jax.jit(j_train.make_train_step_client_parallel(JArch(jc), j_fl, jp))(
        jp, jb, jnp.int32(3))
    jax.effects_barrier()
    fl = FLRunConfig(num_virtual_clients=N, local_steps=S, local_lr=LR)
    before = tree_map(torch.clone, tp)
    launches = ops.project_tree_kernel
    calls = []
    monkeypatch.setattr(ops, "project_tree_kernel",
                        lambda d, *a, **k: calls.append(tree_leaves(d)[0].shape[0])
                        or launches(d, *a, **k))
    t_new, t_m = make_train_step_client_parallel(TArch(tc), fl)(tp, tb, 3)
    assert calls == [N]                          # one encode for the N clients
    for a, b in zip(tree_leaves(tp), tree_leaves(before)):
        assert torch.equal(a, b)                 # global params untouched
    assert t_m["uploaded_scalars"] == int(j_m["uploaded_scalars"]) == 2 * N
    _check(t_m, t_new, j_m["loss"], seen["rs"].reshape(N, 1),
           jax.tree_util.tree_leaves(j_new), tp)
    calls.clear()
    s_new, s_m = make_train_step(TArch(tc), fl)(tp, tb, 3)
    assert calls == [1] * N                      # the sequential step: one each
    torch.testing.assert_close(t_m["seeds"], s_m["seeds"], rtol=0, atol=0)
    _check(t_m, t_new, s_m["loss"], s_m["r"].numpy(), tree_leaves(s_new), tp)
