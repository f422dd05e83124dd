"""The training reference against itself and against the layout it assumes, on the
CPU at a tiny size: its leaves are the program's, its gradients are autograd's
of its whole forward, and its round matches the program's float32 round."""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from fedbench.harness import leaf_paths, make_weights  # noqa: E402
from fedbench.reference import decoder  # noqa: E402
from fedbench.reference import train as tref  # noqa: E402


def _tiny(name: str) -> dict:
    """A configuration file's keys for a two-layer float32 cut of ``name``."""
    from repro_torch.configs.registry import get_config

    c = get_config(name).reduced(num_layers=2, d_model=32, d_ff=48, vocab_size=96)
    return {"registry_name": name, "hidden_size": c.d_model, "intermediate_size": c.d_ff,
            "num_attention_heads": c.num_heads, "num_key_value_heads": c.num_kv_heads,
            "head_dim": c.resolved_head_dim, "num_hidden_layers": c.num_layers,
            "vocab_size": c.vocab_size, "hidden_act": {"swiglu": "silu"}.get(c.activation,
                                                                              c.activation),
            "norm": c.norm, "tie_word_embeddings": c.tie_embeddings,
            "rope_theta": c.rope_theta, "_config": c}


def _program(cfg: dict):
    from repro_torch.models.api import Arch

    return Arch(dataclasses.replace(cfg["_config"], dtype="float32"))


@pytest.mark.parametrize("name", ["smollm-360m", "minitron-8b"])
def test_leaves_are_the_programs(name):
    from repro_torch.configs.registry import get_arch

    cfg = _tiny(name)
    got = [(p, tuple(t.shape)) for p, t in leaf_paths(_program(cfg).param_shapes())]
    assert got == decoder.protocol_leaves(cfg)
    full = {k: v for k, v in cfg.items() if k != "_config"}
    pc = get_arch(name).cfg
    full.update(hidden_size=pc.d_model, intermediate_size=pc.d_ff,
                num_attention_heads=pc.num_heads, num_key_value_heads=pc.num_kv_heads,
                head_dim=pc.resolved_head_dim, num_hidden_layers=pc.num_layers,
                vocab_size=pc.vocab_size)
    assert [(p, tuple(t.shape)) for p, t in leaf_paths(get_arch(name).param_shapes())] == \
        decoder.protocol_leaves(full)


def _tree(cfg, seed=3):
    like = _program(cfg).param_shapes()
    params = make_weights(like, seed, torch.device("cpu"))
    # unit norm scales and zero biases do not test the norms' gradients
    g = torch.Generator().manual_seed(seed)
    for path, leaf in leaf_paths(params):
        if "norm" in path:
            leaf.add_(0.1 * torch.randn(leaf.shape, generator=g))
    return params, dict(leaf_paths(params))


@pytest.mark.parametrize("name", ["smollm-360m", "minitron-8b"])
def test_layerwise_gradients_are_autograds(name):
    cfg = _tiny(name)
    m = decoder.dims(cfg)
    params, tree = _tree(cfg)
    tokens = torch.randint(0, m["vocab"], (24,), generator=torch.Generator().manual_seed(1))
    labels = torch.roll(tokens, -1)
    got = {}

    def take(path, layer, g):
        got.setdefault(path, {})[layer] = g

    lval = decoder.grads(decoder.Weights(tree, m), tokens, labels, take)
    # the program's own float32 loss of the same tree, and autograd of it
    arch = _program(cfg)
    leaves = [leaf.requires_grad_(True) for _, leaf in leaf_paths(params)]
    want = arch.loss(params, {"tokens": tokens[None], "labels": labels[None]})
    gs = torch.autograd.grad(want, leaves)
    assert lval == pytest.approx(float(want.detach()), rel=1e-6)
    for (path, _), g in zip(leaf_paths(params), gs):
        mine = got[path]
        mine = mine[None] if None in mine else torch.stack([mine[i] for i in sorted(mine)])
        torch.testing.assert_close(mine, g, rtol=1e-4, atol=1e-6)


def test_round_seeds_are_the_protocols():
    from repro_torch.core.fedscalar import round_seeds

    for k in (0, 7, 2 ** 31 + 5):
        assert tref.round_seeds(k, 3) == round_seeds(k, 3).tolist()


def test_a_round_matches_the_programs_float32_round():
    from repro_torch.launch.train import FLRunConfig, make_train_step

    cfg = _tiny("minitron-8b")
    m = decoder.dims(cfg)
    params, tree = _tree(cfg)
    tags = {p: t for t, (p, _) in enumerate(leaf_paths(params))}
    g = torch.Generator().manual_seed(2)
    ids = torch.randint(0, m["vocab"], (2, 17), generator=g)
    batch = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
    fl = FLRunConfig(num_virtual_clients=2, local_steps=1, local_lr=0.5)
    new, met = make_train_step(_program(cfg), fl)(params, batch, 11)
    seeds = tref.round_seeds(11, 2)
    rs, losses = [], []
    for n in range(2):
        lv, r = tref.client_round(tree, tags, m, batch["tokens"][n], batch["labels"][n],
                                  0.5, seeds[n])
        rs.append(r)
        losses.append(lv)
    assert sum(losses) / 2 == pytest.approx(float(met["loss"]), rel=1e-5)
    torch.testing.assert_close(torch.tensor(rs, dtype=torch.float32), met["r"][:, 0],
                               rtol=1e-3, atol=1e-6)
    # the close from the program's own scalars: the same arithmetic to the bit
    mine = tref.close(tree, tags, met["r"][:, 0].tolist(), seeds, 1.0)
    for path, leaf in leaf_paths(new):
        torch.testing.assert_close(mine[path], leaf, rtol=0, atol=0)
